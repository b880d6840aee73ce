"""Long-running serving driver: streaming BS admission under diurnal load.

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet 512 --epochs 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The port's counterpart of ``repro/launch/serve.py``: the driver runs an
**unbounded** request stream through
:func:`repro_torch.core.engines.simulate_stream` — constant memory in the
stream length, one carried kernel launch a chunk on the card — with a
sinusoidal diurnal arrival rate λ(t)
(:class:`~repro_torch.core.workload.DiurnalSource`) and epoch-wise
capacity scaling:

* each *epoch* simulates ``--epoch-jobs`` requests per replication as a
  sequence of ``--chunk-jobs``-sized chunk scans resumed from the
  previous chunk's carry;
* between epochs a capacity controller reads the diurnal rate forecast
  for the next epoch window and resizes the fleet to hold the target
  load, rebuilding the eq.-(2) mesh partition via
  :meth:`repro_torch.sched.cluster.BalancedMeshPartition.build` and
  remapping the scheduler view through
  :func:`repro_torch.sched.elastic.elastic_repartition` (the
  killed/requeued counts of its :class:`RescaleReport` are printed);
* the λ(t) source state (thinning clock + per-replication last-arrival
  time) carries across epochs, so the stream is one continuous diurnal
  sample path — only the *queueing carry* resets at a rescale.  That
  reset is the paper's non-preemption trade made visible: a capacity
  change cannot migrate in-flight multi-chip gangs (eq. (2) is a pure
  function of (k, demand); ``elastic_repartition`` kills gangs on
  removed chips and requeues gangs whose slot vanished), so the
  simulated fleet drains and restarts empty at the new k instead of
  checkpoint-preempting gangs across the boundary.

Each epoch line prints the measured queueing statistics next to the
Cor.-1 Erlang bound for the epoch's partition.  ``--execute N`` pushes N
requests end-to-end through the model stack (prefill + greedy decode)
via :class:`repro_torch.serve.engine.ServingEngine`: on the CPU the
``reduced()`` configs, as the reference; on the card every class at full
width, deepseek-v3 as its cut to the first 4 layers
(``serve.cuts.mla_cut(cfg, moe_layers=1)``), since the engine keeps each
class's weights once drawn and starcoder2-7b, yi-9b and that cut (68 GB
in bf16) are what one 80 GB card holds together.  A ``llamav-32k`` draw
fails with ``KeyError`` on both devices, as on the reference (the engine
prefills tokens only, and the vlm needs image embeddings).

Departures from the reference's command line: ``--engine`` takes
``torch`` only (the port's one streaming engine), and ``--device``
(default ``cuda``; without a card that raises) picks where the stream
kernels and the models run.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from ..configs import get_config
from ..core import engines
from ..core.partition import balanced_partition
from ..core.theory import analyze
from ..core.workload import DiurnalSource, Exp, JobClass, Workload
from ..sched.cluster import BalancedMeshPartition
from ..sched.elastic import elastic_repartition
from ..sched.gang import GangScheduler
from ..serve.cuts import mla_cut
from ..serve.engine import Request, RequestClass, ServingEngine


def default_classes(fleet: int, device) -> list[RequestClass]:
    """The driver's four request classes for an engine on ``device`` (no
    default: the classes differ by device).  On a card ``deepseek-32k``
    serves :func:`~repro_torch.serve.cuts.mla_cut` with one MoE layer;
    its chip need, service time and mix stay the reference's."""
    mk = lambda name, arch, bucket, chips, mean, alpha: RequestClass(  # noqa
        name=name, cfg=get_config(arch), bucket=bucket, chips=chips,
        mean_service_s=mean, alpha=alpha)
    classes = [
        mk("yi9b-8k", "yi_9b", 8192, 2, 1.0, 0.55),
        mk("starcoder-8k", "starcoder2_7b", 8192, 2, 1.5, 0.25),
        mk("llamav-32k", "llama_3_2_vision_90b", 32768, 16, 8.0, 0.12),
        mk("deepseek-32k", "deepseek_v3_671b", 32768, 64, 20.0, 0.08),
    ]
    if torch.device(device).type != "cpu":
        classes[3] = dataclasses.replace(
            classes[3], cfg=mla_cut(classes[3].cfg, moe_layers=1))
    return classes


def as_job_classes(classes) -> tuple[JobClass, ...]:
    return tuple(JobClass(c.name, c.chips, Exp(c.mean_service_s), c.alpha)
                 for c in classes)


class _ResumedSource:
    """Re-enter a chunk source mid-stream.

    ``simulate_stream`` owns one complete stream; the epoch driver needs
    the λ(t) state to *survive* the stream so epoch N+1 continues the
    diurnal sample path where epoch N stopped.  This wrapper seeds
    ``init_state`` from the saved state and records the newest state as
    chunks are fetched.
    """

    def __init__(self, inner, state=None):
        self._inner = inner
        self._state = state
        self.last_state = state

    @property
    def reps(self):
        return self._inner.reps

    @property
    def k(self):
        return self._inner.k

    @property
    def C(self):
        return self._inner.C

    @property
    def total_jobs(self):
        return self._inner.total_jobs

    def init_state(self):
        if self._state is None:
            return self._inner.init_state()
        return self._state

    def next_chunk(self, state, n):
        batch, state = self._inner.next_chunk(state, n)
        self.last_state = state
        return batch, state


def fit_fleet(lam_peak: float, classes, target_load: float,
              k_min: int = 1) -> int:
    """Smallest k holding ``target_load`` at ``lam_peak`` with a valid
    eq.-(2) partition (helper block >= the largest gang need)."""
    jc = as_job_classes(classes)
    demand = sum(c.alpha * c.d * c.n for c in jc)
    max_need = max(c.n for c in jc)
    k = max(k_min, max_need, math.ceil(lam_peak * demand / target_load))
    while balanced_partition(
            Workload(k=k, lam=lam_peak, classes=jc)).helpers < max_need:
        k += max_need
    return k


def run_epochs(classes, *, fleet: int, epochs: int, epoch_jobs: int,
               chunk_jobs: int, reps: int, load: float, period: float,
               amplitude: float, policy: str, engine: str = "torch",
               seed: int, device="cuda", out=print):
    """The epoch loop; returns the per-epoch (k, StreamResult) history.
    ``device`` is where ``simulate_stream`` runs (the carried kernels on
    the card, their plain versions on the CPU)."""
    jc = as_job_classes(classes)
    demand = sum(c.alpha * c.d * c.n for c in jc)
    lam0 = load * fleet / demand      # base rate: --load at the initial k
    k = fleet
    mesh = BalancedMeshPartition.build(k, jc)
    sched = GangScheduler(mesh)
    out(mesh.summary())
    state = None
    history = []
    for epoch in range(epochs):
        wl = Workload(k=k, lam=lam0, classes=jc)
        part = balanced_partition(wl)
        inner = DiurnalSource(wl, reps=reps, seed=seed, period=period,
                              amplitude=amplitude)
        src = _ResumedSource(inner, state)
        t0 = 0.0 if state is None else float(np.max(state["t_last"]))
        res = engines.simulate_stream(policy, src, engine=engine,
                                      device=device, chunk_jobs=chunk_jobs,
                                      total_jobs=epoch_jobs, wl=wl)
        state = src.last_state
        t1 = float(np.max(state["t_last"]))
        lam_now = float(inner.rate(np.asarray(t1)))
        bound = analyze(wl, part).p_helper_modified
        p_h = float(res.p_helper.mean()) if res.p_helper is not None \
            else float("nan")
        out(f"epoch {epoch}  t=[{t0:8.1f},{t1:8.1f})  k={k:<5d} "
            f"rho(t1)={lam_now * demand / k:4.2f}  "
            f"P[wait]={float(res.p_wait.mean()):.3f}  "
            f"mean_wait={float(res.mean_wait.mean()):.3f}s  "
            f"P_H={p_h:.4f} (Erlang bound {bound:.4f})")
        history.append((k, res))
        if epoch == epochs - 1:
            break
        # forecast the next epoch window (duration ~ epoch_jobs at the
        # base rate) and size the fleet for its peak rate
        grid = t1 + np.linspace(0.0, epoch_jobs / lam0, 64)
        new_k = fit_fleet(float(inner.rate(grid).max()), classes, load)
        if new_k != k:
            sched, report = elastic_repartition(sched, new_k, jc)
            out(f"rescale: k {k} -> {new_k}  "
                f"(killed={len(report.killed_jobs)} "
                f"requeued={len(report.requeued_jobs)}; queueing carry "
                f"resets — in-flight gangs are not migrated)")
            k = new_k
    return history


def execute(eng: ServingEngine, n: int, seed: int, out=print
            ) -> list[Request]:
    """``--execute``: ``n`` requests drawn by the class mix (16-token
    prompts), each submitted and run through prefill and greedy decode at
    once, in the reference's order of draws; returns the requests.  A
    ``llamav-32k`` draw raises ``KeyError`` (the engine prefills tokens
    only) before its weights are made."""
    classes = eng.classes
    rng = np.random.default_rng(seed)
    names = [c.name for c in classes]
    probs = np.array([c.alpha for c in classes])
    done = []
    for rid in range(n):
        i = rng.choice(len(classes), p=probs)
        eng.submit(Request(rid=rid, cls_name=names[i],
                           prompt=rng.integers(0, 100, size=16),
                           arrival=float(rid)), float(rid))
        req = eng.run_request(max(eng._jobs))
        done.append(req)
        out(f"  executed request {req.rid}: {len(req.output)} tokens")
    if eng.device.type == "cpu":
        what = "reduced configs"
    else:
        ran = dict.fromkeys(eng._model(r.cls_name).cfg.name for r in done)
        what = f"full width on {eng.device.type}: {', '.join(ran)}"
    out(f"executed {len(done)} requests end-to-end ({what})")
    return done


def main(argv=None):
    """The command line; returns the epoch history and the engine that
    ran ``--execute`` (None without it)."""
    ap = argparse.ArgumentParser(
        description="Streaming serving driver: diurnal lambda(t), "
                    "constant-memory simulate_stream epochs, eq.-(2) "
                    "capacity scaling between epochs.")
    ap.add_argument("--fleet", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--epoch-jobs", type=int, default=6_000,
                    help="requests simulated per replication per epoch")
    ap.add_argument("--chunk-jobs", type=int, default=2_000,
                    help="jobs per chunk scan (the memory knob)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--load", type=float, default=0.8,
                    help="target load; the controller resizes the fleet "
                         "to hold it at the forecast diurnal peak")
    ap.add_argument("--period", type=float, default=3600.0,
                    help="diurnal period of lambda(t), seconds")
    ap.add_argument("--amplitude", type=float, default=0.5)
    ap.add_argument("--policy", default="bs-fcfs",
                    choices=("fcfs", "modbs-fcfs", "bs-fcfs"))
    ap.add_argument("--engine", default="torch", choices=("torch",))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the stream kernels and the models run "
                         "(cpu: their plain versions, reduced configs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--execute", type=int, default=0,
                    help="additionally run N requests through "
                         "prefill/decode (reduced configs on CPU)")
    args = ap.parse_args(argv)
    device = engines.resolve_device(args.device)

    classes = default_classes(args.fleet, device)
    history = run_epochs(
        classes, fleet=args.fleet, epochs=args.epochs,
        epoch_jobs=args.epoch_jobs, chunk_jobs=args.chunk_jobs,
        reps=args.reps, load=args.load, period=args.period,
        amplitude=args.amplitude, policy=args.policy, engine=args.engine,
        seed=args.seed, device=device)

    eng = None
    if args.execute:
        eng = ServingEngine(classes, args.fleet, seed=args.seed,
                            device=device)
        execute(eng, args.execute, args.seed)
    return history, eng


if __name__ == "__main__":
    main()
