"""Figure 2 on the port — (a) heavy traffic: k fixed, load -> 1; (b) the
subcritical sweep.

Same job classes and server needs as Figure 1 (k = 512, f_k = 6).  Rows
equal the reference script's (``benchmarks/fig2_regimes.py``) on every
column but ``sim_s``.

* ``--engine torch`` (default): both sweeps batched
  (:func:`run_heavy_scan`, :func:`run_subcritical_scan`; FCFS,
  ModifiedBS-FCFS and BS-FCFS on their kernels, ``--reps`` replications,
  mean/CI columns), one grid launch per policy and sweep; ``--device
  cpu`` runs the plain versions.  The reference's ``run_*_jax``.
* ``--engine python``: the event engine over the paper's full policy set
  (:func:`run_heavy`, :func:`run_subcritical`).

::

    PYTHONPATH=src python -m repro_torch.bench.fig2_regimes           # card
    PYTHONPATH=src python -m repro_torch.bench.fig2_regimes --device cpu \\
        --jobs 2000 --reps 2

``--ckpt-dir D`` checkpoints each cell under ``D/heavy`` and
``D/subcritical`` (a cell's id is local to its sweep) and ``--resume``
reloads them.  The reference's ``--devices`` and ``--cache-dir`` have no
counterpart.
"""

from __future__ import annotations

import argparse
import os

from ..core.workload import (figure1_base_classes, figure2_workload,
                             subcritical_scaling)
from .common import (ENGINE_HELP, ENGINES, PAPER_POLICIES, SWEEP_POLICIES,
                     emit, run_policies, run_policies_scan)

COLS = ["regime", "k", "load", "policy", "mean_response", "ci95_response",
        "reps", "mean_wait", "p_wait", "ci95_p_wait", "p_helper",
        "p95_response", "utilization", "sim_s"]


def _subcritical_factory(load=0.85):
    base = figure1_base_classes()
    lam = load / sum(c.alpha * c.d * c.n for c in base)
    return lambda k: subcritical_scaling(base, lam, k)


def run_heavy(k=512, loads=(0.5, 0.7, 0.8, 0.9, 0.95), num_jobs=20_000,
              seed=0, policies=PAPER_POLICIES):
    """Heavy traffic on the event engine: k fixed, one trace per load."""
    rows = []
    for load in loads:
        wl = figure2_workload(k, load)
        rows += run_policies(wl, num_jobs, seed, policies,
                             extra_cols={"regime": "heavy", "k": k,
                                         "load": load})
    return rows


def run_subcritical(load=0.85, ks=(256, 512, 1024, 2048), num_jobs=20_000,
                    seed=0, policies=PAPER_POLICIES):
    """The subcritical k sweep (eq. 7) on the event engine."""
    factory = _subcritical_factory(load)
    rows = []
    for k in ks:
        wl = factory(k)
        rows += run_policies(wl, num_jobs, seed, policies,
                             extra_cols={"regime": "subcritical", "k": k,
                                         "load": round(wl.load, 4)})
    return rows


def run_heavy_scan(k=512, loads=(0.5, 0.7, 0.8, 0.9, 0.95),
                   num_jobs=100_000, reps=8, seed=0, policies=SWEEP_POLICIES,
                   engine="torch", device="cuda", grid=True, ckpt_dir=None,
                   resume=False):
    """Heavy traffic, batched: one grid launch per policy over the loads
    (on the card unless ``device="cpu"``)."""
    return run_policies_scan(
        lambda load: figure2_workload(k, load), loads, "load",
        num_jobs=num_jobs, reps=reps, seed=seed, policies=policies,
        engine=engine, device=device, grid=grid,
        extra_cols={"regime": "heavy", "k": k},
        ckpt_dir=ckpt_dir, resume=resume)


def run_subcritical_scan(load=0.85, ks=(256, 512, 1024, 2048),
                         num_jobs=100_000, reps=8, seed=0,
                         policies=SWEEP_POLICIES, engine="torch",
                         device="cuda", grid=True, ckpt_dir=None,
                         resume=False):
    """The subcritical k sweep, batched: one grid launch per policy over
    the ks (on the card unless ``device="cpu"``)."""
    factory = _subcritical_factory(load)
    return run_policies_scan(
        factory, ks, "k", num_jobs=num_jobs, reps=reps, seed=seed,
        policies=policies, engine=engine, device=device, grid=grid,
        extra_cols={"regime": "subcritical"},
        per_point_cols=[{"load": round(factory(k).load, 4)} for k in ks],
        ckpt_dir=ckpt_dir, resume=resume)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=ENGINES, default="torch",
                    help=ENGINE_HELP)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--policies", nargs="+", default=None,
                    help="subset of the engine's policy set")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--no-grid", action="store_true",
                    help="run each sweep cell separately instead of one "
                         "grid launch per policy")
    ap.add_argument("--ckpt-dir", default=None,
                    help="write each sweep cell atomically under "
                         "<dir>/{heavy,subcritical} (crash-resumable; "
                         "--engine torch only)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already checkpointed in --ckpt-dir")
    args = ap.parse_args(argv)
    if args.engine == "python" and (args.ckpt_dir or args.resume):
        ap.error("--ckpt-dir/--resume need --engine torch")
    default = 20_000 if args.engine == "python" else 100_000
    jobs = args.jobs if args.jobs is not None \
        else (1_000_000 if args.full else default)
    if args.engine != "python":
        # one checkpoint namespace per sweep: cell ids are sweep-local
        sub = {r: os.path.join(args.ckpt_dir, r) if args.ckpt_dir else None
               for r in ("heavy", "subcritical")}
        kw = dict(num_jobs=jobs, reps=args.reps,
                  policies=tuple(args.policies or SWEEP_POLICIES),
                  engine=args.engine, device=args.device,
                  grid=not args.no_grid, resume=args.resume)
        rows = (run_heavy_scan(ckpt_dir=sub["heavy"], **kw)
                + run_subcritical_scan(ckpt_dir=sub["subcritical"], **kw))
    else:
        pols = tuple(args.policies or PAPER_POLICIES)
        rows = (run_heavy(num_jobs=jobs, policies=pols)
                + run_subcritical(num_jobs=jobs, policies=pols))
    emit(rows, COLS)


if __name__ == "__main__":
    main()
