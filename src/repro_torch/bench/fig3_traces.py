"""Figure 3 on the port — SDSC-SP2 / KIT-FH2 HPC workloads, k in {512, 1024}.

Traces are synthesized from the paper's Table-2/3 parameters (lognormal
service fit; the raw archive logs are not redistributable), bootstrapped
into ``reps`` replications per cell (``BatchTrace.from_trace``, IID or
moving-block) and run through the port's registry on the paper's policy
set, ``PAPER_POLICIES``: BS-π, FCFS, ServerFilling, SF-SRPT, FF-SRPT and
MSF.  With ``engine="torch"`` (the default) the four scan policies run on
their kernels (the plain versions with ``device="cpu"``), and
``serverfilling`` / ``msf``, which have no scan core, on the event engine
(``engine="python"``), each announced once by a ``RuntimeWarning``; the
row's ``engine`` column records the core that ran.  ``engine="python"``
runs every policy on the event engine over the same bootstrap batches.
Rows equal the reference script's (``benchmarks/fig3_traces.py``) on
every column but ``sim_s`` (its ``jax`` is the port's ``torch``).  Runs on
the card unless ``device="cpu"``::

    PYTHONPATH=src python -m repro_torch.bench.fig3_traces            # card
    PYTHONPATH=src python -m repro_torch.bench.fig3_traces --device cpu \\
        --jobs 400 --reps 2 --ks 128 --loads 0.7

Every (dataset, k, load) cell is sampled first; then each scan policy
runs all cells through one ``engines.simulate_grid`` call (one kernel
launch on the card), as the reference script's grid pre-pass does, and
``sim_s`` is that call's wall time spread evenly over its cells; an
event-engine policy runs cell by cell.  ``--no-grid`` runs one
``engines.simulate`` per cell and policy instead; the rows are equal
either way but for ``sim_s``.  ``--ckpt-dir D`` checkpoints each finished
cell and ``--resume`` reloads them, as the reference script's flags do.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..checkpoint import completed_steps, restore_checkpoint, save_checkpoint
from ..core import engines
from ..core.sim_batch import QueueOverflowError, _ci95
from ..core.workload import BatchTrace, kit_fh2_workload, sdsc_sp2_workload
from ..data.swf import kit_fh2_trace, sdsc_sp2_trace

COLS = ["dataset", "k", "load", "engine", "policy", "jobs", "reps",
        "mean_response", "ci95_response", "mean_wait", "p_wait", "p_helper",
        "p95_response", "utilization", "sim_s"]

#: the policy set the paper benchmarks against (Figures 1-3); the
#: reference's ``benchmarks/common.py`` ``PAPER_POLICIES``
PAPER_POLICIES = ("bs", "fcfs", "serverfilling", "sf-srpt", "ff-srpt", "msf")

#: the policies with a scan core (``engine="torch"``, a kernel on the card)
SCAN_POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs", "sf-srpt", "ff-srpt")

_DATASETS = (("sdsc_sp2", sdsc_sp2_trace, sdsc_sp2_workload),
             ("kit_fh2", kit_fh2_trace, kit_fh2_workload))


def _batch_row(policy: str, batch: BatchTrace, res) -> dict:
    """CSV row of a BatchSimResult — the reference script's float ops."""
    busy = (batch.need * batch.service).sum(axis=1)     # [R]
    completion = batch.arrival + res.response
    horizon = completion.max(axis=1)                    # [R]
    ph = res.p_helper
    return {
        "policy": policy, "jobs": batch.num_jobs, "reps": batch.reps,
        "mean_response": res.mean_response.mean(),
        "ci95_response": _ci95(res.mean_response),
        "mean_wait": res.mean_wait.mean(),
        "p_wait": res.p_wait.mean(),
        "ci95_p_wait": _ci95(res.p_wait),
        "p_helper": None if ph is None else ph.mean(),
        "p95_response": np.percentile(res.response, 95, axis=1).mean(),
        "utilization": (busy / (batch.k * horizon)).mean(),
    }


def grid_precompute(cells, policies, *, engine: str = "torch",
                    device) -> dict:
    """One ``engines.simulate_grid`` call per scan policy over ``cells``,
    a sequence of ``(batch, wl)`` pairs of one ``reps``.

    Returns ``{policy: (results, wall per cell)}`` for every canonical
    policy with a ``(policy, engine)`` grid core, the wall time of the
    call spread evenly over its cells.  Policies without one (the event
    engine's) are absent and run cell by cell.  A grid that raises
    ``RuntimeError`` (an overflowing cell fails the whole grid) is left
    out too, so its cells run one by one and the overflowing one gives
    the reference's row of infinite response times — the reference's
    ``grid_precompute``.
    """
    gcells = [engines.GridCell(batch, wl=wl) for batch, wl in cells]
    out = {}
    for pol in dict.fromkeys(engines.canonical(p) for p in policies):
        if (pol, engine) not in engines.grid_registered():
            continue
        t0 = time.time()
        try:
            results = engines.simulate_grid(pol, gcells, engine=engine,
                                            device=device)
        except RuntimeError:
            continue
        out[pol] = (results, (time.time() - t0) / len(gcells))
    return out


def run_policies_batch(batch: BatchTrace, wl, policies, *,
                       engine: str = "torch", device, extra_cols=None,
                       precomputed=None, cell: int = 0) -> list[dict]:
    """One row per policy on a shared batch, through ``engines.simulate``.

    A policy with no core under ``engine`` (``serverfilling``, ``msf``
    under ``"torch"``) runs on ``engine="python"``, announced once per
    process by :func:`engines.warn_fallback`; the row's ``engine`` column
    records the core that ran, and a policy that has a ``"torch"`` core
    never goes to the event engine.  An unknown policy raises
    ``KeyError``.  A policy whose bounded queue overflows on this batch
    (unstable at this load), or whose event-engine run exceeds its event
    budget, gives the reference's row of infinite response times with the
    error in ``note``.  ``precomputed`` (from :func:`grid_precompute`)
    gives a policy it holds its grid's result for ``cell`` instead, with
    the same row assembly.
    """
    rows = []
    for name in policies:
        pol = engines.canonical(name)
        use = engines._resolve_fallback(pol, engine, True)
        pre = (precomputed or {}).get(pol)
        if pre is not None:
            row = _batch_row(pol, batch, pre[0][cell])
            row["engine"] = use
            row["sim_s"] = round(pre[1], 2)
            if extra_cols:
                row.update(extra_cols)
            rows.append(row)
            continue
        t0 = time.time()
        try:
            res = engines.simulate(pol, batch, engine=use, device=device,
                                   wl=wl)
            row = _batch_row(pol, batch, res)
        except RuntimeError as e:
            if use != "python" and not isinstance(e, QueueOverflowError):
                raise
            row = {"policy": pol, "jobs": batch.num_jobs,
                   "reps": batch.reps,
                   "mean_response": float("inf"), "mean_wait": float("inf"),
                   "p_wait": 1.0, "p_helper": None,
                   "p95_response": float("inf"), "utilization": 0.0,
                   "note": str(e)[:60]}
        row["engine"] = use
        row["sim_s"] = round(time.time() - t0, 2)
        if extra_cols:
            row.update(extra_cols)
        rows.append(row)
    return rows


def run(num_jobs=15_000, seed=0, ks=(512, 1024), loads=(0.5, 0.7, 0.85),
        policies=PAPER_POLICIES, engine: str = "torch", reps=4,
        bootstrap="iid", device="cuda", grid: bool = True, ckpt_dir=None,
        resume: bool = False) -> list[dict]:
    """Table-2/3 synthesized traces, bootstrapped, through the registry.

    One row per (dataset, k, load, policy), in the reference script's
    order.  ``engine="torch"`` (the default) runs each scan policy on its
    kernel and the others on the event engine (:func:`run_policies_batch`);
    ``engine="python"`` runs every policy on the event engine.
    ``device="cuda"`` (the default) runs the kernels and raises without a
    card; ``device="cpu"`` runs their plain versions; ``engine="python"``
    ignores it.  ``grid=True`` runs each scan policy over every cell not
    yet checkpointed in one :func:`grid_precompute` call, ``grid=False``
    cell by cell.

    With ``ckpt_dir`` each (dataset, k, load) cell's finished rows are
    published atomically (:mod:`repro_torch.checkpoint`; the rows ride in
    the manifest's JSON) and ``resume=True`` reloads completed cells
    instead of simulating them: a killed run resumes with the same CSV,
    ``sim_s`` of the restored cells included.
    """
    dev = (engines.resolve_device(device)
           if engine in engines.DEVICE_ENGINES else None)
    done: set[int] = set()
    if resume:
        if ckpt_dir is None:
            raise ValueError("resume=True needs a ckpt_dir")
        done = set(completed_steps(ckpt_dir))
    specs = [(name, trace_fn, wl_fn, k, load)
             for name, trace_fn, wl_fn in _DATASETS
             for k in ks for load in loads]
    sampled = {}
    for cell, (name, trace_fn, wl_fn, k, load) in enumerate(specs):
        if cell in done:
            continue
        trace = trace_fn(num_jobs, k=k, load=load, seed=seed)
        sampled[cell] = (BatchTrace.from_trace(trace, reps, seed=seed,
                                               method=bootstrap),
                         wl_fn(k=k, load=load))
    todo = sorted(sampled)
    pre = (grid_precompute([sampled[c] for c in todo], policies,
                           engine=engine, device=dev)
           if grid and todo else {})
    rows = []
    for cell, (name, _, _, k, load) in enumerate(specs):
        key = f"{name}/k={k}/load={load}"
        if cell in done:
            _, _, extra = restore_checkpoint(
                ckpt_dir, {"ok": np.zeros(1)}, step=cell)
            if extra.get("cell_key") != key:
                raise ValueError(
                    f"checkpoint cell {cell} holds "
                    f"{extra.get('cell_key')!r}, this run expects {key!r} "
                    f"— stale ckpt_dir?")
            rows += extra["rows"]
            continue
        batch, wl = sampled[cell]
        cell_rows = run_policies_batch(
            batch, wl, policies, engine=engine, device=dev, precomputed=pre,
            cell=todo.index(cell),
            extra_cols={"dataset": name, "k": k, "load": load})
        if ckpt_dir is not None:
            save_checkpoint(ckpt_dir, cell, {"ok": np.ones(1)},
                            extra={"cell_key": key, "rows": cell_rows})
        rows += cell_rows
    return rows


def emit(rows: list[dict], cols: list[str], file=None) -> None:
    """Print ``rows`` as CSV (the reference scripts' format)."""
    file = file or sys.stdout
    print(",".join(cols), file=file)
    for r in rows:
        print(",".join(_fmt(r.get(c)) for c in cols), file=file)


def _fmt(v) -> str:
    if v is None:
        return ""
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=15_000)
    ap.add_argument("--reps", type=int, default=4,
                    help="bootstrap replications per cell")
    ap.add_argument("--ks", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--loads", type=float, nargs="+",
                    default=[0.5, 0.7, 0.85])
    ap.add_argument("--policies", nargs="+", default=list(PAPER_POLICIES),
                    help="the paper's set by default; under --engine torch "
                         "bs, fcfs, sf-srpt, ff-srpt (and modbs-fcfs) run "
                         "on their kernels, serverfilling and msf (and "
                         "sf-gittins, lsf, backfill, maxweight) on the "
                         "event engine")
    ap.add_argument("--engine", choices=("torch", "python"), default="torch",
                    help="torch = the kernels where a policy has one; "
                         "python = every policy on the event engine")
    ap.add_argument("--bootstrap", choices=("iid", "block"), default="iid")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--no-grid", dest="grid", action="store_false",
                    help="one simulate call per cell and policy instead of "
                         "one grid per policy")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint each finished cell's rows here")
    ap.add_argument("--resume", action="store_true",
                    help="reload the cells checkpointed in --ckpt-dir")
    args = ap.parse_args(argv)
    t0 = time.time()
    rows = run(num_jobs=args.jobs, seed=args.seed, ks=tuple(args.ks),
               loads=tuple(args.loads), policies=tuple(args.policies),
               engine=args.engine, reps=args.reps, bootstrap=args.bootstrap,
               device=args.device, grid=args.grid, ckpt_dir=args.ckpt_dir,
               resume=args.resume)
    wall = time.time() - t0
    emit(rows, COLS)
    report_engines(rows, wall)


def report_engines(rows: list[dict], wall: float, file=None) -> None:
    """One stderr line: the run's wall time and the rows' ``sim_s``
    summed by the engine that ran them (the kernels' share and the event
    engine's)."""
    by = {}
    for r in rows:
        n, s = by.get(r["engine"], (0, 0.0))
        by[r["engine"]] = (n + 1, s + r["sim_s"])
    parts = ", ".join(f"{e} {s:.2f} s over {n} rows"
                      for e, (n, s) in sorted(by.items()))
    print(f"# wall {wall:.2f} s (sampling included); sim_s summed by "
          f"engine: {parts}", file=file or sys.stderr)


if __name__ == "__main__":
    main()
