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

``--swf LOG`` runs a real Standard Workload Format log instead
(:func:`run_swf`; ``--k`` servers, ``--load`` for the partition fit,
moving-block bootstrap unless ``--bootstrap iid``)::

    PYTHONPATH=src python -m repro_torch.bench.fig3_traces --swf LOG --k 128

The policy sets, the row builders and the CSV writer are shared with the
Fig. 1/2 scripts (:mod:`repro_torch.bench.common`).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..checkpoint import completed_steps, restore_checkpoint, save_checkpoint
from ..core import engines
from ..core.workload import BatchTrace, kit_fh2_workload, sdsc_sp2_workload
from ..data.swf import (kit_fh2_trace, parse_swf, sdsc_sp2_trace,
                        trace_to_workload)
from .common import (PAPER_POLICIES, emit, grid_precompute,
                     run_policies_batch)

COLS = ["dataset", "k", "load", "engine", "policy", "jobs", "reps",
        "mean_response", "ci95_response", "mean_wait", "p_wait", "p_helper",
        "p95_response", "utilization", "sim_s"]

#: the policies with a scan core (``engine="torch"``, a kernel on the card)
SCAN_POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs", "sf-srpt", "ff-srpt")

_DATASETS = (("sdsc_sp2", sdsc_sp2_trace, sdsc_sp2_workload),
             ("kit_fh2", kit_fh2_trace, kit_fh2_workload))


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


def run_swf(path: str, k: int = 512, load: float = 0.85,
            jobs: int | None = None, seed=0, policies=PAPER_POLICIES,
            engine: str = "torch", reps=4, bootstrap="block",
            device="cuda") -> list[dict]:
    """A real SWF log on the bootstrap substrate (the reference's
    ``run_swf``): one row per policy, ``dataset`` "swf".

    The log's own arrival / service / need columns (``parse_swf``, at
    most ``jobs`` rows) are bootstrap-resampled into ``reps``
    replications (moving-block by default: real logs are bursty);
    ``load`` only feeds the eq.-2 partition fit of
    :func:`trace_to_workload`.  ``engine`` and ``device`` as in
    :func:`run`.
    """
    dev = (engines.resolve_device(device)
           if engine in engines.DEVICE_ENGINES else None)
    trace = parse_swf(path, k=k, limit=jobs)
    wl = trace_to_workload(trace, k, load)
    batch = BatchTrace.from_trace(trace, reps, seed=seed, method=bootstrap)
    return run_policies_batch(
        batch, wl, policies, engine=engine, device=dev,
        extra_cols={"dataset": "swf", "k": k, "load": load})


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
    ap.add_argument("--bootstrap", choices=("iid", "block"), default=None,
                    help="job-record resampling: iid or moving-block "
                         "(default: iid for the synthesized tables, block "
                         "for --swf logs: real arrivals are bursty)")
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
    ap.add_argument("--swf", default=None,
                    help="a real SWF log to run instead of the tables")
    ap.add_argument("--k", type=int, default=512,
                    help="server count for the --swf path")
    ap.add_argument("--load", type=float, default=0.85,
                    help="partition-fit load for the --swf path")
    args = ap.parse_args(argv)
    if args.swf and (args.ckpt_dir or args.resume):
        ap.error("--ckpt-dir/--resume apply to the synthesized-table sweep")
    t0 = time.time()
    if args.swf:
        rows = run_swf(args.swf, k=args.k, load=args.load, jobs=args.jobs,
                       seed=args.seed, policies=tuple(args.policies),
                       engine=args.engine, reps=args.reps,
                       bootstrap=args.bootstrap or "block",
                       device=args.device)
    else:
        rows = run(num_jobs=args.jobs, seed=args.seed, ks=tuple(args.ks),
                   loads=tuple(args.loads), policies=tuple(args.policies),
                   engine=args.engine, reps=args.reps,
                   bootstrap=args.bootstrap or "iid", device=args.device,
                   grid=args.grid, ckpt_dir=args.ckpt_dir,
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
