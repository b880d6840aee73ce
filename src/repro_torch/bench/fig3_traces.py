"""Figure 3 on the port — SDSC-SP2 / KIT-FH2 HPC workloads, k in {512, 1024}.

Traces are synthesized from the paper's Table-2/3 parameters (lognormal
service fit; the raw archive logs are not redistributable), bootstrapped
into ``reps`` replications per cell (``BatchTrace.from_trace``, IID or
moving-block) and run through the port's registry on the five scan
policies: FCFS, ModBS-π, BS-π and the preemptive SF-SRPT / FF-SRPT.  Rows
equal the reference script's (``benchmarks/fig3_traces.py``) on every
column but ``engine`` and ``sim_s``.  Runs on the card unless
``device="cpu"``::

    PYTHONPATH=src python -m repro_torch.bench.fig3_traces            # card
    PYTHONPATH=src python -m repro_torch.bench.fig3_traces --device cpu \\
        --jobs 400 --reps 2 --ks 64 --loads 0.7

Every (dataset, k, load) cell is sampled first; then each policy runs all
cells through one ``engines.simulate_grid`` call (one kernel launch on the
card), as the reference script's grid pre-pass does, and ``sim_s`` is that
call's wall time spread evenly over its cells.  ``--no-grid`` runs one
``engines.simulate`` per cell and policy instead; the rows are equal
either way but for ``sim_s``.  ``serverfilling`` and ``msf`` run only on
the reference's Python event engine, which is not ported: asking for them
raises ``KeyError``.  ``--ckpt-dir D`` checkpoints each finished cell and
``--resume`` reloads them, as the reference script's flags do.
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

#: the scan policies the port runs
SCAN_POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs", "sf-srpt", "ff-srpt")

_DATASETS = (("sdsc_sp2", sdsc_sp2_trace, sdsc_sp2_workload),
             ("kit_fh2", kit_fh2_trace, kit_fh2_workload))

def _check_policies(policies) -> tuple[str, ...]:
    pols = tuple(engines.canonical(p) for p in policies)
    ported = engines.policies_for("torch")
    missing = [p for p in pols if p not in ported]
    if missing:
        raise KeyError(
            f"{missing} run only on the reference's Python event engine "
            f"(core/simulator.py, core/policies/), which is not ported "
            f"(ROADMAP Queue 1 item 15); the port runs {list(ported)}")
    return pols


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


def grid_precompute(cells, policies, *, device) -> dict:
    """One ``engines.simulate_grid`` call per policy over ``cells``, a
    sequence of ``(batch, wl)`` pairs of one ``reps``.

    Returns ``{policy: (results, wall per cell)}``, the wall time of the
    call spread evenly over its cells.  A grid that raises
    ``RuntimeError`` (an overflowing cell fails the whole grid) is left
    out, so its cells run one by one and the overflowing one gives the
    reference's row of infinite response times — the reference's
    ``grid_precompute``.
    """
    gcells = [engines.GridCell(batch, wl=wl) for batch, wl in cells]
    out = {}
    for pol in policies:
        t0 = time.time()
        try:
            results = engines.simulate_grid(pol, gcells, device=device)
        except RuntimeError:
            continue
        out[pol] = (results, (time.time() - t0) / len(gcells))
    return out


def run_policies_batch(batch: BatchTrace, wl, policies, *, device,
                       extra_cols=None, precomputed=None,
                       cell: int = 0) -> list[dict]:
    """One row per policy on a shared batch, through ``engines.simulate``.

    A policy whose bounded queue overflows on this batch (unstable at this
    load) gives the reference's row of infinite response times with the
    error in ``note``.  ``precomputed`` (from :func:`grid_precompute`)
    gives a policy it holds its grid's result for ``cell`` instead, with
    the same row assembly.
    """
    rows = []
    for pol in policies:
        pre = (precomputed or {}).get(pol)
        if pre is not None:
            row = _batch_row(pol, batch, pre[0][cell])
            row["engine"] = "torch"
            row["sim_s"] = round(pre[1], 2)
            if extra_cols:
                row.update(extra_cols)
            rows.append(row)
            continue
        t0 = time.time()
        try:
            res = engines.simulate(pol, batch, device=device, wl=wl)
            row = _batch_row(pol, batch, res)
        except QueueOverflowError as e:
            row = {"policy": pol, "jobs": batch.num_jobs,
                   "reps": batch.reps,
                   "mean_response": float("inf"), "mean_wait": float("inf"),
                   "p_wait": 1.0, "p_helper": None,
                   "p95_response": float("inf"), "utilization": 0.0,
                   "note": str(e)[:60]}
        row["engine"] = "torch"
        row["sim_s"] = round(time.time() - t0, 2)
        if extra_cols:
            row.update(extra_cols)
        rows.append(row)
    return rows


def run(num_jobs=15_000, seed=0, ks=(512, 1024), loads=(0.5, 0.7, 0.85),
        policies=SCAN_POLICIES, reps=4, bootstrap="iid",
        device="cuda", grid: bool = True, ckpt_dir=None,
        resume: bool = False) -> list[dict]:
    """Table-2/3 synthesized traces, bootstrapped, through the registry.

    One row per (dataset, k, load, policy), in the reference script's
    order.  ``device="cuda"`` (the default) runs the kernels and raises
    without a card; ``device="cpu"`` runs their plain versions.
    ``grid=True`` runs each policy over every cell not yet checkpointed in
    one :func:`grid_precompute` call, ``grid=False`` cell by cell.

    With ``ckpt_dir`` each (dataset, k, load) cell's finished rows are
    published atomically (:mod:`repro_torch.checkpoint`; the rows ride in
    the manifest's JSON) and ``resume=True`` reloads completed cells
    instead of simulating them: a killed run resumes with the same CSV,
    ``sim_s`` of the restored cells included.
    """
    pols = _check_policies(policies)
    dev = engines.resolve_device(device)
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
    pre = (grid_precompute([sampled[c] for c in todo], pols, device=dev)
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
            batch, wl, pols, device=dev, precomputed=pre,
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
    ap.add_argument("--policies", nargs="+", default=list(SCAN_POLICIES))
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
    rows = run(num_jobs=args.jobs, seed=args.seed, ks=tuple(args.ks),
               loads=tuple(args.loads), policies=tuple(args.policies),
               reps=args.reps, bootstrap=args.bootstrap, device=args.device,
               grid=args.grid, ckpt_dir=args.ckpt_dir, resume=args.resume)
    emit(rows, COLS)


if __name__ == "__main__":
    main()
