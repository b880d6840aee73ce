"""Shared plumbing of the port's figure scripts: policy sets, row
builders over the engine registry, and the CSV writer.

The port's counterpart of the reference's ``benchmarks/common.py``.  Rows
are assembled with the reference's numpy operations in its order, so a
script's rows equal the reference script's on every column but the wall
time ``sim_s`` (and ``engine``, whose ``jax`` is the port's ``torch``).
``engine="torch"`` runs a policy's kernel on the card (its plain version
with ``device="cpu"``); ``engine="python"`` the port's event engine on the
host.  The reference's XLA runtime knobs (``configure_scan_runtime``:
host device count, compile cache) have no counterpart here.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..core import engines
from ..core.policies import make_policy
from ..core.sim_batch import QueueOverflowError, _ci95, sweep_many_server
from ..core.simulator import simulate_trace
from ..core.workload import BatchTrace, Workload

#: the policy set the paper benchmarks against (Figures 1-3)
PAPER_POLICIES = ("bs", "fcfs", "serverfilling", "sf-srpt", "ff-srpt", "msf")

#: the policies of the Fig. 1/2 sweeps (the reference's ``JAX_POLICIES``):
#: FCFS, ModifiedBS-FCFS (the Cor.-1 upper bound on BS-π's P_H) and
#: BS-FCFS proper, each on its kernel under ``engine="torch"``
SWEEP_POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs")

#: the engine choices every figure script exposes
ENGINES = ("torch", "python")
ENGINE_HELP = ("torch = the hand-written kernels on the card (their plain "
               "PyTorch versions with --device cpu); python = the exact "
               "event engine on the host, the paper's full policy set")


def run_policies_scan(wl_factory, points, point_col: str, *, num_jobs: int,
                      reps: int, seed: int = 0, policies=SWEEP_POLICIES,
                      engine: str = "torch", device="cuda", grid: bool = True,
                      extra_cols=None, per_point_cols=None, failures=None,
                      ckpt_dir: str | None = None,
                      resume: bool = False) -> list[dict]:
    """One :func:`sweep_many_server` call over ``wl_factory(point)``: CSV
    rows with mean/CI columns (the reference's ``run_policies_jax``).

    ``per_point_cols`` is an optional sequence (parallel to ``points``)
    of extra per-point column dicts.  ``grid=True`` runs each policy over
    every point in one ``engines.simulate_grid`` call (one kernel launch
    on the card), ``grid=False`` cell by cell; the rows are equal either
    way but for ``sim_s``.  ``failures`` / ``ckpt_dir`` / ``resume`` pass
    through to the sweep.
    """
    sweep = sweep_many_server(wl_factory, points, num_jobs=num_jobs,
                              reps=reps, seed=seed, policies=policies,
                              engine=engine, device=device, grid=grid,
                              failures=failures, ckpt_dir=ckpt_dir,
                              resume=resume)
    return sweep.rows(point_col, extra_cols=extra_cols,
                      per_point_cols=per_point_cols)


def run_policies(wl: Workload, num_jobs: int, seed: int,
                 policies=PAPER_POLICIES, extra_cols=None, *,
                 engine: str = "python", reps: int = 1,
                 device="cuda") -> list[dict]:
    """One CSV row per policy on a trace sampled from ``wl``.

    ``engine="python"`` (the default) runs each policy on the event
    engine over one trace.  ``engine="torch"`` samples a ``reps``-
    replication Philox batch and runs every policy through the registry
    (:func:`run_policies_batch`), a policy with no kernel on the event
    engine.  A policy that is unstable on the trace gives a row of
    infinite response times with the error in ``note``.
    """
    if engine != "python":
        batch = wl.sample_traces(num_jobs, reps, seed=seed)
        return run_policies_batch(batch, wl, policies, engine=engine,
                                  device=engines.resolve_device(device),
                                  extra_cols=extra_cols)
    trace = wl.sample_trace(num_jobs, seed=seed)
    rows = []
    for name in policies:
        pol = make_policy(name, wl=wl)
        t0 = time.time()
        try:
            row = simulate_trace(trace, pol).row()
        except RuntimeError as e:       # unstable on this trace
            row = {"policy": name, "jobs": num_jobs,
                   "mean_response": float("inf"), "mean_wait": float("inf"),
                   "p_wait": 1.0, "p_helper": None,
                   "p95_response": float("inf"), "utilization": 0.0,
                   "note": str(e)[:60]}
        row["sim_s"] = round(time.time() - t0, 2)
        if extra_cols:
            row.update(extra_cols)
        rows.append(row)
    return rows


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
