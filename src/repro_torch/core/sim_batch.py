"""Host result assembly and the Fig. 1/2 sweep of the port.

The port's counterpart of the host side of ``repro.core.sim_batch``: the
per-replication :class:`BatchSimResult` (numpy fields, assembled with the
reference's own numpy op order so results and CSV rows match it bit for
bit), the helpers every ``engine="torch"`` core shares (the drain-mode
failure helpers included), and :func:`sweep_many_server`, which drives
the Fig. 1/2 k- and load-sweeps, with or without ``failures=``, through
:func:`repro_torch.core.engines.simulate_grid`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from . import engines
from . import failures as flr
from .partition import BalancedPartition, balanced_partition
from .sim_torch import (_bs_scatter_events, _check_classes,
                        _srpt_scatter_events)
from .workload import BatchTrace, Workload

#: waiting-time epsilon for P[wait > 0] — the reference's ``WAIT_EPS``
WAIT_EPS = 1e-9


class QueueOverflowError(RuntimeError):
    """A scan's bounded queue (BS helper-wait ring, SRPT slot table)
    overflowed: the workload is unstable at this load, or the bound is too
    small.  The figure scripts turn it into an infinite-response row."""


@dataclasses.dataclass(frozen=True)
class BatchSimResult:
    """Per-replication sample-path metrics of a batched simulation."""

    response: np.ndarray        # [R, J] response time per job
    wait: np.ndarray            # [R, J] waiting time per job
    p_helper: np.ndarray | None # [R] fraction served on helpers (BSF only)
    blocked: np.ndarray | None  # [R, J] bool (ModBS routing)
    p_routed: np.ndarray | None = None  # [R] fraction routed to H on arrival
                                        # (> p_helper under Def.-1 pull-backs)
    start: np.ndarray | None = None     # [R, J] raw start times
    # failure-scenario observables (None without fault injection):
    kills: np.ndarray | None = None         # [R] jobs killed mid-service
    requeues: np.ndarray | None = None      # [R] killed jobs requeued
    availability: np.ndarray | None = None  # [R] time-avg live fraction
    # preempt-resume observable (None for nonpreemptive policies):
    preemptions: np.ndarray | None = None   # [R] preemption events

    @property
    def reps(self) -> int:
        return self.response.shape[0]

    @property
    def mean_response(self) -> np.ndarray:
        """[R] mean response time of each replication."""
        return self.response.mean(axis=1)

    @property
    def mean_wait(self) -> np.ndarray:
        return self.wait.mean(axis=1)

    @property
    def p_wait(self) -> np.ndarray:
        """[R] queueing probability P[wait > 0] of each replication."""
        return (self.wait > WAIT_EPS).mean(axis=1)


# -- shared input-prep / result-assembly helpers -----------------------------


def _fcfs_inputs(batch: BatchTrace, device: torch.device) -> tuple:
    """(arrival f64, need i32, service f64) tensors of a batch on device."""
    return (torch.tensor(batch.arrival, dtype=torch.float64, device=device),
            torch.tensor(batch.need, dtype=torch.int32, device=device),
            torch.tensor(batch.service, dtype=torch.float64, device=device))


def _class_inputs(batch: BatchTrace, device: torch.device) -> tuple:
    """(arrival f64, cls i32, need i32, service f64) tensors on device."""
    a, n, v = _fcfs_inputs(batch, device)
    return a, torch.tensor(batch.cls, dtype=torch.int32, device=device), n, v


def _partition_args(batch: BatchTrace, partition: BalancedPartition | None,
                    wl: Workload | None) -> tuple[np.ndarray, int, int]:
    """(slots, s_max, h) of the eq.-2 partition, validated for the batch."""
    if partition is None:
        if wl is None:
            raise ValueError("need a partition or a workload")
        partition = balanced_partition(wl)
    slots = np.asarray(partition.slots, dtype=np.int32)
    s_max = int(slots.max())
    h = int(partition.helpers)
    if h < int(batch.need.max()):
        raise ValueError("helper set smaller than the largest server need")
    _check_classes(batch, len(slots))
    return slots, s_max, h


def _fcfs_result(batch: BatchTrace, starts) -> BatchSimResult:
    starts = np.asarray(starts)
    return BatchSimResult(response=starts + batch.service - batch.arrival,
                          wait=starts - batch.arrival,
                          p_helper=None, blocked=None, start=starts)


def _modbs_result(batch: BatchTrace, blocked, starts) -> BatchSimResult:
    blocked = np.asarray(blocked)
    starts = np.asarray(starts)
    return BatchSimResult(response=starts + batch.service - batch.arrival,
                          wait=starts - batch.arrival,
                          p_helper=blocked.mean(axis=1), blocked=blocked,
                          p_routed=blocked.mean(axis=1), start=starts)


def _bs_check_ovf(ovf, q_cap: int) -> None:
    ovf = np.asarray(ovf)
    if ovf.any():
        raise QueueOverflowError(
            f"helper-wait ring buffer overflow (queue_cap={q_cap}) in "
            f"replication(s) {np.flatnonzero(ovf).tolist()} — "
            f"workload unstable at this load, or raise queue_cap")


def _bs_assemble(batch: BatchTrace, starts, served,
                 routed) -> BatchSimResult:
    """Per-job event arrays -> BatchSimResult (one shared op order)."""
    return BatchSimResult(response=starts + batch.service - batch.arrival,
                          wait=starts - batch.arrival,
                          p_helper=served.mean(axis=1), blocked=None,
                          p_routed=routed.mean(axis=1), start=starts)


def _bs_result(batch: BatchTrace, tagged, rec_t, ovf,
               q_cap: int) -> BatchSimResult:
    _bs_check_ovf(ovf, q_cap)
    starts, served, routed = _bs_scatter_events(batch.num_jobs, tagged,
                                                rec_t)
    return _bs_assemble(batch, starts, served, routed)


# -- drain-mode failure helpers (fcfs / modbs-fcfs / bs-fcfs) ----------------


def _with_drain_obs(res: BatchSimResult, batch: BatchTrace,
                    fb) -> BatchSimResult:
    return dataclasses.replace(
        res, **flr.drain_observables(fb, batch, res.response))


def _merged_fcfs_inputs(batch: BatchTrace, fb) -> flr.MergedStream:
    ft, ftgt, fup, count = flr.fcfs_targets(fb)
    return flr.merge_failure_stream(batch, ft, ftgt, fup, count, pad_cls=0)


def _merged_class_inputs(batch: BatchTrace, fb, partition,
                         wl) -> flr.MergedStream:
    """The merged stream of a ModBS drain run: failure rows carry their
    target block (C = the helper) in the class column."""
    part = partition if partition is not None else balanced_partition(wl)
    ft, ftgt, fup, count = flr.partition_targets(fb, part)
    return flr.merge_failure_stream(batch, ft, ftgt, fup, count,
                                    pad_cls=len(part.a))


def _merged_tensors(ms: flr.MergedStream, device: torch.device) -> tuple:
    """(t f64, cls i32, need i32, service f64, t_up f64, is_fail bool)
    tensors of a merged stream on device."""
    return (torch.tensor(ms.t, dtype=torch.float64, device=device),
            torch.tensor(ms.cls, dtype=torch.int32, device=device),
            torch.tensor(ms.need, dtype=torch.int32, device=device),
            torch.tensor(ms.service, dtype=torch.float64, device=device),
            torch.tensor(ms.t_up, dtype=torch.float64, device=device),
            torch.tensor(ms.is_fail != 0, dtype=torch.bool, device=device))


def _unmerge(ms: flr.MergedStream, *per_row) -> tuple:
    """Per-row [R, L] scan outputs -> per-job [R, J] (the arrival rows)."""
    return tuple(np.take_along_axis(np.asarray(x), ms.job_pos, axis=1)
                 for x in per_row)


def _bs_fail_args(batch: BatchTrace, failures, partition, wl):
    """(ft, ftgt, fup, scan length) of a BS drain run.

    Length = 2J + F + F_A: every failure event consumes a step, and each
    *class-targeted* event may claim a free slot, adding one future
    repair-completion event.  With no failure event at all one ``+inf``
    pad row stands in (F = 1); it never fires.
    """
    part = partition if partition is not None else balanced_partition(wl)
    ft, ftgt, fup, count = flr.partition_targets(failures, part)
    C = len(part.a)
    F = max(1, ft.shape[1])
    if ft.shape[1] == 0:
        ft = np.full((batch.reps, 1), np.inf)
        ftgt = np.full((batch.reps, 1), C, dtype=np.int32)
        fup = np.zeros((batch.reps, 1))
    fa = int((ftgt < C).sum(axis=1).max()) if ft.size else 0
    return ft, ftgt, fup, 2 * batch.num_jobs + F + fa


# -- preemptive SRPT-family helpers (sf-srpt / ff-srpt) ----------------------


def _srpt_nu(*batches) -> tuple:
    """Ascending tuple of distinct server needs — the rounds of the
    first-fit walk.  A superset is always correct."""
    return tuple(sorted({int(v) for b in batches for v in np.unique(b.need)}))


def _srpt_check_ovf(ovf, q_cap: int, peak=None) -> None:
    ovf = np.asarray(ovf)
    if ovf.any():
        hint = ""
        if peak is not None:
            need = int(np.asarray(peak).max())
            # the peak stops counting dropped arrivals after the first
            # overflow, so it is a lower bound on the required capacity
            q_next = max(1 << max(need - 1, 1).bit_length(), 2 * q_cap)
            hint = (f"; measured peak occupancy >= {need} jobs — pass "
                    f"queue_cap={q_next} (the next power of two) or more")
        raise QueueOverflowError(
            f"SRPT slot table overflow (queue_cap={q_cap}) in "
            f"replication(s) {np.flatnonzero(ovf).tolist()} — "
            f"workload unstable at this load, or raise queue_cap{hint}")


def _srpt_no_failures(failures, policy: str) -> None:
    if failures is not None:
        raise NotImplementedError(
            f"policy {policy!r} has no fault-injection scan core (the "
            f"reference runs it on its python engine, mode='kill', which "
            f"is not ported)")


def _srpt_result(batch: BatchTrace, job_ev, t_ev, fs_ev, ovf, npre, ne,
                 q_cap: int, peak=None) -> BatchSimResult:
    """Event streams -> BatchSimResult (response = completion - arrival,
    wait = first start - arrival); raises on overflow."""
    _srpt_check_ovf(ovf, q_cap, peak=peak)
    if not (np.asarray(ne) == 2 * batch.num_jobs).all():
        raise RuntimeError("SRPT event scan under-ran its 2J event budget")
    comp, fstart = _srpt_scatter_events(batch.num_jobs, job_ev, t_ev, fs_ev)
    return BatchSimResult(response=comp - batch.arrival,
                          wait=fstart - batch.arrival,
                          p_helper=None, blocked=None, start=fstart,
                          preemptions=np.asarray(npre).astype(np.int64))


# --------------------------------------------------------------------------
# k-sweeps.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Mean/CI arrays of a batched sweep, shaped [policies, points].

    ``ci95_*`` is the half-width of the normal 95% confidence interval over
    the per-replication means (0 when ``reps == 1``).
    """

    points: tuple                  # the swept values (k, or load, ...)
    policies: tuple[str, ...]
    num_jobs: int
    reps: int
    mean_response: np.ndarray      # [P, N]
    ci95_response: np.ndarray      # [P, N]
    mean_wait: np.ndarray          # [P, N]
    p_wait: np.ndarray             # [P, N]
    ci95_p_wait: np.ndarray        # [P, N]
    p_helper: np.ndarray           # [P, N], nan where not a BSF policy
    p95_response: np.ndarray       # [P, N] (mean of per-rep 95th pctiles)
    utilization: np.ndarray        # [P, N] busy server-time / (k * horizon)
    sim_s: np.ndarray              # [P, N] simulator wall time
    # [P, N] mean time-averaged live capacity fraction (``failures=``
    # sweeps only; the reference's SweepResult has no such field)
    availability: np.ndarray | None = None

    def rows(self, point_col: str, extra_cols: dict | None = None,
             per_point_cols: Sequence[dict] | None = None) -> list[dict]:
        """Benchmark CSV rows, one per (point, policy)."""
        out = []
        for j, pt in enumerate(self.points):
            for i, pol in enumerate(self.policies):
                ph = self.p_helper[i, j]
                row = {
                    point_col: pt, "policy": pol,
                    "jobs": self.num_jobs, "reps": self.reps,
                    "mean_response": self.mean_response[i, j],
                    "ci95_response": self.ci95_response[i, j],
                    "mean_wait": self.mean_wait[i, j],
                    "p_wait": self.p_wait[i, j],
                    "ci95_p_wait": self.ci95_p_wait[i, j],
                    "p_helper": None if np.isnan(ph) else ph,
                    "p95_response": self.p95_response[i, j],
                    "utilization": self.utilization[i, j],
                    "sim_s": round(float(self.sim_s[i, j]), 2),
                }
                if extra_cols:
                    row.update(extra_cols)
                if per_point_cols:
                    row.update(per_point_cols[j])
                out.append(row)
        return out


def _ci95(per_rep: np.ndarray) -> float:
    if per_rep.size < 2:
        return 0.0
    return float(1.96 * per_rep.std(ddof=1) / np.sqrt(per_rep.size))


def _sweep_failures(failures, wl: Workload, batch: BatchTrace, seed: int):
    """Materialize the per-point FailureBatch of a faulty sweep.

    ``failures`` is either a :class:`repro_torch.core.failures.
    FailureProcess` (sampled here with the point's k and the batch's
    arrival horizon, same seed as the traces) or a callable
    ``(wl, batch) -> FailureBatch`` for full control.
    """
    if hasattr(failures, "sample"):
        horizon = float(batch.arrival.max())
        return failures.sample(wl.k, horizon, batch.reps, seed=seed)
    return failures(wl, batch)


def sweep_many_server(wl_factory: Callable[..., Workload], points: Sequence,
                      *, num_jobs: int = 100_000, reps: int = 8,
                      seed: int = 0,
                      policies: Sequence[str] = ("fcfs", "modbs-fcfs",
                                                 "bs-fcfs"),
                      engine: str = "torch",
                      device="cuda",
                      grid: bool = True,
                      failures=None,
                      ckpt_dir: str | None = None,
                      resume: bool = False,
                      ) -> SweepResult:
    """Run the simulators over ``wl_factory(point)`` for each point.

    One batch of ``reps`` Philox replications x ``num_jobs`` arrivals is
    sampled per point — the reference's batches, bit for bit.  With
    ``grid=True`` each policy runs all points through one
    :func:`engines.simulate_grid` call (``sim_s`` then records that call's
    wall time amortized over its cells); ``grid=False`` dispatches one
    :func:`engines.simulate` per (point, policy) with exact per-cell
    timing.  Both give the same numbers.  ``device="cuda"`` (the default)
    runs the kernels and raises without a card; ``device="cpu"`` runs the
    plain PyTorch versions.  Returns mean/CI arrays [policies, points],
    equal to the reference's ``sweep_many_server`` on the same arguments
    (``sim_s`` aside).

    ``failures`` injects drain-mode outages (see :func:`_sweep_failures`):
    each point's batch gets its own FailureBatch, and ``availability``
    holds the mean live capacity fraction of each cell.  ``ckpt_dir``
    and ``resume`` are not ported yet and raise ``NotImplementedError``.
    """
    if ckpt_dir is not None or resume:
        raise NotImplementedError(
            "crash-resumable sweeps (ckpt_dir=/resume=) are not ported yet: "
            "ROADMAP Queue 1 item 10 (checkpointing)")
    if engine not in engines.available_engines():
        raise ValueError(f"unknown engine {engine!r}; registered engines: "
                         f"{list(engines.available_engines())}")
    avail = engines.policies_for(engine)
    unknown = {engines.canonical(p) for p in policies} - set(avail)
    if unknown:
        raise KeyError(f"no {engine!r} simulator for {sorted(unknown)}; "
                       f"available: {list(avail)}")
    engines.resolve_device(device)
    P, N = len(policies), len(points)
    shape = (P, N)
    mean_r = np.zeros(shape); ci_r = np.zeros(shape)
    mean_w = np.zeros(shape); p_wait = np.zeros(shape)
    ci_pw = np.zeros(shape)
    p_help = np.full(shape, np.nan)
    p95 = np.zeros(shape); util = np.zeros(shape); sim_s = np.zeros(shape)
    avail = None if failures is None else np.zeros(shape)

    sampled: dict[int, tuple] = {}

    def _point_data(j: int) -> tuple:
        if j not in sampled:
            wl = wl_factory(points[j])
            batch = wl.sample_traces(num_jobs, reps, seed=seed)
            busy = (batch.need * batch.service).sum(axis=1)    # [R]
            fb = (_sweep_failures(failures, wl, batch, seed)
                  if failures is not None else None)
            sampled[j] = (wl, batch, busy, fb)
        return sampled[j]

    def _record_cell(i: int, j: int, res, wall: float) -> None:
        wl, batch, busy, _ = sampled[j]
        sim_s[i, j] = wall
        mean_r[i, j] = res.mean_response.mean()
        ci_r[i, j] = _ci95(res.mean_response)
        mean_w[i, j] = res.mean_wait.mean()
        p_wait[i, j] = res.p_wait.mean()
        ci_pw[i, j] = _ci95(res.p_wait)
        if res.p_helper is not None:
            p_help[i, j] = res.p_helper.mean()
        p95[i, j] = np.percentile(res.response, 95, axis=1).mean()
        completion = batch.arrival + res.response
        horizon = completion.max(axis=1)                       # [R]
        util[i, j] = (busy / (wl.k * horizon)).mean()
        if avail is not None:
            avail[i, j] = res.availability.mean()

    if grid:
        for i, pol in enumerate(policies):
            gcells = []
            for j in range(N):
                wl, batch, _, fb = _point_data(j)
                gcells.append(engines.GridCell(batch=batch, wl=wl,
                                               failures=fb))
            t0 = time.time()
            results = engines.simulate_grid(pol, gcells, engine=engine,
                                            device=device)
            wall = (time.time() - t0) / N
            for j, res in enumerate(results):
                _record_cell(i, j, res, wall)
    else:
        for j in range(N):
            for i, pol in enumerate(policies):
                wl, batch, _, fb = _point_data(j)
                t0 = time.time()
                res = engines.simulate(pol, batch, engine=engine,
                                       device=device, wl=wl, failures=fb)
                _record_cell(i, j, res, time.time() - t0)
    return SweepResult(points=tuple(points), policies=tuple(policies),
                       num_jobs=num_jobs, reps=reps,
                       mean_response=mean_r, ci95_response=ci_r,
                       mean_wait=mean_w, p_wait=p_wait, ci95_p_wait=ci_pw,
                       p_helper=p_help, p95_response=p95,
                       utilization=util, sim_s=sim_s, availability=avail)
