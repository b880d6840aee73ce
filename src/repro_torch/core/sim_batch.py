"""Host result assembly and the Fig. 1/2 sweep of the port.

The port's counterpart of the host side of ``repro.core.sim_batch``: the
per-replication :class:`BatchSimResult` (numpy fields, assembled with the
reference's own numpy op order so results and CSV rows match it bit for
bit), the helpers every ``engine="torch"`` core shares (the drain-mode
failure helpers included), the grid plans and extracts that stack a
grid's cells onto one lane axis, and :func:`sweep_many_server`, which drives
the Fig. 1/2 k- and load-sweeps, with or without ``failures=`` and
crash-resumable with ``ckpt_dir=``, through
:func:`repro_torch.core.engines.simulate_grid`.  Streams are in
:mod:`repro_torch.core.stream`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..checkpoint import (completed_steps, require_layout,
                          restore_checkpoint, save_checkpoint)
from . import engines
from . import failures as flr
from .partition import BalancedPartition, balanced_partition
from .sim_torch import (_bs_args, _bs_scatter_events, _check_classes,
                        _srpt_args, _srpt_scatter_events)
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


def _bs_check_ovf(ovf, q_cap: int, cell: str = "") -> None:
    ovf = np.asarray(ovf)
    if ovf.any():
        raise QueueOverflowError(
            f"helper-wait ring buffer overflow (queue_cap={q_cap}) in "
            f"{cell}replication(s) {np.flatnonzero(ovf).tolist()} — "
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


def _srpt_check_ovf(ovf, q_cap: int, peak=None, cell: str = "") -> None:
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
            f"{cell}replication(s) {np.flatnonzero(ovf).tolist()} — "
            f"workload unstable at this load, or raise queue_cap{hint}")


def _srpt_no_failures(failures, policy: str) -> None:
    if failures is not None:
        raise NotImplementedError(
            f"policy {policy!r} has no fault-injection scan core — use "
            f"engine='python' (mode='kill' kill-and-requeue)")


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
# Grids: a figure's cells as the lanes of one launch.
#
# A grid stacks cells of different k, partition, J and failures onto one
# (cells x reps) lane axis, and each policy runs one wrapper call over it
# (the grid cores of :mod:`repro_torch.kernels.msj_scan.ops`).  The plans
# below are the reference's (``repro.core.sim_batch`` ``_*_grid_plan``):
# [G, R, ...] host arrays padded to the grid's largest sizes, and the
# per-lane sizes that keep every cell's result unchanged —
#
# * J-padding: ``BatchTrace.pad_jobs`` sentinels, processed after every
#   real job by FCFS and ModBS and never admitted by BS and SRPT (their
#   ``j_live``); merged drain streams pad with identity drain rows, BS
#   failure records with rows that never fire (``t_down = inf``);
# * k-padding: ``k_lane`` / ``h_lane`` live servers, the rest dead, and
#   ``slots`` [G, R, C_pad] with no slots for a padded class; a ModBS or
#   BS helper drain's marker "class == C" is the grid's C_pad.
#
# Each cell is extracted through the same ``_*_result`` helpers as the
# per-cell path, and overflow is judged per cell, so cell g of a grid
# equals ``simulate`` on cell g and the reference's grid cell g bit for
# bit (rtol=0).
# --------------------------------------------------------------------------


def _lanes_of(cells, values, dtype=np.int32) -> np.ndarray:
    """[G, R] per-lane sizes: ``values[g]`` in every lane of cell g."""
    R = cells[0].batch.reps
    return np.repeat(np.asarray(values, dtype)[:, None], R, axis=1)


#: host dtypes of the stacked job fields: the wrappers' (SRPT reads its
#: needs as float64), so an upload copies each field once
_JOB_DTYPES = dict(arrival=np.float64, cls=np.int32, service=np.float64,
                   need=np.int32)


def _grid_jobs(cells, *fields, need=np.int32) -> dict:
    """The ``fields`` of the cells' batches stacked to [G, R, J_pad]
    (``pad_jobs`` to the grid max J) in the wrappers' dtypes, and
    ``J_pad``."""
    J_pad = max(c.batch.num_jobs for c in cells)
    pads = [c.batch.pad_jobs(J_pad) for c in cells]
    out = dict(J_pad=J_pad)
    for f in fields:
        x = np.empty((len(cells), cells[0].batch.reps, J_pad),
                     need if f == "need" else _JOB_DTYPES[f])
        for g, b in enumerate(pads):
            x[g] = getattr(b, f)
        out[f] = x
    return out


def _grid_cell_parts(cells):
    """Each cell's eq.-2 partition (explicit or derived from its wl)."""
    parts = []
    for g, cell in enumerate(cells):
        if cell.partition is None and cell.wl is None:
            raise ValueError(f"grid cell {g}: need a partition or a "
                             f"workload")
        parts.append(cell.partition if cell.partition is not None
                     else balanced_partition(cell.wl))
    return parts


def _grid_slots(cells, all_slots, C_pad: int) -> np.ndarray:
    """[G, R, C_pad] slots; a padded class has none."""
    out = np.zeros((len(cells), cells[0].batch.reps, C_pad), np.int32)
    for g, slots in enumerate(all_slots):
        out[g, :, :len(slots)] = slots
    return out


def _pad_merged(mss, C_cells=None, C_pad: int = 0) -> dict:
    """Merged streams L-padded with identity drain rows (``is_fail`` with
    ``t_up = 0``: a no-op drain of the helper, class C_pad), in the
    wrappers' dtypes; the class column (``C_cells`` given: ModBS) has the
    helper-drain marker remapped from each cell's C to C_pad."""
    G, R = len(mss), mss[0].t.shape[0]
    L_pad = max(ms.t.shape[1] for ms in mss)
    cols = dict(t=(np.float64, 0.0), need=(np.int32, 1),
                svc=(np.float64, 0.0), t_up=(np.float64, 0.0),
                isf=(np.bool_, True))
    if C_cells is not None:
        cols["cls"] = (np.int32, C_pad)
    out = {k: np.empty((G, R, L_pad), dt) for k, (dt, _) in cols.items()}
    for g, ms in enumerate(mss):
        L = ms.t.shape[1]
        rows = dict(t=ms.t, need=ms.need, svc=ms.service, t_up=ms.t_up,
                    isf=ms.is_fail != 0)
        if C_cells is not None:
            rows["cls"] = np.where(ms.cls == C_cells[g], C_pad, ms.cls)
        for k, (_, fill) in cols.items():
            out[k][g, :, :L] = rows[k]
            out[k][g, :, L:] = fill
    return dict(out, mss=mss)


def _fcfs_grid_plan(cells) -> dict:
    ks = [c.batch.k for c in cells]
    return dict(_grid_jobs(cells, "arrival", "need", "service"),
                k_lane=_lanes_of(cells, ks), k_pad=max(ks))


def _fcfs_grid_extract(cells, starts) -> list:
    starts = np.asarray(starts)
    return [_fcfs_result(c.batch, starts[g][:, :c.batch.num_jobs])
            for g, c in enumerate(cells)]


def _fcfs_fail_grid_plan(cells) -> dict:
    ks = [c.batch.k for c in cells]
    p = _pad_merged([_merged_fcfs_inputs(c.batch, c.failures)
                     for c in cells])
    p.update(k_lane=_lanes_of(cells, ks), k_pad=max(ks))
    return p


def _fcfs_fail_grid_extract(cells, mss, starts_m) -> list:
    starts_m = np.asarray(starts_m)
    out = []
    for g, (c, ms) in enumerate(zip(cells, mss)):
        starts = np.take_along_axis(starts_m[g], ms.job_pos, axis=1)
        out.append(_with_drain_obs(_fcfs_result(c.batch, starts), c.batch,
                                   c.failures))
    return out


def _modbs_grid_statics(cells, parts) -> dict:
    """The cells' (slots, s_max, h) as per-lane arrays and their maxima."""
    args = [_partition_args(c.batch, part, None)
            for c, part in zip(cells, parts)]
    C_pad = max(len(a[0]) for a in args)
    return dict(slots=_grid_slots(cells, [a[0] for a in args], C_pad),
                h_lane=_lanes_of(cells, [a[2] for a in args]),
                C_pad=C_pad, s_max_pad=max(a[1] for a in args),
                h_pad=max(a[2] for a in args),
                C_cells=[len(a[0]) for a in args])


def _modbs_grid_plan(cells) -> dict:
    p = _modbs_grid_statics(cells, _grid_cell_parts(cells))
    p.update(_grid_jobs(cells, "arrival", "cls", "need", "service"))
    return p


def _modbs_grid_extract(cells, blocked, starts) -> list:
    blocked = np.asarray(blocked)
    starts = np.asarray(starts)
    out = []
    for g, c in enumerate(cells):
        J = c.batch.num_jobs
        out.append(_modbs_result(c.batch, blocked[g][:, :J],
                                 starts[g][:, :J]))
    return out


def _modbs_fail_grid_plan(cells) -> dict:
    """Merged streams with the helper-drain marker remapped from each
    cell's C to the grid's C_pad, L-padded with identity helper drains."""
    parts = _grid_cell_parts(cells)
    p = _modbs_grid_statics(cells, parts)
    mss = []
    for cell, part in zip(cells, parts):
        ft, ftgt, fup, count = flr.partition_targets(cell.failures, part)
        mss.append(flr.merge_failure_stream(cell.batch, ft, ftgt, fup,
                                            count, pad_cls=len(part.a)))
    p.update(_pad_merged(mss, p["C_cells"], p["C_pad"]))
    return p


def _modbs_fail_grid_extract(cells, mss, blocked_m, starts_m) -> list:
    blocked_m = np.asarray(blocked_m)
    starts_m = np.asarray(starts_m)
    out = []
    for g, (c, ms) in enumerate(zip(cells, mss)):
        starts = np.take_along_axis(starts_m[g], ms.job_pos, axis=1)
        blocked = np.take_along_axis(blocked_m[g], ms.job_pos, axis=1)
        out.append(_with_drain_obs(_modbs_result(c.batch, blocked, starts),
                                   c.batch, c.failures))
    return out


def _bs_grid_plan(cells) -> dict:
    args = [_bs_args(c.batch, c.partition, c.wl, c.queue_cap)
            for c in cells]                  # (slots, s_max, h, q_cap)
    C_pad = max(len(a[0]) for a in args)
    return dict(_grid_jobs(cells, "arrival", "cls", "need", "service"),
                slots=_grid_slots(cells, [a[0] for a in args], C_pad),
                h_lane=_lanes_of(cells, [a[2] for a in args]),
                j_live=_lanes_of(cells, [c.batch.num_jobs for c in cells]),
                C_pad=C_pad, s_max_pad=max(a[1] for a in args),
                h_pad=max(a[2] for a in args),
                q_cap_pad=max(a[3] for a in args),
                q_caps=[a[3] for a in args])


def _bs_grid_extract(cells, plan, tagged, rec_t, ovf) -> list:
    tagged = np.asarray(tagged)
    rec_t = np.asarray(rec_t)
    ovf = np.asarray(ovf)
    J_pad = plan["J_pad"]
    out = []
    for g, c in enumerate(cells):
        _bs_check_ovf(ovf[g], plan["q_caps"][g], cell=f"grid cell {g} ")
        starts, served, routed = _bs_scatter_events(J_pad, tagged[g],
                                                    rec_t[g])
        J = c.batch.num_jobs
        res = _bs_assemble(c.batch, starts[:, :J], served[:, :J],
                           routed[:, :J])
        if c.failures is not None:
            res = _with_drain_obs(res, c.batch, c.failures)
        out.append(res)
    return out


def _bs_fail_grid_plan(cells) -> dict:
    """BS plan plus F-padded failure records (``t_down = inf`` rows never
    fire) with the helper marker remapped from each cell's C to C_pad."""
    plan = _bs_grid_plan(cells)
    G, R = len(cells), cells[0].batch.reps
    C_pad, J_pad = plan["C_pad"], plan["J_pad"]
    frecs = [_bs_fail_args(c.batch, c.failures, c.partition, c.wl)
             for c in cells]                 # (ft, ftgt, fup, length)
    F_pad = max(fr[0].shape[1] for fr in frecs)
    ft = np.full((G, R, F_pad), np.inf)
    ftgt = np.full((G, R, F_pad), C_pad, np.int32)
    fup = np.zeros((G, R, F_pad))
    length = 0
    parts = _grid_cell_parts(cells)
    for g, (fr, part) in enumerate(zip(frecs, parts)):
        F = fr[0].shape[1]
        C_cell = len(part.a)
        ft[g, :, :F] = fr[0]
        ftgt[g, :, :F] = np.where(fr[1] == C_cell, C_pad, fr[1])
        fup[g, :, :F] = fr[2]
        # the cell's budget at the grid's J and F: 2 J_pad covers every
        # job's two events, F_pad every failure, fa the repair
        # completions of free-slot drains
        fa = fr[3] - 2 * cells[g].batch.num_jobs - max(1, F)
        length = max(length, 2 * J_pad + F_pad + fa)
    plan.update(ft=ft, ftgt=ftgt, fup=fup, length=length)
    return plan


def _srpt_grid_plan(cells) -> dict:
    """SRPT grid plan: the servers ``kk`` are per-lane data already, the
    slot table is Q-padded to the grid max and ``NU`` is the union of the
    cells' needs (a superset gives each cell the same walk)."""
    q_caps = [_srpt_args(c.batch, c.queue_cap) for c in cells]
    return dict(_grid_jobs(cells, "arrival", "need", "service",
                           need=np.float64),
                kk=_lanes_of(cells, [c.batch.k for c in cells], np.float64),
                j_live=_lanes_of(cells, [c.batch.num_jobs for c in cells]),
                NU=_srpt_nu(*[c.batch for c in cells]),
                Q_pad=max(q_caps), q_caps=q_caps)


def _srpt_grid_extract(cells, plan, job_ev, t_ev, fs_ev, ovf, npre,
                       ne, peak) -> list:
    job_ev, t_ev, fs_ev = (np.asarray(x) for x in (job_ev, t_ev, fs_ev))
    ovf, npre, ne = np.asarray(ovf), np.asarray(npre), np.asarray(ne)
    peak = np.asarray(peak)
    J_pad = plan["J_pad"]
    out = []
    for g, c in enumerate(cells):
        _srpt_check_ovf(ovf[g], plan["q_caps"][g], peak=peak[g],
                        cell=f"grid cell {g} ")
        if not (ne[g] == 2 * c.batch.num_jobs).all():
            raise RuntimeError(f"SRPT event scan under-ran grid cell {g}'s "
                               f"2J event budget")
        comp, fstart = _srpt_scatter_events(J_pad, job_ev[g], t_ev[g],
                                            fs_ev[g])
        J = c.batch.num_jobs
        out.append(BatchSimResult(
            response=comp[:, :J] - c.batch.arrival,
            wait=fstart[:, :J] - c.batch.arrival,
            p_helper=None, blocked=None, start=fstart[:, :J],
            preemptions=npre[g].astype(np.int64)))
    return out


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
    plain PyTorch versions.  ``engine="python"`` sweeps any policy of the
    event engine, on the host (``device`` ignored).  Returns mean/CI
    arrays [policies, points], equal to the reference's
    ``sweep_many_server`` on the same arguments (``sim_s`` aside).

    ``failures`` injects drain-mode outages (see :func:`_sweep_failures`):
    each point's batch gets its own FailureBatch, and ``availability``
    holds the mean live capacity fraction of each cell.

    ``ckpt_dir`` makes the sweep crash-resumable: every (point, policy)
    cell is written atomically (:mod:`repro_torch.checkpoint`) as its own
    step, ``point * P + policy``, the moment its results exist (in the
    grid path, right after the policy's grid launch returns), and
    ``resume=True`` restores completed cells — their ``sim_s`` included —
    instead of simulating them; a point whose every cell is restored is
    not even sampled.  The step numbering is the same in both paths, so
    a sweep checkpointed cell by cell resumes under ``grid=True`` and the
    other way round, with the same output.  A cell written under another
    policy fails loudly, naming the key.
    """
    if engine not in engines.available_engines():
        raise ValueError(f"unknown engine {engine!r}; registered engines: "
                         f"{list(engines.available_engines())}")
    avail = engines.policies_for(engine)
    unknown = {engines.canonical(p) for p in policies} - set(avail)
    if unknown:
        raise KeyError(f"no {engine!r} simulator for {sorted(unknown)}; "
                       f"available: {list(avail)}")
    if resume and ckpt_dir is None:
        raise ValueError("resume=True needs a ckpt_dir")
    if engine in engines.DEVICE_ENGINES:
        engines.resolve_device(device)
    P, N = len(policies), len(points)
    shape = (P, N)
    mean_r = np.zeros(shape); ci_r = np.zeros(shape)
    mean_w = np.zeros(shape); p_wait = np.zeros(shape)
    ci_pw = np.zeros(shape)
    p_help = np.full(shape, np.nan)
    p95 = np.zeros(shape); util = np.zeros(shape); sim_s = np.zeros(shape)
    avail = None if failures is None else np.zeros(shape)
    cells = (mean_r, ci_r, mean_w, p_wait, ci_pw, p_help, p95, util, sim_s)
    if avail is not None:
        cells += (avail,)
    done: set[int] = set()
    if resume:
        done = set(completed_steps(ckpt_dir))

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

    def _restore_cell(i: int, j: int, pol: str) -> None:
        cell = j * P + i
        tree, _, extra = restore_checkpoint(
            ckpt_dir, {"cell": np.zeros(len(cells))}, step=cell)
        require_layout(extra, {"policy": pol}, context=f"cell {cell}")
        if tree["cell"].shape != (len(cells),):
            raise ValueError(
                f"checkpoint cell {cell} holds {tree['cell'].size} values, "
                f"this sweep records {len(cells)} (failures= differs?)")
        for arr, v in zip(cells, tree["cell"]):
            arr[i, j] = v

    def _record_cell(i: int, j: int, pol: str, res, wall: float) -> None:
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
        if ckpt_dir is not None:
            save_checkpoint(
                ckpt_dir, j * P + i,
                {"cell": np.array([a[i, j] for a in cells])},
                extra={"point": repr(points[j]), "policy": pol})

    if grid:
        for i, pol in enumerate(policies):
            todo = []
            for j in range(N):
                if j * P + i in done:
                    _restore_cell(i, j, pol)
                else:
                    todo.append(j)
            if not todo:
                continue
            gcells = []
            for j in todo:
                wl, batch, _, fb = _point_data(j)
                gcells.append(engines.GridCell(batch=batch, wl=wl,
                                               failures=fb))
            t0 = time.time()
            results = engines.simulate_grid(pol, gcells, engine=engine,
                                            device=device)
            wall = (time.time() - t0) / len(todo)
            for j, res in zip(todo, results):
                _record_cell(i, j, pol, res, wall)
    else:
        for j in range(N):
            for i, pol in enumerate(policies):
                if j * P + i in done:
                    _restore_cell(i, j, pol)
                    continue
                wl, batch, _, fb = _point_data(j)
                t0 = time.time()
                res = engines.simulate(pol, batch, engine=engine,
                                       device=device, wl=wl, failures=fb)
                _record_cell(i, j, pol, res, time.time() - t0)
    return SweepResult(points=tuple(points), policies=tuple(policies),
                       num_jobs=num_jobs, reps=reps,
                       mean_response=mean_r, ci95_response=ci_r,
                       mean_wait=mean_w, p_wait=p_wait, ci95_p_wait=ci_pw,
                       p_helper=p_help, p95_response=p95,
                       utilization=util, sim_s=sim_s, availability=avail)
