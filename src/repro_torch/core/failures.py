"""Server breakdown/repair as a scenario axis: the port's copy of the
reference's ``repro.core.failures``.

A :class:`FailureProcess` puts each *pod* (a block of ``pod_size``
consecutive servers — pod_size=1 means independent servers) through
alternating exponential up/down cycles: up ~ Exp(mtbf), down ~ Exp(mttr).
Replication ``r`` draws from the counter-based Philox stream
``failure_stream(seed, r)`` — the same ``(seed, rep)`` key as
:func:`repro_torch.core.workload.sample_traces`, jumped one counter block
ahead so failure draws never collide with the trace draws of the same
replication.  The sampled process materializes into a
:class:`FailureBatch` of padded ``[R, E]`` event arrays plus a
per-replication capacity trace ``k_live(t)``
(:meth:`FailureBatch.capacity_trace`).  Sampling is plain numpy on the
reference's streams, so a seed gives bit-equal outage histories on both
sides.

The port's scan cores implement ``mode="drain"``: a failure event claims
the *earliest-free* capacity unit of its target block and holds it until
``t_up``; for a Kiefer–Wolfowitz free-time vector ``W`` the drain is
``W[0] := max(W[0], t_up)`` (re-sorted); for a ModBS/BS class row it
extends the ``argmin`` completion entry (or occupies a free slot).
Running jobs are never preempted, so a breakdown defers *future* starts
instead of killing work in flight.  ``mode="kill"`` (kill-and-requeue
with a BS-π repartition on each capacity change) runs only on the event
engine, ``engine="python"`` (:mod:`repro_torch.core.simulator`): the scan
cores raise on it (:func:`require_drain`).

Everything the engines share — event→target mapping under a
:class:`BalancedPartition` (with slot-level dedup of pod outages), the
chronologically merged arrival+failure stream, and the availability
integral — lives here, statement for statement as in the reference, so
the port and the reference order events and break ties identically by
construction.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .workload import BatchTrace, replication_stream

_MODES = ("drain", "kill")


def failure_stream(seed: int, rep: int) -> np.random.Philox:
    """Philox stream for failure draws of replication ``rep``.

    Same (seed, rep) key as :func:`replication_stream`, jumped one 2**128
    counter block ahead — pure arithmetic, provably disjoint from the
    trace-sampling draws of the same replication.
    """
    return replication_stream(seed, rep).jumped(1)


@dataclasses.dataclass(frozen=True)
class FailureProcess:
    """MTBF/MTTR renewal process over pods of consecutive servers."""

    mtbf: float            # mean up-time per pod (exponential)
    mttr: float            # mean down-time per pod (exponential)
    pod_size: int = 1      # servers per pod (correlated outage unit)
    mode: str = "drain"    # "drain" (scan cores) | "kill" (python oracle)

    def __post_init__(self):
        if not (self.mtbf > 0 and self.mttr > 0):
            raise ValueError("mtbf and mttr must be positive")
        if self.pod_size < 1:
            raise ValueError("pod_size must be >= 1")
        if self.mode not in _MODES:
            raise ValueError(f"unknown failure mode {self.mode!r}")

    def sample(self, k: int, horizon: float, reps: int,
               seed: int = 0) -> "FailureBatch":
        """Sample ``reps`` independent outage histories over ``[0, horizon)``.

        A pod outage emits one event row per member server sharing the
        same ``(t_down, t_up)``; rows are sorted per replication by
        ``(t_down, t_up, server)`` and padded to the widest replication
        with ``t_down=+inf`` sentinels.
        """
        if k < 1:
            raise ValueError("k must be >= 1")
        if reps < 1:
            raise ValueError("need at least one replication")
        if not (horizon > 0 and math.isfinite(horizon)):
            raise ValueError("horizon must be positive and finite")
        pods = [(p * self.pod_size, min(k, (p + 1) * self.pod_size))
                for p in range(-(-k // self.pod_size))]
        per_rep: list[np.ndarray] = []
        for r in range(reps):
            rng = np.random.Generator(failure_stream(seed, r))
            rows: list[tuple[float, float, int]] = []
            for lo, hi in pods:
                t = 0.0
                while True:
                    t_down = t + rng.exponential(self.mtbf)
                    if t_down >= horizon:
                        break
                    t_up = t_down + rng.exponential(self.mttr)
                    rows.extend((t_down, t_up, u) for u in range(lo, hi))
                    t = t_up
            rec = np.array(rows, dtype=np.float64).reshape(-1, 3)
            order = np.lexsort((rec[:, 2], rec[:, 1], rec[:, 0]))
            per_rep.append(rec[order])
        E = max(r.shape[0] for r in per_rep)
        t_down = np.full((reps, E), np.inf)
        t_up = np.zeros((reps, E))
        server = np.zeros((reps, E), dtype=np.int64)
        count = np.zeros(reps, dtype=np.int64)
        for r, rec in enumerate(per_rep):
            n = rec.shape[0]
            count[r] = n
            t_down[r, :n] = rec[:, 0]
            t_up[r, :n] = rec[:, 1]
            server[r, :n] = rec[:, 2].astype(np.int64)
        return FailureBatch(t_down=t_down, t_up=t_up, server=server,
                            count=count, k=k, horizon=float(horizon),
                            mode=self.mode)


@dataclasses.dataclass(frozen=True)
class FailureBatch:
    """``reps`` stacked outage histories as padded [R, E] event arrays."""

    t_down: np.ndarray    # float64 [R, E], +inf past count[r]
    t_up: np.ndarray      # float64 [R, E]
    server: np.ndarray    # int64   [R, E], one row per affected server
    count: np.ndarray     # int64   [R] valid prefix length
    k: int
    horizon: float
    mode: str = "drain"

    def __post_init__(self):
        if not (self.t_down.shape == self.t_up.shape == self.server.shape)\
                or self.t_down.ndim != 2:
            raise ValueError("failure arrays must share one [R, E] shape")
        if self.count.shape != (self.t_down.shape[0],):
            raise ValueError("count must be [R]")

    @property
    def reps(self) -> int:
        return self.t_down.shape[0]

    def capacity_trace(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        """``k_live(t)`` for replication ``r`` as a right-continuous step
        function: (event times, live capacity after each event)."""
        n = int(self.count[r])
        times = np.concatenate([self.t_down[r, :n], self.t_up[r, :n]])
        delta = np.concatenate([np.full(n, -1), np.full(n, 1)])
        order = np.argsort(times, kind="stable")
        return times[order], self.k + np.cumsum(delta[order])

    def k_live(self, r: int, t: float) -> int:
        """Live capacity of replication ``r`` at time ``t``."""
        n = int(self.count[r])
        down = int(((self.t_down[r, :n] <= t)
                    & (t < self.t_up[r, :n])).sum())
        return self.k - down

    def availability(self, horizon) -> np.ndarray:
        """Time-averaged live fraction over [0, h] per replication.

        ``horizon`` may be a scalar or an [R] array (e.g. each
        replication's last completion).  The same float expression is
        evaluated for every engine, so the observable is bit-identical
        across the registry by construction.
        """
        h = np.broadcast_to(np.asarray(horizon, dtype=np.float64),
                            (self.reps,))
        down = np.clip(np.minimum(self.t_up, h[:, None])
                       - np.minimum(self.t_down, h[:, None]), 0.0, None)
        return 1.0 - down.sum(axis=1) / (self.k * h)

    def grouped_events(self, r: int) -> list[tuple[float, float, int]]:
        """Replication ``r``'s outages as ``(t_down, t_up, m)`` with the
        ``m`` member servers of a pod coalesced — the kill-mode oracle
        consumes capacity counts, not server identities."""
        n = int(self.count[r])
        out: list[tuple[float, float, int]] = []
        for td, tu in zip(self.t_down[r, :n], self.t_up[r, :n]):
            if out and out[-1][0] == td and out[-1][1] == tu:
                out[-1] = (td, tu, out[-1][2] + 1)
            else:
                out.append((td, tu, 1))
        return out


# -- shared engine-side event preparation -------------------------------------
#
# Every core consumes the same host-prepared event streams; the functions
# below are the single source of truth for event→target mapping and
# chronological ordering, so the port's scan cores and the reference's
# engines cannot disagree on a tie-break.


def fcfs_targets(fb: FailureBatch):
    """FCFS drains the pooled W vector: every server row is one drain.

    Returns ``(t, target, t_up, count)`` padded [R, E]; target is always
    0 (ignored — FCFS has a single block).
    """
    return (fb.t_down.copy(), np.zeros(fb.t_down.shape, dtype=np.int32),
            fb.t_up.copy(), fb.count.copy())


def partition_targets(fb: FailureBatch, partition):
    """Map server outages onto a :class:`BalancedPartition`'s blocks.

    A class block [A_c] is served in gang *slots* of ``needs[c]`` servers;
    any member server down takes the whole slot down, so pod rows landing
    in the same (t_down, t_up, class, slot) are deduplicated to a single
    event.  Helper servers are individual capacity units — each row is its
    own event.  Returns ``(t, target, t_up, count)`` padded [R, F] arrays
    sorted by (t_down, t_up, target, slot); ``target == C`` is the helper
    block, pads carry ``t=+inf``.
    """
    if partition.k != fb.k:
        raise ValueError(
            f"failure batch sampled for k={fb.k} but partition has "
            f"k={partition.k}")
    C = len(partition.a)
    offs = np.asarray(partition.offsets + (partition.helper_offset,),
                      dtype=np.int64)
    needs = np.asarray(partition.needs, dtype=np.int64)
    per_rep: list[np.ndarray] = []
    for r in range(fb.reps):
        n = int(fb.count[r])
        u = fb.server[r, :n]
        if (u < 0).any() or (u >= fb.k).any():
            raise ValueError(f"replication {r}: server id outside [0, k)")
        is_helper = u >= partition.helper_offset
        c = np.minimum(np.searchsorted(offs, u, side="right") - 1, C - 1)
        slot = np.where(
            is_helper, u - partition.helper_offset,
            (u - offs[c]) // np.maximum(needs[np.minimum(c, C - 1)], 1))
        target = np.where(is_helper, C, c)
        rec = np.stack([fb.t_down[r, :n], fb.t_up[r, :n],
                        target.astype(np.float64),
                        slot.astype(np.float64)], axis=1)
        per_rep.append(np.unique(rec, axis=0))  # sorts + dedups slots
    F = max((r.shape[0] for r in per_rep), default=0)
    t = np.full((fb.reps, F), np.inf)
    tgt = np.full((fb.reps, F), C, dtype=np.int32)
    tup = np.zeros((fb.reps, F))
    count = np.zeros(fb.reps, dtype=np.int64)
    for r, rec in enumerate(per_rep):
        n = rec.shape[0]
        count[r] = n
        t[r, :n] = rec[:, 0]
        tup[r, :n] = rec[:, 1]
        tgt[r, :n] = rec[:, 2].astype(np.int32)
    return t, tgt, tup, count


@dataclasses.dataclass(frozen=True)
class MergedStream:
    """Arrivals and failure events merged chronologically, padded [R, L].

    Ordering per replication: by time, arrivals before failures at equal
    times, original order within each kind.  Pad rows are no-op failures
    (``t=+inf``, ``t_up=0`` — a drain by ``max(entry, 0)`` is the
    identity).  ``job_pos[r, j]`` is the merged-row position of arrival
    ``j``, for scattering per-job scan outputs back to job order.
    """

    t: np.ndarray         # float64 [R, L]
    cls: np.ndarray       # int32   [R, L]; failure rows carry the target
    need: np.ndarray      # int32   [R, L]
    service: np.ndarray   # float64 [R, L]
    t_up: np.ndarray      # float64 [R, L]
    is_fail: np.ndarray   # int32   [R, L]
    job_pos: np.ndarray   # int64   [R, J]


def merge_failure_stream(batch: BatchTrace, ft: np.ndarray, ftgt: np.ndarray,
                         fup: np.ndarray, fcount: np.ndarray,
                         pad_cls: int) -> MergedStream:
    """Merge [R, J] arrivals with per-replication failure events."""
    R, J = batch.arrival.shape
    E = ft.shape[1]
    L = J + E
    t = np.full((R, L), np.inf)
    cls = np.full((R, L), pad_cls, dtype=np.int32)
    need = np.ones((R, L), dtype=np.int32)
    service = np.zeros((R, L))
    t_up = np.zeros((R, L))
    is_fail = np.ones((R, L), dtype=np.int32)
    job_pos = np.empty((R, J), dtype=np.int64)
    for r in range(R):
        n = int(fcount[r])
        tt = np.concatenate([batch.arrival[r], ft[r, :n]])
        kind = np.concatenate([np.zeros(J, np.int64), np.ones(n, np.int64)])
        seq = np.concatenate([np.arange(J), np.arange(n)])
        order = np.lexsort((seq, kind, tt))
        m = J + n
        t[r, :m] = tt[order]
        cls[r, :m] = np.concatenate(
            [batch.cls[r].astype(np.int32), ftgt[r, :n]])[order]
        need[r, :m] = np.concatenate(
            [batch.need[r].astype(np.int32),
             np.ones(n, np.int32)])[order]
        service[r, :m] = np.concatenate(
            [batch.service[r], np.zeros(n)])[order]
        t_up[r, :m] = np.concatenate([np.zeros(J), fup[r, :n]])[order]
        is_fail[r, :m] = kind[order].astype(np.int32)
        job_pos[r] = np.flatnonzero(is_fail[r, :m] == 0)
    return MergedStream(t=t, cls=cls, need=need, service=service, t_up=t_up,
                        is_fail=is_fail, job_pos=job_pos)


def drain_observables(fb: FailureBatch, batch: BatchTrace,
                      response: np.ndarray) -> dict:
    """Failure observables of a drain-mode run, shared across engines.

    Drain never preempts, so kills/requeues are identically zero;
    availability is integrated up to each replication's last completion.
    One host-side float expression keeps the observable bit-identical
    across the registry.
    """
    horizon = (batch.arrival + response).max(axis=1)
    R = batch.reps
    return dict(kills=np.zeros(R, dtype=np.int64),
                requeues=np.zeros(R, dtype=np.int64),
                availability=fb.availability(horizon))


def require_drain(failures: FailureBatch, engine: str) -> None:
    """Scan cores implement drain semantics only; kill-and-requeue needs
    the python event oracle (dynamic repartition breaks static scan
    shapes)."""
    if failures.mode != "drain":
        raise NotImplementedError(
            f"failure mode {failures.mode!r} is only supported by the "
            f"python engine; the {engine!r} scan cores implement "
            f"mode='drain'")
