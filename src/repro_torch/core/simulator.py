"""Event-driven simulator for the multiserver-job model: the port's
``engine="python"``.

The port's own copy of the reference's ``repro.core.simulator``: plain
Python, ``heapq`` and numpy float64 on the host, statement for statement
as in the reference, so that every result equals the reference's bit for
bit (rtol=0).  That needs the reference's event tuples ``(t, kind, seq,
job, epoch)`` and their ``_ARRIVAL < _DEPARTURE < _FAIL < _REPAIR``
tie-break, its set iteration orders (they set the ``seq`` of departure
pushes, so the order of equal-time departures), its stable re-sorts of the
waiting list and its float expressions (``remaining_now``,
``_advance_busy``, ``_result``).  None of the per-event state is moved to
tensors.  On the card's machine this engine is the oracle of the kernels:
it shares no code with them or with their plain versions.

The engine owns time, the event heap and job bookkeeping; a
:class:`~repro_torch.core.policies.base.Policy` decides, at every event,
the set of jobs that should be running.  Preempt-resume semantics: a
preempted job keeps its remaining service time and may be resumed later
(possibly on different servers — the model has no affinity).

Metrics collected per run: mean/percentile response times, mean waiting
time, queueing probability (P[wait > 0]), utilization, and for BSF policies
the empirical P_H.  Response time = completion − arrival.

Fault injection (:mod:`repro_torch.core.failures`) adds breakdown/repair
events:

* ``mode="kill"`` runs here, and only here.  A breakdown shrinks the
  live capacity ``k_live``; jobs on dying servers are *killed-and-requeued*
  (full service restart — the non-preemption trade means no mid-flight
  migration, the semantics of the reference's
  ``sched.elastic.elastic_repartition`` on the gang-scheduler side: gangs
  on dead chips are the only casualties).  The policy hook
  ``on_capacity_change`` picks the victims — BS-π re-runs the eq.-2
  partition (``balanced_partition_for``) on every capacity change and
  kills the gangs whose block shrank away; policies without the hook get
  the engine default (most recently started first).  A repair restores
  capacity and the next ``select`` reoccupies it.  New observables:
  ``kills``, ``requeues``, and ``availability`` (the time-average of
  ``k_live/k``).

* ``mode="drain"`` is the scan-core contract (never preempts, a breakdown
  claims the earliest-free capacity unit until repair); the python side of
  that contract is implemented by the naive per-replication loops at the
  bottom of this module, which replay the *same* chronologically merged
  event streams as the ``"torch"`` cores
  (:func:`repro_torch.core.failures.merge_failure_stream`) so registry
  parity stays bit-identical (rtol=0).
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import math
from typing import Sequence

import numpy as np

from . import engines
from .policies.base import Policy
from .workload import BatchTrace, Trace, Workload

_ARRIVAL = 0
_DEPARTURE = 1
_FAIL = 2      # capacity loss (kill mode); ties: after departures at t
_REPAIR = 3    # capacity restore

#: free/padding sentinel of the scan-core completion matrices — the drain
#: reference loops share it so comparisons are bit-identical
_BIG = 1e30


class _View:
    """SystemView implementation handed to policies (thin facade)."""

    __slots__ = ("sim",)

    def __init__(self, sim: "Simulation"):
        self.sim = sim

    @property
    def now(self) -> float:
        return self.sim.now

    @property
    def k(self) -> int:
        # live capacity: every capacity-driven policy (greedy_pack, the
        # serverfilling family, ...) degrades automatically under kill-mode
        # fault injection
        return self.sim.k_live

    def queue(self) -> Sequence[int]:
        return self.sim.waiting

    def running(self) -> frozenset:
        return frozenset(self.sim.running)

    def free(self) -> int:
        return self.sim.free

    def need(self, j: int) -> int:
        return int(self.sim.trace.need[j])

    def cls(self, j: int) -> int:
        return int(self.sim.trace.cls[j])

    def arrival(self, j: int) -> float:
        return float(self.sim.trace.arrival[j])

    def remaining(self, j: int) -> float:
        return self.sim.remaining_now(j)

    def num_classes(self) -> int:
        # the workload's C when the trace carries it — a short trace that
        # never samples the last class must not shrink the class space
        return self.sim.trace.num_classes


@dataclasses.dataclass
class SimResult:
    policy: str
    num_jobs: int
    mean_response: float
    mean_wait: float
    p_wait: float                  # queueing probability P[wait > eps]
    p_helper: float | None         # BSF only
    mean_response_by_class: np.ndarray
    p95_response: float
    utilization: float             # busy server-time / (k * horizon)
    horizon: float
    # kill-mode fault-injection observables (defaults without failures)
    kills: int = 0                 # jobs killed mid-service
    requeues: int = 0              # killed jobs requeued (== kills here)
    availability: float | None = None  # time-avg k_live/k over the horizon
    preemptions: int = 0           # preempt-resume events (SRPT family)

    def row(self) -> dict:
        return {
            "policy": self.policy,
            "jobs": self.num_jobs,
            "mean_response": self.mean_response,
            "mean_wait": self.mean_wait,
            "p_wait": self.p_wait,
            "p_helper": self.p_helper,
            "p95_response": self.p95_response,
            "utilization": self.utilization,
        }


class Simulation:
    """One policy, one trace, run to completion of every job.

    ``failures`` (optional) is a list of ``(t_down, t_up, m)`` outages —
    ``m`` servers lost at ``t_down``, restored at ``t_up`` (see
    :meth:`repro_torch.core.failures.FailureBatch.grouped_events`) —
    simulated with kill-and-requeue semantics; see the module docstring.
    """

    def __init__(self, trace: Trace, policy: Policy, *,
                 wait_eps: float = 1e-9, max_events: int | None = None,
                 failures: Sequence[tuple[float, float, int]] | None = None):
        self.trace = trace
        self.policy = policy
        self.k = trace.k
        self.k_live = trace.k
        self.wait_eps = wait_eps
        self.max_events = max_events or 50 * trace.num_jobs + 10_000
        self.failures = list(failures) if failures else []
        self.kills = 0
        self.requeues = 0
        self.preemptions = 0          # policy-driven preempt-resume events
        self.down_time = 0.0          # integral of (k - k_live) dt

        J = trace.num_jobs
        self.now = 0.0
        self.free = self.k
        self.waiting: list[int] = []
        self.running: set[int] = set()
        self.remaining = trace.service.astype(np.float64).copy()
        self.run_start = np.zeros(J)          # start of current service burst
        self.start_time = np.full(J, -1.0)    # first time the job ran
        self.completion = np.full(J, np.nan)
        self.epoch = np.zeros(J, dtype=np.int64)  # invalidates stale departures
        self.busy_time = 0.0                  # integral of busy servers dt
        self._last_t = 0.0
        self._events: list[tuple[float, int, int, int, int]] = []
        # (time, kind, seq, job, epoch) — kind breaks ties arrival-first
        self._seq = 0
        self.view = _View(self)

    # -- engine ----------------------------------------------------------------

    def _push(self, t: float, kind: int, job: int, epoch: int) -> None:
        self._seq += 1
        heapq.heappush(self._events, (t, kind, self._seq, job, epoch))

    def remaining_now(self, j: int) -> float:
        if j in self.running:
            return max(0.0, self.remaining[j] - (self.now - self.run_start[j]))
        return self.remaining[j]

    def _advance_busy(self) -> None:
        dt = self.now - self._last_t
        self.busy_time += (self.k_live - self.free) * dt
        self.down_time += (self.k - self.k_live) * dt
        self._last_t = self.now

    def run(self) -> SimResult:
        tr, pol = self.trace, self.policy
        pol.reset(self.view)
        for j in range(tr.num_jobs):
            self._push(tr.arrival[j], _ARRIVAL, j, 0)
        for t_down, t_up, m in self.failures:
            # the m field rides in the job slot (no job is involved)
            self._push(t_down, _FAIL, m, 0)
            self._push(t_up, _REPAIR, m, 0)

        n_events = 0
        while self._events:
            t, kind, _, j, ep = heapq.heappop(self._events)
            if kind == _DEPARTURE and ep != self.epoch[j]:
                continue  # stale (job was preempted since this was scheduled)
            n_events += 1
            if n_events > self.max_events:
                raise RuntimeError(
                    f"event budget exceeded ({self.max_events}) — "
                    f"policy {pol.name} likely unstable on this trace")
            self.now = t
            self._advance_busy()

            if kind == _ARRIVAL:
                self.waiting.append(j)
                pol.on_arrival(self.view, j)
            elif kind == _DEPARTURE:
                # complete job j
                self.running.discard(j)
                self.free += int(tr.need[j])
                self.remaining[j] = 0.0
                self.completion[j] = t
                pol.on_departure(self.view, j)
            elif kind == _FAIL:
                self.k_live -= j           # j carries m servers lost
                self.free -= j
                self._capacity_change(pol)
            else:  # _REPAIR
                self.k_live += j
                self.free += j
                self._capacity_change(pol)

            self._reconcile(pol)

        return self._result()

    def _capacity_change(self, pol: Policy) -> None:
        """Kill-and-requeue after a breakdown (or reoccupy after repair).

        The policy may name the victims (BS-π re-runs eq. 2 and reports
        the gangs whose block shrank away — ``elastic_repartition``'s
        survivorship rules); the engine default kills the most recently
        started jobs until the survivors fit in ``k_live``.  A killed job
        loses all progress (full service restart, non-preemption trade)
        and is requeued.
        """
        victims = pol.on_capacity_change(self.view, self.k_live)
        if victims is None:
            victims = []
            if self.free < 0:
                over = -self.free
                order = sorted(self.running,
                               key=lambda x: (self.run_start[x], x),
                               reverse=True)
                for x in order:
                    if over <= 0:
                        break
                    victims.append(x)
                    over -= int(self.trace.need[x])
        for x in victims:
            self._kill(x, pol)
        if self.free < 0:
            raise AssertionError(
                f"policy {pol.name} left {-self.free} more servers in use "
                f"than the live capacity k_live={self.k_live}")

    def _kill(self, j: int, pol: Policy) -> None:
        if j not in self.running:  # pragma: no cover - victims run by def.
            raise AssertionError(f"kill victim {j} is not running")
        self.running.discard(j)
        self.free += int(self.trace.need[j])
        self.remaining[j] = float(self.trace.service[j])  # full restart
        self.epoch[j] += 1                                # void its departure
        self.waiting.append(j)
        self.waiting.sort(key=lambda x: self.trace.arrival[x])
        self.kills += 1
        self.requeues += 1
        pol.on_kill(self.view, j)

    def _reconcile(self, pol: Policy) -> None:
        desired = set(pol.select(self.view))
        # sanity: capacity
        need_sum = sum(int(self.trace.need[j]) for j in desired)
        if need_sum > self.k_live:
            raise AssertionError(
                f"policy {pol.name} selected {need_sum} > k_live="
                f"{self.k_live} servers")
        # preemptions
        preempted = self.running - desired
        for j in preempted:
            if not pol.preemptive:
                raise AssertionError(
                    f"nonpreemptive policy {pol.name} tried to preempt job {j}")
            self.remaining[j] = self.remaining_now(j)
            self.epoch[j] += 1
            self.running.discard(j)
            self.free += int(self.trace.need[j])
            self.waiting.append(j)
        if preempted:
            self.preemptions += len(preempted)
            self.waiting.sort(key=lambda x: self.trace.arrival[x])
        # starts
        for j in desired - self.running:
            if not math.isnan(self.completion[j]):
                raise AssertionError(f"policy restarted finished job {j}")
            try:
                self.waiting.remove(j)
            except ValueError:
                raise AssertionError(
                    f"policy {pol.name} selected job {j} that is not waiting")
            self.running.add(j)
            self.free -= int(self.trace.need[j])
            self.run_start[j] = self.now
            if self.start_time[j] < 0:
                self.start_time[j] = self.now
            self.epoch[j] += 1
            self._push(self.now + self.remaining[j], _DEPARTURE, j,
                       int(self.epoch[j]))
        if self.free < 0:  # pragma: no cover
            raise AssertionError("negative free servers — engine bug")

    # -- metrics -----------------------------------------------------------------

    def _result(self) -> SimResult:
        tr = self.trace
        resp = self.completion - tr.arrival
        assert not np.isnan(resp).any(), "some jobs never completed"
        wait = self.start_time - tr.arrival
        C = tr.num_classes
        by_class = np.array([
            resp[tr.cls == c].mean() if (tr.cls == c).any() else np.nan
            for c in range(C)
        ])
        p_helper = getattr(self.policy, "p_helper_estimate", None)
        horizon = float(self.now)
        util = self.busy_time / (self.k * horizon) if horizon > 0 else 0.0
        avail = None
        if self.failures:
            avail = 1.0 - self.down_time / (self.k * horizon) \
                if horizon > 0 else 1.0
        return SimResult(
            policy=self.policy.name,
            num_jobs=tr.num_jobs,
            mean_response=float(resp.mean()),
            mean_wait=float(wait.mean()),
            p_wait=float((wait > self.wait_eps).mean()),
            p_helper=p_helper,
            mean_response_by_class=by_class,
            p95_response=float(np.percentile(resp, 95)),
            utilization=float(util),
            horizon=horizon,
            kills=self.kills,
            requeues=self.requeues,
            availability=avail,
            preemptions=self.preemptions,
        )


def simulate(wl: Workload, policy: Policy, num_jobs: int = 100_000,
             seed: int = 0, **kw) -> SimResult:
    """Sample a trace from the workload and run one simulation."""
    trace = wl.sample_trace(num_jobs, seed=seed)
    return Simulation(trace, policy, **kw).run()


def simulate_trace(trace: Trace, policy: Policy, **kw) -> SimResult:
    return Simulation(trace, policy, **kw).run()


# --------------------------------------------------------------------------
# Drain-mode reference loops (engine="python" under fault injection).
#
# Naive, readable per-replication event loops implementing the drain
# contract of core/failures.py: a breakdown claims the earliest-free
# capacity unit of its target block until t_up, never preempting.  They
# consume the SAME host-built merged event streams as the torch cores
# (failures.merge_failure_stream / partition_targets), so the event
# chronology — including every tie-break — is shared by construction and
# the registry parity tests can demand rtol=0.  Multiset invariant: the
# loops re-sort W each event where the scans keep a sorted roll-and-insert
# carry; the resulting float ops (max of identical operands, identical
# additions) are bit-equal.
# --------------------------------------------------------------------------


def _drain_fcfs_rep(t, n, svc, t_up, is_fail, k):
    """FCFS Kiefer–Wolfowitz recursion over one merged stream.

    Returns per-job start times in arrival order (merged arrival rows are
    job-ordered).  Failure rows drain ``W[0] := max(W[0], t_up)``; padding
    rows are failures with ``t_up = 0`` — the identity.
    """
    W = np.zeros(k)
    t_prev = 0.0
    starts = []
    for i in range(len(t)):
        W.sort()
        if is_fail[i]:
            W[0] = max(W[0], t_up[i])
        else:
            start = max(max(t[i], t_prev), W[n[i] - 1])
            W[:n[i]] = start + svc[i]
            t_prev = start
            starts.append(start)
    return np.array(starts)


def _drain_modbs_rep(t, c, n, svc, t_up, is_fail, slots, s_max, h, C):
    """ModBS-FCFS over one merged stream (loss rows + helper KW vector).

    Failure targets: class ``c < C`` extends the argmin completion entry
    of row c to ``t_up`` (a free slot holds a time <= t, so argmin is the
    earliest-free unit either way); ``c == C`` drains the helper W.
    """
    comp = np.where(np.arange(s_max)[None, :] >= slots[:, None], _BIG, 0.0)
    W = np.zeros(h)
    t_prev = 0.0
    starts, blocked_out = [], []
    for i in range(len(t)):
        if is_fail[i]:
            if c[i] == C:
                W.sort()
                W[0] = max(W[0], t_up[i])
            else:
                row = comp[c[i]]
                s = row.argmin()
                row[s] = max(row[s], t_up[i])
            continue
        row = comp[c[i]]
        blocked = (row > t[i]).sum() >= s_max
        if blocked:
            W.sort()
            start = max(max(t[i], t_prev), W[n[i] - 1])
            W[:n[i]] = start + svc[i]
            t_prev = start
        else:
            row[row.argmin()] = t[i] + svc[i]
            start = t[i]
        starts.append(start)
        blocked_out.append(blocked)
    return np.array(starts), np.array(blocked_out, dtype=bool)


def _drain_bs_rep(arrival, cls_, need, service, slots, h, ft, ftgt, fup, C):
    """BS-FCFS (Definition 1) event loop with drain-mode failures.

    Replays the exact event semantics of ``bs_fail_scan_fwd``: per
    step the earliest of (next arrival, earliest A completion, helper-head
    FCFS start, next failure) wins, failures winning ties.  A class-block
    failure occupies a free slot until ``t_up`` (its repair then fires as
    an ordinary A completion, rule-3 pull included) or extends the argmin
    entry when fully busy; helper failures drain W.
    """
    J = len(arrival)
    E = len(ft)
    s_max = max(1, int(slots.max()))
    comp = np.full((C, s_max), _BIG)     # all-empty, free counter gates use
    free = np.asarray(slots, dtype=np.int64).copy()
    queues: list[list[int]] = [[] for _ in range(C)]
    W = np.zeros(h)
    t_prev = 0.0
    t_hol = 0.0
    ai = 0
    fi = 0
    start = np.zeros(J)
    served_h = np.zeros(J, dtype=bool)
    routed = np.zeros(J, dtype=bool)
    INF = np.inf
    while ai < J or any(queues) or (comp < 0.5 * _BIG).any():
        Ta = arrival[ai] if ai < J else INF
        flat = int(comp.argmin())
        Tc = comp.flat[flat]
        heads = [q[0] for q in queues if q]
        gh = min(heads) if heads else None
        if gh is not None:
            W.sort()
            Th = max(arrival[gh], t_hol, t_prev, W[need[gh] - 1])
        else:
            Th = INF
        Tf = ft[fi] if fi < E else INF
        if Tf <= Ta and Tf <= Tc and Tf <= Th and Tf < INF:
            c, tu = int(ftgt[fi]), fup[fi]
            fi += 1
            if c == C:
                W.sort()
                W[0] = max(W[0], tu)
            elif free[c] > 0:
                free[c] -= 1
                row = comp[c]
                row[row.argmax()] = tu        # occupy an empty (_BIG) slot
            else:
                row = comp[c]
                s = row.argmin()
                row[s] = max(row[s], tu)
        elif Th <= Tc and Th <= Ta:           # helper commit (wins ties)
            c = int(cls_[gh])
            queues[c].pop(0)
            W.sort()
            W[:need[gh]] = Th + service[gh]
            t_prev = Th
            start[gh] = Th
            served_h[gh] = True
        elif Tc < Ta and Tc < 0.5 * _BIG:     # A completion (+ rule-3 pull)
            c = flat // s_max
            if queues[c]:
                p = queues[c].pop(0)
                if p == gh:                   # head-of-line pull-back
                    t_hol = max(t_hol, Tc)
                comp.flat[flat] = Tc + service[p]
                start[p] = Tc
            else:
                comp.flat[flat] = _BIG
                free[c] += 1
        elif ai < J:                          # arrival (rule 1)
            j = ai
            ai += 1
            c = int(cls_[j])
            if free[c] > 0:
                free[c] -= 1
                row = comp[c]
                row[row.argmax()] = arrival[j] + service[j]
                start[j] = arrival[j]
            else:
                routed[j] = True
                queues[c].append(j)
        else:                                 # only repairs-in-flight left
            break
    return start, served_h, routed


# --------------------------------------------------------------------------
# engine="python" registry cores.
#
# The exact event-driven engine behind the same batched interface as the
# scan/kernel substrates: one Simulation per replication, per-job arrays
# assembled into a BatchSimResult with the identical float ops as the fast
# engines (response = (start + service) - arrival inside the engine's
# departure push), so registry parity tests can demand rtol=0.
# --------------------------------------------------------------------------

#: canonical registry policy name (== Policy.name) -> make_policy short name
_PYTHON_POLICIES = {
    "fcfs": "fcfs", "modbs-fcfs": "modbs", "bs-fcfs": "bs",
    "serverfilling": "serverfilling", "sf-srpt": "sf-srpt",
    "sf-gittins": "sf-gittins", "ff-srpt": "ff-srpt", "msf": "msf",
    "lsf": "lsf", "backfill": "backfill", "maxweight": "maxweight",
}

#: policies that cannot build without a workload (eq.-2 partition / ranks)
_NEEDS_WORKLOAD = {"modbs-fcfs", "bs-fcfs", "sf-gittins"}


def _make_python_policy(canon: str, partition, wl):
    """Policy instance for one replication, honoring an explicit partition
    exactly like the scan cores' ``_partition_args`` does."""
    from .policies import (BalancedSplitting, ModifiedBalancedSplitting,
                          make_policy)
    if canon in ("bs-fcfs", "modbs-fcfs") and partition is not None:
        pol_cls = BalancedSplitting if canon == "bs-fcfs" \
            else ModifiedBalancedSplitting
        # demands ride along when available so kill-mode capacity changes
        # can re-run the eq.-2 split (on_capacity_change)
        return pol_cls(partition, aux="fcfs",
                       demands=wl.demands if wl is not None else None)
    if canon in _NEEDS_WORKLOAD and wl is None:
        raise ValueError(f"policy {canon!r} needs a workload (wl=...) "
                         f"or a partition")
    return make_policy(_PYTHON_POLICIES[canon], wl=wl)


def _drain_python(canon: str, batch: BatchTrace, partition, wl, fb):
    """Drain-mode fault injection on engine="python".

    Dispatches to the per-replication reference loops above, feeding them
    the same merged event streams the scan cores consume (see the section
    comment); only the three registry-pinned policies implement the drain
    contract.
    """
    from . import failures as flr
    from .partition import balanced_partition
    from .sim_batch import (_bs_fail_args, _fcfs_result, _modbs_result,
                            _partition_args, _with_drain_obs, BatchSimResult)
    R = batch.reps
    if canon == "fcfs":
        ms = flr.merge_failure_stream(batch, *flr.fcfs_targets(fb),
                                      pad_cls=0)
        starts = np.stack([
            _drain_fcfs_rep(ms.t[r], ms.need[r], ms.service[r], ms.t_up[r],
                            ms.is_fail[r], batch.k) for r in range(R)])
        return _with_drain_obs(_fcfs_result(batch, starts), batch, fb)
    if canon == "modbs-fcfs":
        slots, s_max, h = _partition_args(batch, partition, wl)
        part = partition if partition is not None else balanced_partition(wl)
        C = len(part.a)
        ft, ftgt, fup, count = flr.partition_targets(fb, part)
        ms = flr.merge_failure_stream(batch, ft, ftgt, fup, count,
                                      pad_cls=C)
        outs = [_drain_modbs_rep(ms.t[r], ms.cls[r], ms.need[r],
                                 ms.service[r], ms.t_up[r], ms.is_fail[r],
                                 slots, s_max, h, C) for r in range(R)]
        starts = np.stack([o[0] for o in outs])
        blocked = np.stack([o[1] for o in outs])
        return _with_drain_obs(_modbs_result(batch, blocked, starts),
                               batch, fb)
    if canon == "bs-fcfs":
        slots, s_max, h = _partition_args(batch, partition, wl)
        ft, ftgt, fup, _ = _bs_fail_args(batch, fb, partition, wl)
        C = len(slots)
        outs = [_drain_bs_rep(batch.arrival[r], batch.cls[r], batch.need[r],
                              batch.service[r], slots, h, ft[r], ftgt[r],
                              fup[r], C) for r in range(R)]
        starts = np.stack([o[0] for o in outs])
        served = np.stack([o[1] for o in outs])
        routed = np.stack([o[2] for o in outs])
        res = BatchSimResult(
            response=starts + batch.service - batch.arrival,
            wait=starts - batch.arrival,
            p_helper=served.mean(axis=1), blocked=None,
            p_routed=routed.mean(axis=1), start=starts)
        return _with_drain_obs(res, batch, fb)
    raise NotImplementedError(
        f"drain-mode fault injection is not implemented for policy "
        f"{canon!r} on engine='python' (use mode='kill' — the event "
        f"engine supports it for every policy)")


def _python_core(canon: str, batch: BatchTrace, *, partition=None, wl=None,
                 queue_cap=None, failures=None, **kw):
    """Run each replication through the event engine; batch the metrics.

    ``queue_cap`` is accepted for interface parity with the bs-fcfs scan
    cores and ignored: the event engine has no fixed-capacity ring
    buffers.  ``blocked`` is populated for ModifiedBS (the per-job
    irrevocable-routing mask, matching the scan cores); the BS/fcfs cores
    return ``blocked=None`` on every engine.

    ``failures`` (a :class:`repro_torch.core.failures.FailureBatch`)
    selects the fault-injection path: ``mode="drain"`` runs the
    scan-parity loops above, ``mode="kill"`` runs the full event engine
    with breakdown/repair events, kill-and-requeue, and per-replication
    kill/requeue/availability observables.  A ``"python"`` core takes no
    ``device``: it runs on the host whatever the caller's device.
    """
    from .sim_batch import BatchSimResult
    if failures is not None:
        if failures.k != batch.k:
            raise ValueError(f"failures sampled for k={failures.k} but "
                             f"batch has k={batch.k}")
        if failures.reps != batch.reps:
            raise ValueError(f"failures have {failures.reps} replications "
                             f"but batch has {batch.reps}")
        if failures.mode == "drain":
            return _drain_python(canon, batch, partition, wl, failures)
    R, J = batch.reps, batch.num_jobs
    resp = np.empty((R, J))
    wait = np.empty((R, J))
    start = np.empty((R, J))
    p_helper = np.empty(R)
    p_routed = np.empty(R)
    blocked = np.zeros((R, J), bool) if canon == "modbs-fcfs" else None
    kills = np.zeros(R, np.int64) if failures is not None else None
    requeues = np.zeros(R, np.int64) if failures is not None else None
    avail = np.ones(R) if failures is not None else None
    preempt = None                 # allocated on first preemptive policy
    has_helper = False
    for r in range(R):
        trace = batch.rep(r)
        pol = _make_python_policy(canon, partition, wl)
        if pol.preemptive and preempt is None:
            preempt = np.zeros(R, np.int64)
        if failures is not None:
            kw["failures"] = failures.grouped_events(r)
        sim = Simulation(trace, pol, **kw)
        sres = sim.run()
        resp[r] = sim.completion - trace.arrival
        start[r] = sim.start_time
        wait[r] = sim.start_time - trace.arrival
        if preempt is not None:
            preempt[r] = sres.preemptions
        if failures is not None:
            kills[r] = sres.kills
            requeues[r] = sres.requeues
            avail[r] = sres.availability
        if blocked is not None:
            blocked[r, sorted(pol.routed_jobs)] = True
        ph = getattr(pol, "p_helper_estimate", None)
        if ph is not None:
            has_helper = True
            p_helper[r] = ph
            p_routed[r] = getattr(pol, "p_routed_estimate", ph)
    return BatchSimResult(response=resp, wait=wait,
                          p_helper=p_helper if has_helper else None,
                          blocked=blocked,
                          p_routed=p_routed if has_helper else None,
                          start=start, kills=kills, requeues=requeues,
                          availability=avail, preemptions=preempt)


for _canon in _PYTHON_POLICIES:
    engines.register(_canon, "python")(functools.partial(_python_core,
                                                         _canon))
