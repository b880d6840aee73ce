"""GangScheduler — BS-π (Definition 1) driving gang placement on a fleet.

The port's copy of ``repro/sched/gang.py``: ``GangJob``,
``GangScheduler`` and the virtual-time driver ``simulate_gangs``.

Event-driven (simulated or wall-clock time): gangs arrive, get a slot in
their class slice if one is idle, otherwise queue on the helper block under
the auxiliary policy π (FCFS / backfill).  On a slice completion the oldest
waiting gang of that class is pulled back from the helper queue (Def. 1
rule 3).  Nonpreemptive and size-oblivious throughout: a placed gang is
never migrated — preempting a multi-chip gang means draining device state,
which is exactly the cost the paper's design avoids.

The scheduler is deliberately runtime-agnostic: ``place``/``complete`` are
callbacks, so the same logic drives the serving engine (prefill and
decode on the slot's chips) and a simulator in virtual time.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Callable

from .cluster import BalancedMeshPartition


@dataclasses.dataclass
class GangJob:
    jid: int
    cls: int                  # class index
    need: int                 # chips
    arrival: float
    service: float            # duration (used by the simulator driver)
    start: float | None = None
    finish: float | None = None
    placement: tuple | None = None   # ("class", slot) | ("helper", offset)

    @property
    def waited(self) -> float:
        return (self.start - self.arrival) if self.start is not None else 0.0


class GangScheduler:
    """BS-π over a BalancedMeshPartition."""

    def __init__(self, partition: BalancedMeshPartition, aux: str = "fcfs",
                 on_place: Callable[[GangJob], None] | None = None,
                 on_finish: Callable[[GangJob], None] | None = None):
        if aux not in ("fcfs", "backfill"):
            raise ValueError(f"unknown auxiliary policy {aux!r}")
        self.partition = partition
        self.aux = aux
        self.on_place = on_place or (lambda j: None)
        self.on_finish = on_finish or (lambda j: None)
        self.free_slots: list[list[int]] = [
            list(range(s.slots)) for s in partition.slices]
        self.helper_free = partition.helper.size
        self.helper_used: dict[int, tuple[int, int]] = {}  # jid -> (off, n)
        self.helper_wait: deque[GangJob] = deque()
        self.running: dict[int, GangJob] = {}
        self._helper_map = [False] * partition.helper.size
        self.n_arrivals = 0
        self.n_helper_served = 0
        self.completed: list[GangJob] = []

    # -- placement ----------------------------------------------------------

    def _helper_alloc(self, n: int) -> int | None:
        """First-fit contiguous chips in the helper block."""
        run = 0
        for i, used in enumerate(self._helper_map):
            run = 0 if used else run + 1
            if run == n:
                start = i - n + 1
                for j in range(start, start + n):
                    self._helper_map[j] = True
                self.helper_free -= n
                return start
        return None

    def _helper_release(self, off: int, n: int) -> None:
        for j in range(off, off + n):
            self._helper_map[j] = False
        self.helper_free += n

    def _start(self, job: GangJob, placement: tuple, now: float) -> None:
        job.start = now
        job.placement = placement
        self.running[job.jid] = job
        self.on_place(job)

    def _helper_schedule(self, now: float) -> None:
        """Run π over the helper queue."""
        if self.aux == "fcfs":
            while self.helper_wait:
                j = self.helper_wait[0]
                off = self._helper_alloc(j.need)
                if off is None:
                    break                      # head-of-line blocking
                self.helper_wait.popleft()
                self.helper_used[j.jid] = (off, j.need)
                self.n_helper_served += 1
                self._start(j, ("helper", off), now)
        else:                                   # backfill: first fit
            remaining = deque()
            while self.helper_wait:
                j = self.helper_wait.popleft()
                off = self._helper_alloc(j.need)
                if off is None:
                    remaining.append(j)
                else:
                    self.helper_used[j.jid] = (off, j.need)
                    self.n_helper_served += 1
                    self._start(j, ("helper", off), now)
            self.helper_wait = remaining

    # -- BS-π events ---------------------------------------------------------

    def arrive(self, job: GangJob, now: float) -> None:
        self.n_arrivals += 1
        if self.free_slots[job.cls]:
            slot = self.free_slots[job.cls].pop(0)
            self._start(job, ("class", slot), now)
        else:
            self.helper_wait.append(job)
            self._helper_schedule(now)

    def complete(self, jid: int, now: float) -> None:
        job = self.running.pop(jid)
        job.finish = now
        self.completed.append(job)
        self.on_finish(job)
        kind = job.placement[0]
        if kind == "class":
            slot = job.placement[1]
            # Def. 1 rule 3: pull back the oldest same-class waiting gang
            pulled = None
            for w in self.helper_wait:
                if w.cls == job.cls:
                    pulled = w
                    break
            if pulled is not None:
                self.helper_wait.remove(pulled)
                self._start(pulled, ("class", slot), now)
            else:
                self.free_slots[job.cls].append(slot)
        else:
            off, n = self.helper_used.pop(jid)
            self._helper_release(off, n)
            self._helper_schedule(now)

    # -- observables ---------------------------------------------------------

    @property
    def p_helper(self) -> float:
        """Empirical P_H — fraction of gangs that ran on helper chips."""
        return self.n_helper_served / max(self.n_arrivals, 1)

    def utilization_snapshot(self) -> dict:
        busy_class = sum(
            (s.slots - len(f)) * s.need
            for s, f in zip(self.partition.slices, self.free_slots))
        busy_help = self.partition.helper.size - self.helper_free
        return {"class_chips_busy": busy_class,
                "helper_chips_busy": busy_help,
                "queued": len(self.helper_wait)}


def simulate_gangs(partition: BalancedMeshPartition, jobs: list[GangJob],
                   aux: str = "fcfs") -> GangScheduler:
    """Drive the scheduler with a job trace in virtual time."""
    sched = GangScheduler(partition, aux=aux)
    heap: list[tuple[float, int, int, str]] = []
    seq = itertools.count()
    for j in jobs:
        heapq.heappush(heap, (j.arrival, next(seq), j.jid, "arrive"))
    by_id = {j.jid: j for j in jobs}

    def on_place(job: GangJob):
        heapq.heappush(heap, (job.start + job.service, next(seq),
                              job.jid, "finish"))

    sched.on_place = on_place
    while heap:
        t, _, jid, kind = heapq.heappop(heap)
        if kind == "arrive":
            sched.arrive(by_id[jid], t)
        else:
            sched.complete(jid, t)
    return sched
