"""BalancedSplitting-π (Definition 1) and ModifiedBS-π (Definition 2).

The policy owns a :class:`BalancedPartition` and tracks, per class i, the
number of free whole-job *slots* in A_i (a_i/n_i of them).  The helper set H
runs the auxiliary policy π — nonpreemptive, size-oblivious, independent of
the A system.  We ship π ∈ {fcfs, backfill} (strict head-of-line FCFS is the
paper's experimental choice).

Rules (Def. 1):
  1. class-i arrival → A_i if a free slot exists, else the helper set;
  2. helpers process their jobs according to π;
  3. on a class-i completion *in A_i*, pull the oldest class-i job still
     WAITING (not yet started) in the helper set into the freed A_i slot.

ModifiedBS-π (Def. 2) drops rule 3: routing to H is irrevocable.  Its A_i
subsystems are then exactly independent M/GI/s_i/s_i loss queues
(Property 1) — the object our tests cross-validate against Erlang-B.
"""

from __future__ import annotations

from ..partition import (BalancedPartition, balanced_partition,
                         balanced_partition_for)
from ..workload import Workload
from .base import Policy, SystemView


class BalancedSplitting(Policy):
    name = "bs"
    preemptive = False
    size_aware = False
    pull_back = True  # Def. 1 rule 3; ModifiedBS-π sets False

    def __init__(self, partition: BalancedPartition, aux: str = "fcfs",
                 demands=None):
        if aux not in ("fcfs", "backfill"):
            raise ValueError(f"unsupported auxiliary policy {aux!r}")
        self.partition = partition
        self._partition0 = partition
        self.aux = aux
        self.demands = None if demands is None else tuple(demands)
        self.name = f"{'bs' if self.pull_back else 'modbs'}-{aux}"
        self._reset_state()

    @classmethod
    def for_workload(cls, wl: Workload, aux: str = "fcfs"):
        return cls(balanced_partition(wl), aux=aux, demands=wl.demands)

    # -- internal state ------------------------------------------------------

    def _reset_state(self):
        self.partition = self._partition0
        self.free_slots = list(self.partition.slots)
        self.helper_free = self.partition.helpers
        self.a_running: set[int] = set()       # jobs running in their A_i
        self.h_running: set[int] = set()       # jobs running on helpers
        self.h_wait: list[int] = []            # helper queue, arrival order
        self.n_routed_helper = 0               # jobs sent to H on arrival
        self.n_served_helper = 0               # jobs that START on H servers
        self.routed_jobs: set[int] = set()     # per-job routing record
        self.n_arrivals = 0

    def reset(self, view: SystemView) -> None:
        self._reset_state()
        if view.k != self.partition.k:
            raise ValueError("partition built for a different k")

    # -- helper-set scheduling (π) -------------------------------------------

    def _helper_schedule(self, view: SystemView) -> None:
        """Start helper jobs per π.  Mutates h_wait/h_running/helper_free."""
        if self.aux == "fcfs":
            while self.h_wait:
                j = self.h_wait[0]
                n = view.need(j)
                if n > self.helper_free:
                    break  # head-of-line blocking
                self.h_wait.pop(0)
                self.h_running.add(j)
                self.n_served_helper += 1
                self.helper_free -= n
        else:  # backfill: first-fit through the whole helper queue
            i = 0
            while i < len(self.h_wait) and self.helper_free > 0:
                j = self.h_wait[i]
                n = view.need(j)
                if n <= self.helper_free:
                    self.h_wait.pop(i)
                    self.h_running.add(j)
                    self.n_served_helper += 1
                    self.helper_free -= n
                else:
                    i += 1

    # -- event hooks -----------------------------------------------------------

    def on_arrival(self, view: SystemView, j: int) -> None:
        i = view.cls(j)
        self.n_arrivals += 1
        if self.free_slots[i] > 0:
            self.free_slots[i] -= 1
            self.a_running.add(j)
        else:
            self.n_routed_helper += 1
            self.routed_jobs.add(j)
            self.h_wait.append(j)
            self._helper_schedule(view)

    def on_departure(self, view: SystemView, j: int) -> None:
        if j in self.a_running:
            self.a_running.discard(j)
            i = view.cls(j)
            self.free_slots[i] += 1
            if self.pull_back:
                # rule 3: oldest class-i job still waiting in the helper set
                for idx, h in enumerate(self.h_wait):
                    if view.cls(h) == i:
                        self.h_wait.pop(idx)
                        self.free_slots[i] -= 1
                        self.a_running.add(h)
                        # The pull-back may have removed the head-of-line job
                        # that was blocking π = FCFS: queued jobs that now fit
                        # must start NOW, not at the next arrival/departure.
                        self._helper_schedule(view)
                        break
        elif j in self.h_running:
            self.h_running.discard(j)
            self.helper_free += view.need(j)
            self._helper_schedule(view)
        else:  # pragma: no cover - engine guarantees this
            raise AssertionError(f"departure of unknown job {j}")

    def select(self, view: SystemView):
        return list(self.a_running) + list(self.h_running)

    # -- kill-mode fault injection (see core.simulator / core.failures) ------

    def on_capacity_change(self, view: SystemView, k_live: int):
        """Re-run the eq.-2 split on the live server count.

        Mirrors the reference's ``sched.elastic.elastic_repartition``: the
        class demands are fixed, the capacity is whatever survives, and every
        block shrinks (or regrows) to its new eq.-2 size.  Jobs running
        beyond the new block sizes are killed youngest-arrival-first (the
        non-preemption trade: no checkpointing, a kill is a full restart)
        and re-routed by rule 1 via :meth:`on_kill`.  Raises ValueError
        when ``k_live`` cannot host the largest job — BS-π is undefined
        without a helper set that can (see ``balanced_partition_for``).
        """
        if self.demands is None:
            raise ValueError(
                f"{self.name} cannot repartition on capacity changes "
                f"without class demands (pass demands=... or build via "
                f"for_workload)")
        new = balanced_partition_for(k_live, self.partition.needs,
                                     self.demands)
        victims: list[int] = []
        # class blocks: keep the oldest jobs up to the new slot counts
        by_cls: dict[int, list[int]] = {}
        for j in self.a_running:
            by_cls.setdefault(view.cls(j), []).append(j)
        for i in range(len(new.a)):
            members = sorted(by_cls.get(i, []))
            over = len(members) - new.slots[i]
            if over > 0:
                victims.extend(members[-over:])
        # helper set: evict youngest helper jobs until the rest fit
        h_used = sum(view.need(j) for j in self.h_running)
        for j in sorted(self.h_running, reverse=True):
            if h_used <= new.helpers:
                break
            victims.append(j)
            h_used -= view.need(j)
        for j in victims:
            if j in self.a_running:
                self.a_running.discard(j)
            else:
                self.h_running.discard(j)
        self.partition = new
        used = {i: 0 for i in range(len(new.a))}
        for j in self.a_running:
            used[view.cls(j)] += 1
        self.free_slots = [new.slots[i] - used[i] for i in range(len(new.a))]
        self.helper_free = new.helpers - sum(
            view.need(j) for j in self.h_running)
        # a regrown helper set may unblock the queue head right now
        self._helper_schedule(view)
        return victims

    def on_kill(self, view: SystemView, j: int) -> None:
        """Rule-1 re-route of a killed job (not a new arrival — the
        ``n_arrivals`` denominator of P_H is untouched; a job killed out
        of A_i and re-routed to H does count as routed/served)."""
        i = view.cls(j)
        if self.free_slots[i] > 0:
            self.free_slots[i] -= 1
            self.a_running.add(j)
        else:
            self.n_routed_helper += 1
            self.routed_jobs.add(j)
            self.h_wait.append(j)
            self._helper_schedule(view)

    # -- observables -----------------------------------------------------------

    @property
    def p_helper_estimate(self) -> float:
        """Empirical P_H — fraction of arrivals that USE helper servers.

        This matches the paper's P_H ("needs to use the servers in the helper
        set"): under BS-π a job parked in the helper queue that is pulled
        back into A_i by rule 3 never uses a helper server and so does not
        count.  Under ModifiedBS-π routed == served (irrevocable routing).
        """
        if self.n_arrivals == 0:
            return 0.0
        return self.n_served_helper / self.n_arrivals

    @property
    def p_routed_estimate(self) -> float:
        """Fraction of arrivals that did not find a free A_i slot on arrival."""
        if self.n_arrivals == 0:
            return 0.0
        return self.n_routed_helper / self.n_arrivals


class ModifiedBalancedSplitting(BalancedSplitting):
    """Definition 2 — A→H routing is irrevocable (no rule 3)."""

    pull_back = False
