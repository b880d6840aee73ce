"""ServerFilling and ServerFilling-SRPT / -Gittins (paper §2; [21], [3]).

ServerFilling: take the minimal *prefix in arrival order* M whose total
server need reaches k; if no such prefix exists, serve everything.  Otherwise
place the jobs of M in decreasing order of server need (ties by arrival)
until no more fit.  Preemptive, size-oblivious.

ServerFilling-SRPT: identical except candidates are ordered by increasing
remaining *size* (= remaining service time × server need) when forming the
prefix, and placement prioritizes largest server need, breaking ties by
smallest remaining size.  Preemptive, size-aware.

ServerFilling-Gittins: with exponential service times the Gittins rank of a
class-i job is constant in age and ordering by rank coincides with ordering
by expected remaining size; we implement the rank for the distributions we
ship (exponential: d_i·n_i expected remaining size ordering; deterministic:
equivalent to SRPT, see paper).
"""

from __future__ import annotations

from .base import Policy, SystemView


def _fill(view: SystemView, candidates: list[int], place_key) -> list[int]:
    """Order ``candidates`` by ``place_key`` and first-fit pack into k."""
    candidates = sorted(candidates, key=place_key)
    out, free = [], view.k
    for j in candidates:
        n = view.need(j)
        if n <= free:
            out.append(j)
            free -= n
        if free == 0:
            break
    return out


class ServerFilling(Policy):
    name = "serverfilling"
    preemptive = True
    size_aware = False

    def _ordered(self, view: SystemView) -> list[int]:
        """All jobs in system, in arrival order."""
        jobs = list(view.running()) + list(view.queue())
        jobs.sort(key=view.arrival)
        return jobs

    def select(self, view: SystemView):
        jobs = self._ordered(view)
        total, m = 0, None
        for idx, j in enumerate(jobs):
            total += view.need(j)
            if total >= view.k:
                m = idx + 1
                break
        if m is None:
            return jobs  # everything fits-ish: serve all jobs present
        M = jobs[:m]
        # place largest need first, ties by arrival order
        return _fill(view, M, lambda j: (-view.need(j), view.arrival(j)))


class ServerFillingSRPT(ServerFilling):
    name = "sf-srpt"
    preemptive = True
    size_aware = True

    def _rank(self, view: SystemView, j: int) -> float:
        return view.remaining(j) * view.need(j)  # remaining *size*

    def _ordered(self, view: SystemView) -> list[int]:
        jobs = list(view.running()) + list(view.queue())
        jobs.sort(key=lambda j: (self._rank(view, j), view.arrival(j)))
        return jobs

    def select(self, view: SystemView):
        jobs = self._ordered(view)
        total, m = 0, None
        for idx, j in enumerate(jobs):
            total += view.need(j)
            if total >= view.k:
                m = idx + 1
                break
        if m is None:
            return jobs
        M = jobs[:m]
        # largest server need first, ties by smallest remaining size
        return _fill(view, M,
                     lambda j: (-view.need(j), self._rank(view, j)))


class ServerFillingGittins(ServerFillingSRPT):
    """Size-oblivious variant: rank = E[remaining size | class].

    For exponential D_i the Gittins rank of class i is constant and ordering
    by it equals ordering by d_i·n_i (memorylessness); for deterministic D_i
    it reduces to SRPT.  We expose the exponential-case rank, which is what
    the paper's experiments need.
    """

    name = "sf-gittins"
    preemptive = True
    size_aware = False  # uses only class information

    def __init__(self, class_mean_sizes):
        # class_mean_sizes[i] = d_i * n_i
        self._rank_by_class = list(class_mean_sizes)

    def _rank(self, view: SystemView, j: int) -> float:
        return self._rank_by_class[view.cls(j)]
