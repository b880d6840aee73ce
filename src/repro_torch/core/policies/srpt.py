"""First-Fit SRPT (paper §2) — preemptive, size-aware.

Serve the jobs with the least *remaining processing time*, regardless of
their server needs; skip jobs that do not fit and keep walking the list
until servers are full or the list is exhausted.
"""

from __future__ import annotations

from .base import Policy, SystemView


class FirstFitSRPT(Policy):
    name = "ff-srpt"
    preemptive = True
    size_aware = True

    def select(self, view: SystemView):
        jobs = list(view.running()) + list(view.queue())
        jobs.sort(key=lambda j: (view.remaining(j), view.arrival(j)))
        out, free = [], view.k
        for j in jobs:
            n = view.need(j)
            if n <= free:
                out.append(j)
                free -= n
            if free == 0:
                break
        return out
