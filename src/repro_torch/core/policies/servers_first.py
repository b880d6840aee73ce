"""Most-Servers-First (a.k.a. Best-Fit) and Least-Servers-First (paper §2).

Both are preemptive and size-oblivious: at all times, the jobs with the
highest (resp. lowest) server need that can be served are served, greedily.
"""

from __future__ import annotations

from .base import Policy, SystemView


class MostServersFirst(Policy):
    name = "msf"
    preemptive = True
    size_aware = False

    def select(self, view: SystemView):
        jobs = list(view.running()) + list(view.queue())
        # highest need first, FCFS within equal need
        jobs.sort(key=lambda j: (-view.need(j), view.arrival(j)))
        out, free = [], view.k
        for j in jobs:
            n = view.need(j)
            if n <= free:
                out.append(j)
                free -= n
            if free == 0:
                break
        return out


class LeastServersFirst(Policy):
    name = "lsf"
    preemptive = True
    size_aware = False

    def select(self, view: SystemView):
        jobs = list(view.running()) + list(view.queue())
        jobs.sort(key=lambda j: (view.need(j), view.arrival(j)))
        out, free = [], view.k
        for j in jobs:
            n = view.need(j)
            if n <= free:
                out.append(j)
                free -= n
            if free == 0:
                break
        return out
