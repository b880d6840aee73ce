"""FCFS and First-Fit Back-Filling (paper §2)."""

from __future__ import annotations

from .base import Policy, SystemView, greedy_pack


class FCFS(Policy):
    """Strict First-Come First-Served with head-of-line blocking.

    Jobs are processed in order of arrival if enough servers exist, otherwise
    they wait — and *everything behind them waits too* (no skipping).  This is
    the multiserver-job FCFS analyzed in [Wang, Xie, Harchol-Balter 2021].
    """

    name = "fcfs"
    preemptive = False
    size_aware = False

    def select(self, view: SystemView):
        out = list(view.running())
        free = view.k - sum(view.need(j) for j in out)
        for j in view.queue():
            n = view.need(j)
            if n > free:
                break  # head-of-line blocking
            out.append(j)
            free -= n
        return out


class FirstFitBackfill(Policy):
    """As FCFS, but idle servers are back-filled with the first arrived job
    that fits (greedy first-fit over the whole queue).  Nonpreemptive."""

    name = "backfill"
    preemptive = False
    size_aware = False

    def select(self, view: SystemView):
        return greedy_pack(view, view.queue(), view.running())
