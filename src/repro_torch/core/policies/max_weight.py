"""Myopic nonpreemptive MaxWeight (paper §2; Maguluri-Srikant-Ying 2012).

At each event, keep the running jobs and choose additional waiting jobs to
start so as to maximize  Σ_n Q_n x_n  subject to the free-server budget,
where Q_n is the number of waiting jobs with server need n and x_n how many
of them start.  This is a bounded knapsack over the (few) distinct needs —
solved exactly by DP with binary splitting of multiplicities.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .base import Policy, SystemView


def bounded_knapsack(capacity: int, items: list[tuple[int, float, int]]):
    """items = [(weight, value, count)]; returns counts chosen per item.

    Exact DP, O(capacity · Σ log count).  Values are floats.
    """
    # binary splitting -> 0/1 knapsack with provenance
    pieces: list[tuple[int, float, int, int]] = []  # (w, v, item_idx, mult)
    for idx, (w, v, c) in enumerate(items):
        m = 1
        while c > 0:
            take = min(m, c)
            pieces.append((w * take, v * take, idx, take))
            c -= take
            m <<= 1
    dp = np.zeros(capacity + 1)
    choice = [[] for _ in range(capacity + 1)]
    for w, v, idx, mult in pieces:
        if w > capacity:
            continue
        # iterate descending for 0/1 semantics
        for cap in range(capacity, w - 1, -1):
            cand = dp[cap - w] + v
            if cand > dp[cap] + 1e-12:
                dp[cap] = cand
                choice[cap] = choice[cap - w] + [(idx, mult)]
    best_cap = int(np.argmax(dp))
    counts = defaultdict(int)
    for idx, mult in choice[best_cap]:
        counts[idx] += mult
    return counts


class MaxWeight(Policy):
    """Nonpreemptive myopic MaxWeight."""

    name = "maxweight"
    preemptive = False
    size_aware = False

    def select(self, view: SystemView):
        out = list(view.running())
        free = view.k - sum(view.need(j) for j in out)
        if free <= 0:
            return out
        # group waiting jobs by server need
        by_need: dict[int, list[int]] = defaultdict(list)
        for j in view.queue():
            by_need[view.need(j)].append(j)
        if not by_need:
            return out
        items, keys = [], []
        for n, jobs in by_need.items():
            q = len(jobs)
            items.append((n, float(q), q))  # weight n, value Q_n each, count Q_n
            keys.append(n)
        counts = bounded_knapsack(free, items)
        for idx, cnt in counts.items():
            n = keys[idx]
            out.extend(by_need[n][:cnt])  # oldest first within a need
        return out
