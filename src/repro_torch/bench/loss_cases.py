"""Inputs and oracles of the loss-queue checks, shared by ``chip_smoke.py``,
the card tests and the CPU tests.

* :func:`mmss_case` — R independent M/M/s/s traces (Poisson arrivals at
  rate ``lam``, exponential services of mean ``d``) from a numpy seed;
* :func:`ties_case` — a trace of equal arrival times and services from
  four values, so completions coincide with arrivals;
* :func:`loss_oracle` — the event-driven M/GI/s/s sample path on a heap
  of completion times, a server freed at t free for an arrival at t; it
  shares no code with the ``loss_scan`` kernel or its plain version;
* :func:`class_substreams` / :func:`property1_mismatches` — Property 1 as
  a sample-path identity: ModifiedBS-π's blocked mask restricted to class
  c equals the loss queue with ``slots[c]`` servers on class c's arrivals
  (each class row of the ModBS step is ``sim_jax._loss_core`` statement
  for statement, run on the class's own jobs).
"""

from __future__ import annotations

import heapq

import numpy as np


def mmss_case(R: int, J: int, lam: float, d: float = 1.0, seed: int = 0):
    """[R, J] float64 arrival and service arrays of an M/M/s/s queue."""
    rng = np.random.default_rng(seed)
    arrival = np.cumsum(rng.exponential(1.0 / lam, (R, J)), axis=1)
    return arrival, rng.exponential(d, (R, J))


def ties_case(R: int, J: int, group: int = 3):
    """[R, J] arrival times in groups of ``group`` equal values (integer
    steps) and services from {0.5, 1, 2, 3}, so completions fall on
    arrival times."""
    j = np.arange(J)
    arrival = np.broadcast_to((j // group).astype(np.float64), (R, J))
    service = np.array([1.0, 2.0, 0.5, 3.0])[(j[None, :] + np.arange(R)[:, None])
                                             % 4]
    return np.ascontiguousarray(arrival), service


def loss_oracle(arrival, service, s: int) -> np.ndarray:
    """Blocked mask [J] of one M/GI/s/s sample path: the jobs in service
    on a heap of completion times; those done by t leave before a job
    arriving at t looks for a server."""
    comp: list[float] = []
    blocked = np.zeros(len(arrival), dtype=bool)
    for j, (t, svc) in enumerate(zip(arrival, service)):
        while comp and comp[0] <= t:
            heapq.heappop(comp)
        if len(comp) >= s:
            blocked[j] = True
        else:
            heapq.heappush(comp, t + svc)
    return blocked


def class_substreams(batch, c: int):
    """Each replication's class-c jobs as padded [R, L] arrays.

    Returns ``(rows, arrival, service, real)``: ``rows[r]`` the job
    indices of class c in replication r, and the [R, L] arrival and
    service arrays of those jobs, padded at the end to the longest
    substream (a later job cannot change an earlier job's outcome), with
    ``real`` [R, L] marking the jobs that are not padding.
    """
    rows = [np.flatnonzero(batch.cls[r] == c) for r in range(batch.reps)]
    L = max(1, max(len(x) for x in rows))
    a = np.full((batch.reps, L), float(batch.arrival.max()))
    v = np.zeros((batch.reps, L))
    real = np.zeros((batch.reps, L), dtype=bool)
    for r, idx in enumerate(rows):
        a[r, :len(idx)] = batch.arrival[r, idx]
        v[r, :len(idx)] = batch.service[r, idx]
        real[r, :len(idx)] = True
    return rows, a, v, real


def property1_mismatches(batch, blocked, slots, loss_fn) -> list:
    """The (class, replication) pairs where ModifiedBS-π's blocked mask
    [R, J] differs from the loss queue ``loss_fn(arrival, service, s)``
    ([R, L] bool) with ``slots[c]`` servers on class c's substream; a
    class without slots must block every one of its jobs."""
    bad = []
    for c, s in enumerate(slots):
        rows, a, v, real = class_substreams(batch, c)
        loss = None if s == 0 else np.asarray(loss_fn(a, v, int(s)))
        for r, idx in enumerate(rows):
            want = (np.ones(len(idx), dtype=bool) if s == 0
                    else loss[r, real[r]])
            if not np.array_equal(blocked[r, idx], want):
                bad.append((c, r))
    return bad
