"""Chunk-by-chunk runs of the carried msj_scan entries, shared by
``chip_smoke.py``, the card tests and the CPU tests.

Each ``*_chunks`` function runs one carried wrapper (``K.*_stream_fwd``:
the kernel on CUDA tensors, the plain version on CPU ones) or its plain
version (``K.*_stream_ref``, on the tensors' device) over consecutive
chunks of a trace from the empty system, feeding each chunk the carry
the previous one gave out, and returns every chunk's outputs with the
carry it gave out.  :func:`equal_chunks` holds two such runs to each
other with ``torch.equal`` on every tensor: the outputs and the
canonical carry after every chunk.

BS-π runs through the stream driver's own chunk step
(``core.stream._bs_chunk_scan``, then ``_bs_extract``): each chunk scans
the still-queued jobs of earlier chunks plus its own, up to the next
chunk's first arrival.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import sim_torch, stream
from ..core.workload import (BatchTrace, figure1_workload, kit_fh2_workload,
                             sdsc_sp2_workload)
from . import bs_cases

#: workloads of the streamable ``bs_cases.ADVERSARIAL`` cases (``wrap``
#: overflows its ring by design and ``drain_heavy`` has failures: neither
#: streams)
BS_STREAMABLE = {
    "kit512": lambda: kit_fh2_workload(k=512, load=0.85),
    "sdsc": lambda: sdsc_sp2_workload(k=1024, load=0.85),
    "ties": lambda: figure1_workload(256),
}

_F64 = torch.float64


def bounds(J: int, chunk: int) -> list[tuple[int, int]]:
    """[lo, hi) of consecutive ``chunk``-job chunks of J jobs (the last
    ragged)."""
    return [(lo, min(lo + chunk, J)) for lo in range(0, J, chunk)]


def bs_case_batch(name: str, J: int, R: int, seed: int):
    """(batch, workload) of a streamable BS-π adversarial case: its trace
    and the workload whose partition it was built with."""
    case = bs_cases.ADVERSARIAL[name](J, R, seed)
    a, c, n, v = (t.cpu().numpy() for t in case.trace)
    wl = BS_STREAMABLE[name]()
    return BatchTrace.from_arrays(a, c, v, n, wl.k, wl.C), wl


def _cut(x, lo, hi):
    return x[:, lo:hi].contiguous()


def fcfs_chunks(fn, arrival, need, service, k: int, cuts) -> list:
    """``fn`` (``fcfs_stream_fwd`` / ``_ref``) over the chunks ``cuts``:
    each chunk's (starts, W', t_prev')."""
    R, dev = arrival.shape[0], arrival.device
    W = torch.zeros(R, k, dtype=_F64, device=dev)
    t_prev = torch.zeros(R, dtype=_F64, device=dev)
    out = []
    for lo, hi in cuts:
        starts, W, t_prev = fn(_cut(arrival, lo, hi), _cut(need, lo, hi),
                               _cut(service, lo, hi), W, t_prev)
        out.append((starts, W, t_prev))
    return out


def modbs_chunks(fn, arrival, cls, need, service, slots, s_max: int, h: int,
                 cuts) -> list:
    """``fn`` (``modbs_stream_fwd`` / ``_ref``) over the chunks ``cuts``
    from the empty system of ``slots`` [C]: each chunk's (blocked, starts,
    comp', W', t_prev')."""
    carry = sim_torch._modbs_init(slots, s_max, h, arrival.shape[0])
    out = []
    for lo, hi in cuts:
        res = fn(*(_cut(x, lo, hi) for x in (arrival, cls, need, service)),
                 *carry)
        carry = res[2:]
        out.append(res)
    return out


def bs_chunks(fn, batch: BatchTrace, slots, s_max: int, h: int, q_cap: int,
              B: int, cuts, device) -> list:
    """``fn`` (``bs_stream_fwd`` / ``_ref``) over the chunks ``cuts`` of
    ``batch``, with a backlog of at most ``B`` jobs across a boundary:
    each chunk's (carry' tensors..., tagged, rec_t) and the canonical
    state after it (``_bs_extract``'s dict, as the ``"canon"`` entry)."""
    R, J = batch.arrival.shape
    C = int(np.asarray(slots).shape[0])
    scan = stream._bs_device_scan(fn, device, slots, s_max, h, q_cap)
    canon = stream._bs_canon0(R, C, s_max, h, B, slots)
    out = []
    for lo, hi in cuts:
        horizon = (batch.arrival[:, hi].copy() if hi < J
                   else np.full(R, np.inf))
        (carry_out, tagged, times), rec, idmap = stream._bs_chunk_scan(
            canon, batch.slice_jobs(lo, hi), lo, horizon, scan,
            np.asarray(slots, np.int32), s_max, h, q_cap, B)
        host = [c.cpu().numpy() for c in carry_out]
        canon = stream._bs_extract(host, idmap, rec, B, C, q_cap)
        out.append((*carry_out, tagged, times, canon))
    return out


def equal_chunks(a: list, b: list, what: str) -> None:
    """Two chunk runs equal on every output and carry tensor of every
    chunk (``torch.equal``, each on its own device moved to the CPU) and
    every canonical BS state; raises ``AssertionError`` naming the first
    chunk and entry that differs."""
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} chunks against {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if isinstance(u, dict):
                same = u.keys() == v.keys() and all(
                    np.array_equal(u[key], v[key]) for key in u)
            else:
                same = torch.equal(u.cpu(), v.cpu())
            if not same:
                raise AssertionError(f"{what}: chunk {i} entry {j} differs")


def groups_above(W, t_prev) -> int:
    """The most run-length groups (distinct values above the last start)
    any lane's canonical FCFS carry holds."""
    W, t_prev = W.cpu(), t_prev.cpu()
    return max((len(torch.unique(row[row > tp])) for row, tp in
                zip(W, t_prev)), default=0)
