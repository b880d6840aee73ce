"""Streaming chunked execution: constant-memory unbounded traces.

The port's counterpart of the streaming section of the reference's
``repro.core.sim_batch``.  A stream is a sequence of chunk scans, each
resumed from the previous chunk's carry, with per-job observables folded
into an online accumulator the moment they are final — peak memory is
O(R · chunk_jobs), independent of the stream length.  Every fold below is
arranged so the chunked path is bit-identical to running the monolithic
batch and folding its per-job arrays once (:func:`stream_fold`): block
boundaries fall on fixed global job indices, block means use the same
contiguous-buffer reductions, and the probability observables are exact
integer counts divided once at the end.

* :func:`_scan_stream` drives FCFS and ModBS-π: one event per job, the
  carry a few tensors that stay on the device between chunks (downloaded
  only to be checkpointed);
* :func:`_bs_stream_drive` drives BS-π: each chunk scans the still-queued
  jobs of earlier chunks (:func:`_bs_inflate`) plus its own up to the
  next chunk's first arrival, and the host turns the carry back into the
  canonical state (:func:`_bs_extract`) and folds the jobs whose starts
  are all known (:class:`_StreamWindow`).

The carries every device produces after a chunk are canonical (FCFS's W
clamped to the last start, ModBS-π's class rows sorted, BS-π's state in
:func:`_bs_extract`'s form), so a checkpoint's bytes do not depend on the
device it was written on.  The ``engine="torch"`` stream cores that plug
the kernels in live in :mod:`repro_torch.kernels.msj_scan.ops`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..checkpoint import CheckpointManager, latest_step, require_layout
from . import engines
from .partition import BalancedPartition, balanced_partition
from .sim_batch import WAIT_EPS, BatchSimResult
from .sim_torch import _BIG, BS_CARRY_DTYPES
from .workload import BatchTrace


class StreamAccumulator:
    """Online per-replication observables of a job stream.

    Response and wait fold through a fixed-size [2, R, block] buffer:
    full blocks merge into running (count, mean, M2) via the Chan
    parallel-variance update.  Because blocks are cut at fixed *global*
    job indices (multiples of ``block``) regardless of push granularity,
    the folded moments are bit-identical however the stream was chunked.
    The probability observables (P[wait>0], helper-served, routed) are
    kept as exact int64 counts — order-independent by construction.
    """

    def __init__(self, reps: int, block: int = 4096):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.reps = int(reps)
        self.block = int(block)
        self.count = 0              # jobs observed (incl. still-buffered)
        self._cnt = 0               # jobs merged into the running moments
        self._fill = 0
        self._mean = np.zeros((2, self.reps))    # rows: response, wait
        self._m2 = np.zeros((2, self.reps))
        self._buf = np.zeros((2, self.reps, self.block))
        self.n_wait = np.zeros(self.reps, np.int64)
        self.n_served = np.zeros(self.reps, np.int64)
        self.n_routed = np.zeros(self.reps, np.int64)

    def push(self, response, wait, served=None, routed=None) -> None:
        """Fold [R, m] per-job arrays (m may be any size, incl. 0)."""
        resp = np.asarray(response)
        wt = np.asarray(wait)
        m = resp.shape[1]
        if m == 0:
            return
        self.n_wait += (wt > WAIT_EPS).sum(axis=1, dtype=np.int64)
        if served is not None:
            self.n_served += np.asarray(served).sum(axis=1, dtype=np.int64)
        if routed is not None:
            self.n_routed += np.asarray(routed).sum(axis=1, dtype=np.int64)
        data = np.stack([resp, wt])              # [2, R, m]
        pos = 0
        while pos < m:
            take = min(self.block - self._fill, m - pos)
            self._buf[:, :, self._fill:self._fill + take] = \
                data[:, :, pos:pos + take]
            self._fill += take
            pos += take
            if self._fill == self.block:
                self._cnt, self._mean, self._m2 = self._merge(
                    self._cnt, self._mean, self._m2, self._buf, self.block)
                self._fill = 0
        self.count += m

    @staticmethod
    def _merge(cnt, mean, m2, buf, b):
        """Chan merge of the first ``b`` buffered jobs; returns new state."""
        blk = buf[:, :, :b]
        bm = blk.mean(axis=2)
        bm2 = ((blk - bm[:, :, None]) ** 2).sum(axis=2)
        delta = bm - mean
        tot = cnt + b
        mean = mean + delta * (b / tot)
        m2 = m2 + bm2 + delta * delta * (cnt * b / tot)
        return tot, mean, m2

    def finalize(self):
        """(count, mean [2, R], M2 [2, R]) including the partial buffer.

        Non-destructive: the accumulator remains valid for further pushes
        (the partial block is merged into *copies* of the running state).
        """
        cnt, mean, m2 = self._cnt, self._mean.copy(), self._m2.copy()
        if self._fill:
            cnt, mean, m2 = self._merge(cnt, mean, m2, self._buf,
                                        self._fill)
        return cnt, mean, m2

    def state(self) -> dict:
        """Checkpointable state (the buffer saved at its exact fill)."""
        return {"count": np.asarray(self.count, np.int64),
                "cnt": np.asarray(self._cnt, np.int64),
                "mean": self._mean.copy(), "m2": self._m2.copy(),
                "buf": self._buf[:, :, :self._fill].copy(),
                "n_wait": self.n_wait.copy(),
                "n_served": self.n_served.copy(),
                "n_routed": self.n_routed.copy()}

    def load_state(self, d: dict) -> None:
        self.count = int(d["count"])
        self._cnt = int(d["cnt"])
        self._mean = np.asarray(d["mean"], np.float64).copy()
        self._m2 = np.asarray(d["m2"], np.float64).copy()
        fill = int(d["buf"].shape[2])
        self._fill = fill
        self._buf[:, :, :fill] = d["buf"]
        self.n_wait = np.asarray(d["n_wait"], np.int64).copy()
        self.n_served = np.asarray(d["n_served"], np.int64).copy()
        self.n_routed = np.asarray(d["n_routed"], np.int64).copy()


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Folded per-replication observables of a streamed simulation.

    The constant-memory counterpart of :class:`BatchSimResult`: per-job
    arrays are never materialized, so the result carries the folded
    moments instead — ``var_*`` is the population variance (M2/n) of the
    per-job values within each replication.
    """

    jobs: int                      # jobs folded per replication
    reps: int
    mean_response: np.ndarray      # [R]
    var_response: np.ndarray       # [R]
    mean_wait: np.ndarray          # [R]
    var_wait: np.ndarray           # [R]
    p_wait: np.ndarray             # [R] P[wait > WAIT_EPS]
    p_helper: np.ndarray | None = None   # [R] (BSF policies only)
    p_routed: np.ndarray | None = None   # [R]


def _stream_result(acc: StreamAccumulator, jobs: int,
                   has_helper: bool) -> StreamResult:
    cnt, mean, m2 = acc.finalize()
    if cnt != jobs:
        raise RuntimeError(f"internal error: accumulator folded {cnt} "
                           f"jobs, stream fed {jobs}")
    var = m2 / cnt
    return StreamResult(
        jobs=jobs, reps=acc.reps,
        mean_response=mean[0], var_response=var[0],
        mean_wait=mean[1], var_wait=var[1],
        p_wait=acc.n_wait / cnt,
        p_helper=(acc.n_served / cnt) if has_helper else None,
        p_routed=(acc.n_routed / cnt) if has_helper else None)


def stream_fold(res: BatchSimResult, block: int = 4096) -> StreamResult:
    """Fold a monolithic :class:`BatchSimResult` into a StreamResult.

    The reference the streaming path is pinned against: pushing the full
    per-job arrays through a fresh accumulator cuts blocks at the same
    global indices as any chunked schedule, so ``simulate_stream`` must
    match this bit-for-bit (``tests/test_stream.py``).
    """
    acc = StreamAccumulator(res.reps, block=block)
    flags = res.blocked  # ModBS: served == routed == blocked flags
    acc.push(res.response, res.wait, served=flags, routed=flags)
    cnt, mean, m2 = acc.finalize()
    var = m2 / cnt
    if res.p_helper is None:
        p_h = p_r = None
    elif flags is not None:
        p_h = acc.n_served / cnt
        p_r = acc.n_routed / cnt
    else:
        # bs-fcfs keeps no per-job flags on the result; its per-rep
        # fractions are the same exact count/J in f64 (0/1 partial sums
        # are exact integers, one final division) as the count route
        p_h = res.p_helper
        p_r = res.p_routed
    return StreamResult(jobs=res.response.shape[1], reps=res.reps,
                        mean_response=mean[0], var_response=var[0],
                        mean_wait=mean[1], var_wait=var[1],
                        p_wait=acc.n_wait / cnt, p_helper=p_h, p_routed=p_r)


class _StreamCkpt:
    """Per-chunk checkpoint plumbing of a streaming driver.

    Synchronous atomic saves (:mod:`repro_torch.checkpoint`), last two
    steps kept; restore validates the manifest's layout dict against the
    resuming run (``require_layout``) so a changed ``chunk_jobs``/J
    layout fails loudly instead of mixing carries.
    """

    def __init__(self, ckpt_dir: str | None, layout: dict):
        self.mgr = None
        self.layout = layout
        if ckpt_dir is not None:
            self.mgr = CheckpointManager(ckpt_dir, keep=2)

    def save(self, step: int, tree) -> None:
        if self.mgr is not None:
            self.mgr.save(step, tree, extra=self.layout)

    def restore(self, tree_like, context: str):
        """(tree, step) of the latest checkpoint, or None when fresh."""
        if self.mgr is None:
            raise ValueError("resume=True needs a ckpt_dir")
        step = latest_step(self.mgr.directory)
        if step is None:
            return None
        # the layout first (an empty tree reads only the manifest): a
        # checkpoint of another layout may not even hold this tree's leaves
        _, _, extra = self.mgr.restore({}, step=step)
        require_layout(extra, self.layout, context=context)
        tree, step, _ = self.mgr.restore(tree_like, step=step)
        return tree, step


def _fetch_chunk(source, state, n: int, total: int):
    batch, state = source.next_chunk(state, n)
    if batch.num_jobs != n:
        raise ValueError(
            f"chunk source returned {batch.num_jobs} jobs, the driver "
            f"asked for {n} — source exhausted before total_jobs={total}?")
    return batch, state


def _scan_stream(source, *, policy, chunk_jobs, total_jobs, n_carry,
                 init_fn, chunk_fn, to_device, has_helper, part=None, block=4096,
                 ckpt_dir=None, resume=False, layout_extra=None):
    """Drive a scan-carry policy (FCFS, ModBS-π) over a chunk source.

    ``init_fn(R)`` builds the empty-system carry, a tuple of ``n_carry``
    device tensors; ``chunk_fn(carry, batch) -> (carry, response, wait, served,
    routed)`` runs one chunk resumed from ``carry`` (numpy outputs, the
    carry stays on the device); ``to_device(arrays)`` puts a restored
    carry back.  The carry plus accumulator plus source state is
    checkpointed after every chunk, so a SIGKILL mid-stream resumes
    byte-identically (the saved source state is the pre-fetch state of the
    next chunk — re-fetching it is exact because sources are pure
    functions of their state).
    """
    R = int(source.reps)
    total = int(total_jobs)
    chunk_jobs = int(chunk_jobs)
    layout = {"policy": policy, "chunk_jobs": chunk_jobs,
              "total_jobs": total, "reps": R, "k": int(source.k),
              "block": int(block)}
    if layout_extra:
        layout.update(layout_extra)
    ck = _StreamCkpt(ckpt_dir, layout)
    acc = StreamAccumulator(R, block=block)
    src_state = source.init_state()
    carry = None
    fed = 0
    step = 0
    if resume:
        like = {"sim": {"carry": [np.zeros(0)] * n_carry,
                        "fed": np.zeros((), np.int64)},
                "acc": acc.state(), "src": src_state}
        got = ck.restore(like, f"of stream {policy!r}")
        if got is not None:
            tree, step = got
            carry = to_device(tree["sim"]["carry"])
            fed = int(tree["sim"]["fed"])
            acc.load_state(tree["acc"])
            src_state = tree["src"]
    if carry is None:
        carry = init_fn(R)
    while fed < total:
        n = min(chunk_jobs, total - fed)
        batch, src_state = _fetch_chunk(source, src_state, n, total)
        engines.validate_batch(batch, partition=part)
        carry, resp, wait, served, routed = chunk_fn(carry, batch)
        acc.push(resp, wait, served=served, routed=routed)
        fed += n
        step += 1
        ck.save(step, {"sim": {"carry": list(carry),
                               "fed": np.asarray(fed, np.int64)},
                       "acc": acc.state(), "src": src_state})
    return _stream_result(acc, total, has_helper)


# -- the BS event driver: bounded backlog, start-time reorder window --------


class _StreamWindow:
    """Start-time reorder window of the streaming BS driver (host side).

    BS start events arrive out of job order (the event scan interleaves
    A starts, routings and helper commits), so finished observables are
    folded only up to the oldest job whose start is still unknown.  The
    window holds per-global-job (arrival, service, start, flags) records
    for gids [base, base+used); capacity doubles on demand and the
    occupied prefix shifts left after each fold.
    """

    def __init__(self, reps: int, cap: int):
        self.reps = int(reps)
        self.base = 0
        self._used = 0
        self._alloc(max(1, int(cap)))

    def _alloc(self, cap: int) -> None:
        self.cap = cap
        R = self.reps
        self.arr = np.zeros((R, cap))
        self.svc = np.zeros((R, cap))
        self.start = np.zeros((R, cap))
        self.known = np.zeros((R, cap), bool)
        self.served = np.zeros((R, cap), bool)
        self.routed = np.zeros((R, cap), bool)

    def _arrays(self):
        return (self.arr, self.svc, self.start, self.known, self.served,
                self.routed)

    def extend(self, fed: int, chunk: BatchTrace) -> None:
        """Cover gids [fed, fed + Jc) and record the chunk's arr/svc."""
        Jc = chunk.num_jobs
        need = fed + Jc - self.base
        if need > self.cap:
            old = self._arrays()
            u = self._used
            self._alloc(max(need, 2 * self.cap))
            for dst, src in zip(self._arrays(), old):
                dst[:, :u] = src[:, :u]
        lo = fed - self.base
        self.arr[:, lo:lo + Jc] = chunk.arrival
        self.svc[:, lo:lo + Jc] = chunk.service
        self._used = need

    def scatter(self, tagged, rec_t, idmap, J_l: int) -> None:
        """Scatter one chunk's [R, L] event streams (local ids -> gids)."""
        rows = np.broadcast_to(np.arange(self.reps)[:, None], tagged.shape)
        m_a = (tagged >= 0) & (tagged < J_l)
        m_r = (tagged >= J_l) & (tagged < 2 * J_l)
        m_h = tagged >= 2 * J_l
        col = idmap[rows[m_a], tagged[m_a]] - self.base
        self.start[rows[m_a], col] = rec_t[m_a]
        self.known[rows[m_a], col] = True
        col = idmap[rows[m_r], tagged[m_r] - J_l] - self.base
        self.routed[rows[m_r], col] = True
        col = idmap[rows[m_h], tagged[m_h] - 2 * J_l] - self.base
        self.start[rows[m_h], col] = rec_t[m_h]
        self.known[rows[m_h], col] = True
        self.served[rows[m_h], col] = True

    def fold_into(self, acc: StreamAccumulator) -> None:
        """Fold every job below the oldest still-unknown start."""
        n = self._used
        unk = ~self.known[:, :n]
        first = np.where(unk.any(axis=1), unk.argmax(axis=1), n)
        adv = int(first.min())
        if adv == 0:
            return
        a = self.arr[:, :adv]
        v = self.svc[:, :adv]
        s = self.start[:, :adv]
        # same elementwise op order as _bs_result
        acc.push(s + v - a, s - a, served=self.served[:, :adv],
                 routed=self.routed[:, :adv])
        rem = n - adv
        for x in self._arrays():
            x[:, :rem] = x[:, adv:n].copy()
        for x in (self.known, self.served, self.routed):
            x[:, rem:n] = False
        self.base += adv
        self._used = rem

    def state(self) -> dict:
        u = self._used
        return {"base": np.asarray(self.base, np.int64),
                "arr": self.arr[:, :u].copy(), "svc": self.svc[:, :u].copy(),
                "start": self.start[:, :u].copy(),
                "known": self.known[:, :u].copy(),
                "served": self.served[:, :u].copy(),
                "routed": self.routed[:, :u].copy()}

    def load_state(self, d: dict) -> None:
        u = int(d["arr"].shape[1])
        if u > self.cap:
            self._alloc(max(u, 2 * self.cap))
        self.base = int(d["base"])
        self._used = u
        for name in ("arr", "svc", "start", "known", "served", "routed"):
            dst = getattr(self, name)
            dst[:, :u] = d[name]
            if dst.dtype == bool:
                dst[:, u:] = False


def _bs_canon0(R: int, C: int, s_max: int, h: int, B: int,
               slots) -> dict:
    """Empty-system canonical BS stream state (matches ``_bs_init``)."""
    return {"pend_gid": np.full((R, B), -1, np.int64),
            "pend_arr": np.zeros((R, B)),
            "pend_svc": np.zeros((R, B)),
            "pend_cls": np.zeros((R, B), np.int64),
            "pend_need": np.ones((R, B), np.int64),
            "pend_n": np.zeros(R, np.int64),
            "free": np.broadcast_to(np.asarray(slots, np.int32),
                                    (R, C)).copy(),
            "comp": np.full((R, C * s_max), _BIG),
            "W": np.zeros((R, h)),
            "t_prev": np.zeros(R),
            "t_hol": np.zeros(R)}


def _bs_inflate(canon: dict, chunk: BatchTrace, fed: int, slots,
                s_max: int, h: int, q_cap: int, B: int):
    """Canonical state + chunk -> (carry, local job arrays, idmap).

    Local layout: the still-queued jobs of earlier chunks re-based to
    local indices [0, P_r) in global-gid order (= FIFO — gids increment
    in feed order, so local index order mirrors the monolithic job index
    order the scan's min-of-heads FIFO selection relies on), zero padding
    up to B, the chunk's jobs at [B, B + Jc).  Per-class rings rebuild
    from the pending set (head counter 0), the arrival cursor starts at B
    (pending arrivals were consumed in earlier chunks), and ovf/ne reset
    per chunk.
    """
    R, Jc = chunk.arrival.shape
    C = int(slots.shape[0])
    J_l = B + Jc
    arr = np.zeros((R, J_l))
    svc = np.zeros((R, J_l))
    cl = np.zeros((R, J_l), np.int64)
    nd = np.ones((R, J_l), np.int64)
    arr[:, :B] = canon["pend_arr"]
    svc[:, :B] = canon["pend_svc"]
    cl[:, :B] = canon["pend_cls"]
    nd[:, :B] = canon["pend_need"]
    arr[:, B:] = chunk.arrival
    svc[:, B:] = chunk.service
    cl[:, B:] = chunk.cls
    nd[:, B:] = chunk.need
    idmap = np.concatenate(
        [canon["pend_gid"],
         np.broadcast_to(fed + np.arange(Jc), (R, Jc))], axis=1)
    st = np.zeros((R, 3 * C), np.int32)
    st[:, :C] = canon["free"]
    ring = np.zeros((R, C * q_cap), np.int32)
    heads = np.full((R, C), J_l, np.int32)
    for r in range(R):
        pcls = canon["pend_cls"][r, :int(canon["pend_n"][r])]
        for c in range(C):
            loc = np.flatnonzero(pcls == c)
            if loc.size:
                ring[r, c * q_cap + np.arange(loc.size)] = loc
                st[r, 2 * C + c] = loc.size
                heads[r, c] = loc[0]
    carry = (np.full(R, B, np.int32), st, canon["comp"], ring, heads,
             canon["W"], canon["t_prev"], canon["t_hol"],
             np.zeros(R, bool), np.zeros(R, np.int32))
    return carry, (arr, cl, nd, svc), idmap


def _bs_chunk_scan(canon: dict, chunk: BatchTrace, fed: int, horizon,
                   scan_fn, slots, s_max: int, h: int, q_cap: int, B: int):
    """One BS-FCFS chunk: ``chunk`` (global jobs from ``fed``) behind the
    canonical state's queued jobs (:func:`_bs_inflate`), scanned by
    ``scan_fn(carry, rec, horizon, length)`` over ``length = 2*Jc + B +
    C*s_max`` steps (arrivals + chunk-job second events + pending second
    events + in-flight A completions: every event that can legally fall
    before the horizon).  Returns (what ``scan_fn`` returns, rec, idmap).
    """
    carry, rec, idmap = _bs_inflate(canon, chunk, fed, slots, s_max, h,
                                    q_cap, B)
    length = 2 * chunk.arrival.shape[1] + B + int(slots.shape[0]) * s_max
    return scan_fn(carry, rec, horizon, length), rec, idmap


def _bs_device_scan(fn, device, slots, s_max: int, h: int, q_cap: int):
    """A ``scan_fn`` for :func:`_bs_chunk_scan` that calls ``fn``
    (``bs_stream_fwd`` or its plain version) on ``device``: numpy carry,
    records and horizon in, whatever ``fn`` returns out."""
    sl = torch.tensor(np.asarray(slots, np.int32), device=device)

    def scan(carry, rec, horizon, length):
        arr, cl, nd, svc = (torch.as_tensor(x, dtype=d, device=device)
                            for x, d in zip(rec, (torch.float64, torch.int32,
                                                  torch.int32,
                                                  torch.float64)))
        dev = tuple(torch.as_tensor(c, dtype=d, device=device)
                    for c, d in zip(carry, BS_CARRY_DTYPES))
        return fn(arr, cl, nd, svc, sl,
                  torch.as_tensor(horizon, dtype=torch.float64,
                                  device=device), dev,
                  s_max=s_max, h=h, q_cap=q_cap, length=length)

    return scan


def _bs_extract(carry, idmap, rec, B: int, C: int, q_cap: int) -> dict:
    """Post-chunk carry -> canonical state (the checkpoint/resume unit).

    Walks the per-class rings, maps survivors back to gids, and re-sorts
    them into global-FIFO order.  More than ``B`` still-queued jobs in
    any lane means the bounded local layout cannot represent the backlog
    — raised loudly rather than silently dropping jobs.
    """
    ai, st, comp, ring, heads, W, t_prev, t_hol, ovf, ne = carry
    arr_l, cl_l, nd_l, svc_l = rec
    R = st.shape[0]
    canon = {"pend_gid": np.full((R, B), -1, np.int64),
             "pend_arr": np.zeros((R, B)),
             "pend_svc": np.zeros((R, B)),
             "pend_cls": np.zeros((R, B), np.int64),
             "pend_need": np.ones((R, B), np.int64),
             "pend_n": np.zeros(R, np.int64),
             "free": np.asarray(st[:, :C], np.int32).copy(),
             "comp": np.asarray(comp),
             "W": np.asarray(W),
             "t_prev": np.asarray(t_prev),
             "t_hol": np.asarray(t_hol)}
    for r in range(R):
        locs = []
        for c in range(C):
            hd, tl = int(st[r, C + c]), int(st[r, 2 * C + c])
            if tl > hd:
                pos = c * q_cap + (hd + np.arange(tl - hd)) % q_cap
                locs.append(ring[r, pos])
        if not locs:
            continue
        loc = np.concatenate(locs).astype(np.int64)
        gid = idmap[r, loc]
        order = np.argsort(gid)
        loc, gid = loc[order], gid[order]
        if loc.size > B:
            raise RuntimeError(
                f"streaming backlog overflow: replication {r} has "
                f"{loc.size} jobs still queued at a chunk boundary but "
                f"backlog_cap={B} — raise backlog_cap, or the workload "
                f"is unstable at this load")
        p = loc.size
        canon["pend_gid"][r, :p] = gid
        canon["pend_arr"][r, :p] = arr_l[r, loc]
        canon["pend_svc"][r, :p] = svc_l[r, loc]
        canon["pend_cls"][r, :p] = cl_l[r, loc]
        canon["pend_need"][r, :p] = nd_l[r, loc]
        canon["pend_n"][r] = p
    return canon


def _bs_stream_drive(source, *, policy, chunk_jobs, total_jobs, part, slots,
                     s_max, h, q_cap, B, scan_fn, block=4096,
                     ckpt_dir=None, resume=False):
    """Drive BS-FCFS over a chunk source with a one-chunk lookahead.

    Each chunk scans (:func:`_bs_chunk_scan`) with ``horizon`` = the next
    chunk's first arrival (events at or past it defer to the next chunk's
    scan, which replays them first — see ``sim_torch._bs_step``) and
    hands the carry to ``_bs_extract``.  The last chunk runs with horizon
    = inf, so its scan *is* the drain — afterwards every lane must have
    processed exactly two events per fed job.  ``scan_fn(carry, rec,
    horizon, length)`` is the chunk call on the stream's device (numpy
    in, numpy out).
    """
    R = int(source.reps)
    C = int(slots.shape[0])
    total = int(total_jobs)
    chunk_jobs = int(chunk_jobs)
    layout = {"policy": policy, "chunk_jobs": chunk_jobs,
              "total_jobs": total, "reps": R, "k": int(source.k),
              "block": int(block), "C": C, "s_max": int(s_max),
              "h": int(h), "q_cap": int(q_cap), "backlog_cap": int(B)}
    ck = _StreamCkpt(ckpt_dir, layout)
    acc = StreamAccumulator(R, block=block)
    win = _StreamWindow(R, B + 2 * chunk_jobs)
    canon = _bs_canon0(R, C, s_max, h, B, slots)
    src_state = source.init_state()
    fed = 0
    step = 0
    done = np.zeros(R, np.int64)
    if resume:
        like = {"sim": {**{key: np.zeros(0) for key in canon},
                        "fed": np.zeros((), np.int64),
                        "done": np.zeros(0, np.int64)},
                "acc": acc.state(), "src": src_state, "win": win.state()}
        got = ck.restore(like, f"of stream {policy!r}")
        if got is not None:
            tree, step = got
            fed = int(tree["sim"]["fed"])
            done = np.asarray(tree["sim"]["done"], np.int64).copy()
            canon = {key: tree["sim"][key] for key in canon}
            acc.load_state(tree["acc"])
            src_state = tree["src"]
            win.load_state(tree["win"])
    pending = None             # pre-fetched (chunk, post-fetch src state)
    while fed < total:
        n = min(chunk_jobs, total - fed)
        if pending is None:
            cur, src_after = _fetch_chunk(source, src_state, n, total)
        else:
            cur, src_after = pending
            pending = None
        rem = total - fed - n
        if rem > 0:
            pending = _fetch_chunk(source, src_after,
                                   min(chunk_jobs, rem), total)
            horizon = pending[0].arrival[:, 0].copy()
        else:
            horizon = np.full(R, np.inf)
        engines.validate_batch(cur, partition=part)
        if h < int(cur.need.max()):
            raise ValueError("helper set smaller than the largest "
                             "server need")
        win.extend(fed, cur)
        (carry, tagged, rec_t), rec, idmap = _bs_chunk_scan(
            canon, cur, fed, horizon, scan_fn, slots, s_max, h, q_cap, B)
        J_l = B + n
        ovf = carry[8]
        if ovf.any():
            raise RuntimeError(
                f"helper-wait ring buffer overflow (queue_cap={q_cap}) in "
                f"replication(s) {np.flatnonzero(ovf).tolist()} — workload "
                f"unstable at this load, or raise queue_cap")
        if not np.all(carry[0] == J_l):
            raise RuntimeError("internal error: chunk scan left arrivals "
                               "unprocessed")
        done += np.asarray(carry[9], np.int64)
        win.scatter(tagged, rec_t, idmap, J_l)
        fed += n
        win.fold_into(acc)
        canon = _bs_extract(carry, idmap, rec, B, C, q_cap)
        step += 1
        src_state = src_after
        ck.save(step, {"sim": {**canon, "fed": np.asarray(fed, np.int64),
                               "done": done.copy()},
                       "acc": acc.state(), "src": src_state,
                       "win": win.state()})
    if not np.all(done == 2 * total):
        raise RuntimeError("internal error: stream ended with unprocessed "
                           "events")
    return _stream_result(acc, total, True)


def _stream_partition(partition, wl) -> BalancedPartition:
    if partition is None:
        if wl is None:
            raise ValueError("need a partition or a workload")
        partition = balanced_partition(wl)
    return partition


#: the default ``backlog_cap`` of a BS-FCFS stream: how many still-queued
#: jobs a replication may carry across a chunk boundary
BS_BACKLOG_CAP = 1024


def _bs_stream_args(partition, wl, chunk_jobs, queue_cap, backlog_cap):
    """(part, slots, s_max, h, q_cap, B) of a BS stream, validated.

    ``queue_cap`` defaults to ``backlog_cap + chunk_jobs`` — the within-
    chunk queue occupancy (carried backlog + every chunk arrival) can
    never exceed it, so the default never overflows.
    """
    part = _stream_partition(partition, wl)
    slots = np.asarray(part.slots, np.int32)
    s_max = max(1, int(slots.max()))
    h = int(part.helpers)
    B = int(backlog_cap)
    if B < 1:
        raise ValueError(f"backlog_cap must be >= 1, got {backlog_cap}")
    if queue_cap is None:
        q_cap = B + int(chunk_jobs)
    elif queue_cap < 1:
        raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
    else:
        q_cap = int(queue_cap)
    return part, slots, s_max, h, q_cap, B
