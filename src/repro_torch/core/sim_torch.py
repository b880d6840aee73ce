"""Plain PyTorch event scans — the port's counterpart of ``repro.core.sim_jax``.

These are the per-event steps of the three Fig. 1/2 policies, written as
torch ops on float64 tensors and batched over a leading replications axis
R (the reference vmaps single-lane steps; here the lane axis is written
out).  The scan drivers are Python loops over events.  They are the plain
versions of the hand-written CUDA kernels in
:mod:`repro_torch.kernels.msj_scan`: the kernel wrappers call them for CPU
tensors, the CPU tests hold them bit-identical (rtol=0) to the JAX
reference, and ``chip_smoke.py`` holds each kernel bit-identical to them.

Bit-identity rests on the steps doing nothing but IEEE additions, maxima,
comparisons and selections in the reference's order, and on every
``argmin``/``argmax`` taking the first index on ties (torch's documented
rule, and XLA's).  Index reads that the reference lets XLA clamp are
clamped explicitly here; its ``mode="drop"`` scatters write to one
padding column at the end of each scattered state tensor, which no read
ever sees.  Unlike the reference, the steps update their state tensors in
place where that saves a copy; the state is private to each scan.

* ``_fcfs_core``  — multiserver-job FCFS (Kiefer–Wolfowitz, O(k) sorted
  roll-and-insert step, ``sim_jax._fcfs_sorted_step``/``_fcfs_core``);
* ``_modbs_core`` — ModifiedBS-π with π = FCFS (Definition 2): per-class
  loss queues plus the helper FCFS on h servers;
* ``_bs_core``    — BS-π proper (Definition 1): the event-indexed 2J-step
  scan with per-class helper-wait rings and rule-3 pull-backs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .partition import balanced_partition

_BIG = 1e30
_INF = math.inf
_F64 = torch.float64


# --------------------------------------------------------------------------
# Multiserver-job FCFS
# --------------------------------------------------------------------------


def _fcfs_sorted_step(W, t_prev, t, n, svc):
    """One Kiefer–Wolfowitz arrival per lane on sorted free-time vectors.

    ``W`` [R, k] sorted ascending per lane; ``t_prev``, ``t``, ``svc`` [R]
    float64; ``n`` [R] int64.  Returns ``(W', start)`` with ``W'`` sorted:
    the n smallest entries retire and n copies of ``comp = start + svc``
    are inserted at ``p = searchsorted(W, comp, right) - n`` — every
    retired entry is <= comp, so the remainder shifted left stays sorted.
    """
    k = W.shape[1]
    nth = W.gather(1, (n - 1).clamp(0, k - 1)[:, None])[:, 0]
    start = torch.maximum(torch.maximum(t, t_prev), nth)
    comp = start + svc
    p = torch.searchsorted(W, comp[:, None], right=True) - n[:, None]
    i = torch.arange(k, device=W.device)[None, :]
    n_ = n[:, None]
    src = torch.where(i < p, i + n_, i).clamp(max=k - 1)
    W_new = torch.where((i >= p) & (i < p + n_), comp[:, None],
                        W.gather(1, src))
    return W_new, start


def _fcfs_core(arrival, need, service, k: int):
    """Start times [R, J] of R FCFS sample paths from an empty system."""
    R, J = arrival.shape
    W = torch.zeros(R, k, dtype=_F64, device=arrival.device)
    t_prev = torch.zeros(R, dtype=_F64, device=arrival.device)
    need = need.long()
    starts = torch.empty(R, J, dtype=_F64, device=arrival.device)
    for j in range(J):
        W, t_prev = _fcfs_sorted_step(W, t_prev, arrival[:, j], need[:, j],
                                      service[:, j])
        starts[:, j] = t_prev
    return starts


# --------------------------------------------------------------------------
# ModifiedBS-π with π = FCFS
# --------------------------------------------------------------------------


def _modbs_init(slots, s_max: int, h: int, R: int):
    """Initial (comp [R, C, s_max], W [R, h], t_prev [R]) state.

    Slots beyond ``slots[c]`` in a class row hold ``_BIG``: permanently
    busy, so they are never the row's argmin and always count as busy.
    """
    dev = slots.device
    pad = (torch.arange(s_max, device=dev)[None, :]
           >= slots.long()[:, None])
    comp0 = torch.where(pad, torch.tensor(_BIG, dtype=_F64, device=dev),
                        torch.tensor(0.0, dtype=_F64, device=dev))
    return (comp0.expand(R, -1, -1).clone(),
            torch.zeros(R, h, dtype=_F64, device=dev),
            torch.zeros(R, dtype=_F64, device=dev))


def _modbs_step(comp, W, t_prev, t, c, n, svc):
    """One ModifiedBS-π arrival per lane; ``comp`` is updated in place.

    A class-c job takes the earliest-free slot of its class row (argmin,
    first index on ties) unless all ``s_max`` entries are busy (> t);
    then it is blocked and runs on the helper FCFS.
    """
    R, _, s_max = comp.shape
    lanes = torch.arange(R, device=comp.device)
    row = comp[lanes, c]
    busy = (row > t[:, None]).sum(1)
    blocked = busy >= s_max
    idx = row.argmin(1)
    comp[lanes, c, idx] = torch.where(blocked, row[lanes, idx], t + svc)
    W_upd, start_h = _fcfs_sorted_step(W, t_prev, t, n, svc)
    W = torch.where(blocked[:, None], W_upd, W)
    t_prev = torch.where(blocked, start_h, t_prev)
    start = torch.where(blocked, start_h, t)
    return W, t_prev, blocked, start


def _modbs_core(arrival, cls, need, service, slots, s_max: int, h: int):
    """Per-class loss queues (padded to s_max) + helper FCFS on h servers.

    Returns ``(blocked [R, J] bool, starts [R, J] float64)``.
    """
    R, J = arrival.shape
    comp, W, t_prev = _modbs_init(slots, s_max, h, R)
    cls = cls.long()
    need = need.long()
    blocked = torch.empty(R, J, dtype=torch.bool, device=arrival.device)
    starts = torch.empty(R, J, dtype=_F64, device=arrival.device)
    for j in range(J):
        W, t_prev, blocked[:, j], starts[:, j] = _modbs_step(
            comp, W, t_prev, arrival[:, j], cls[:, j], need[:, j],
            service[:, j])
    return blocked, starts


# --------------------------------------------------------------------------
# BS-π proper (Definition 1, rule-3 pull-backs) with π = FCFS
# --------------------------------------------------------------------------


def _bs_init(R: int, J: int, C: int, s_max: int, h: int, q_cap: int,
             slots):
    """Initial BS-FCFS event-scan state, one dict of [R, ...] tensors.

    ``st`` packs the per-class counters: [0:C] free A slots, [C:2C] ring
    heads, [2C:3C] ring tails.  ``st``, ``comp``, ``ring`` and ``heads``
    carry one extra trailing column that dropped scatters write to.
    """
    dev = slots.device
    i64 = dict(dtype=torch.int64, device=dev)
    st = torch.zeros(R, 3 * C + 1, **i64)
    st[:, :C] = slots.long()
    return dict(
        ai=torch.zeros(R, **i64),
        st=st,
        comp=torch.full((R, C * s_max + 1), _BIG, dtype=_F64, device=dev),
        ring=torch.zeros(R, C * q_cap + 1, **i64),
        heads=torch.full((R, C + 1), J, **i64),
        W=torch.zeros(R, h, dtype=_F64, device=dev),
        t_prev=torch.zeros(R, dtype=_F64, device=dev),
        t_hol=torch.zeros(R, dtype=_F64, device=dev),
        ovf=torch.zeros(R, dtype=torch.bool, device=dev))


def _bs_step(s, arrival, service, cls, need, C: int, s_max: int, h: int,
             q_cap: int):
    """One BS-FCFS event per lane (``sim_jax._bs_make_step`` statement for
    statement); updates the state dict ``s`` and returns the event record
    ``(tagged, rec_t)``.

    The three candidate events are the next arrival (Ta), the earliest
    outstanding A completion (Tc) and the helper-queue head's FCFS start
    (Th); a commit wins ties, and an arrival precedes a completion at
    equal times.
    """
    R, J = arrival.shape
    dev = arrival.device
    lanes = torch.arange(R, device=dev)
    st, comp, ring, heads, W = s["st"], s["comp"], s["ring"], s["heads"], \
        s["W"]
    ai, t_prev, t_hol = s["ai"], s["t_prev"], s["t_hol"]

    j_arr = ai.clamp(max=J - 1)
    Ta = torch.where(ai < J, arrival[lanes, j_arr], _INF)
    cm = comp[:, :C * s_max].argmin(1)
    Tc = comp[lanes, cm]
    gh_job = heads[:, :C].min(1).values      # global FIFO head (min index)
    has_head = gh_job < J
    jh = gh_job.clamp(max=J - 1)
    nh = need[lanes, jh]
    Wn = W[lanes, (nh - 1).clamp(0, h - 1)]
    Th = torch.where(has_head,
                     torch.maximum(torch.maximum(arrival[lanes, jh], t_hol),
                                   torch.maximum(t_prev, Wn)),
                     _INF)

    is_commit = (Th <= Tc) & (Th <= Ta)
    is_comp = ~is_commit & (Tc < Ta)
    is_arr = ~is_commit & ~is_comp

    # arrival (rule 1): a free A_i slot starts the job, else it enqueues
    c_arr = cls[lanes, j_arr]
    free_c = st[lanes, c_arr]
    head_c = st[lanes, C + c_arr]
    tail_c = st[lanes, 2 * C + c_arr]
    has_slot = is_arr & (free_c > 0)
    enq = is_arr & ~has_slot
    ring[lanes, torch.where(enq, c_arr * q_cap + tail_c % q_cap,
                            C * q_cap)] = j_arr
    s["ovf"] = s["ovf"] | (enq & (tail_c + 1 - head_c > q_cap))
    s["ai"] = ai + is_arr.long()

    # A completion: rule 3 pulls the class head into the freed slot
    c_comp = cm // s_max
    pull = heads[lanes, c_comp]
    can_pull = is_comp & (pull < J)
    jp = pull.clamp(max=J - 1)
    s["t_hol"] = torch.where(can_pull & (pull == gh_job),
                             torch.maximum(t_hol, Tc), t_hol)

    # comp: clear the completed slot, or insert the next A start at the
    # first empty (_BIG) slot of the arriving class / the freed slot
    ins = has_slot | can_pull
    j_ins = torch.where(is_arr, j_arr, jp)
    t_ins = torch.where(is_arr, Ta, Tc)
    svc_ins = service[lanes, j_ins]
    row = comp.gather(1, c_arr[:, None] * s_max
                      + torch.arange(s_max, device=dev)[None, :])
    pos = row.argmax(1)
    oobc = C * s_max
    idx2 = torch.stack(
        [torch.where(is_comp & ~can_pull, cm, oobc),
         torch.where(has_slot, c_arr * s_max + pos,
                     torch.where(can_pull, cm, oobc))], 1)
    val2 = torch.stack([torch.full_like(t_ins, _BIG), t_ins + svc_ins], 1)
    comp.scatter_(1, idx2, val2)

    # helper commit: the global head starts on H at Th (π = FCFS), the
    # sorted roll-and-insert of _fcfs_sorted_step on W
    comp_h = Th + service[lanes, jh]
    p = (W <= comp_h[:, None]).sum(1)[:, None] - nh[:, None]
    ar = torch.arange(h, device=dev)[None, :]
    nh_ = nh[:, None]
    W_roll = W.gather(1, torch.where(ar < p, ar + nh_, ar).clamp(max=h - 1))
    W2 = torch.where((ar >= p) & (ar < p + nh_), comp_h[:, None], W_roll)
    s["W"] = torch.where(is_commit[:, None], W2, W)
    s["t_prev"] = torch.where(is_commit, Th, t_prev)

    # counters: free slots at the touched class, ring tail on enqueue,
    # ring head on pop (rule-3 pull xor commit); the indices are disjoint
    did_pop = can_pull | is_commit
    pop_c = torch.where(can_pull, c_comp, cls[lanes, jh])
    oobs = 3 * C
    idx3 = torch.stack(
        [torch.where(is_arr, c_arr, torch.where(is_comp, c_comp, oobs)),
         torch.where(enq, 2 * C + c_arr, oobs),
         torch.where(did_pop, C + pop_c, oobs)], 1)
    one = torch.ones_like(ai)
    val3 = torch.stack(
        [torch.where(has_slot, -1, 0) + (is_comp & ~can_pull).long(),
         one, one], 1)
    st.scatter_add_(1, idx3, val3)

    # per-class head jobs: an enqueue into an empty ring sets the head, a
    # pop promotes the next ring entry (J when the ring is empty)
    g0 = st[lanes, C + pop_c]
    g1 = st[lanes, 2 * C + pop_c]
    nxt = torch.where(g0 < g1, ring[lanes, pop_c * q_cap + g0 % q_cap], J)
    hidx = torch.stack(
        [torch.where(enq & (head_c == tail_c), c_arr, C),
         torch.where(did_pop, pop_c, C)], 1)
    heads.scatter_(1, hidx, torch.stack([j_arr, nxt], 1))

    # one tagged int per event: j = A start, j + J = routed to H on
    # arrival, j + 2J = helper commit, -1 = no record
    tagged = torch.where(is_commit, jh + 2 * J,
                         torch.where(ins, j_ins,
                                     torch.where(enq, j_arr + J, -1)))
    rec_t = torch.where(is_commit, Th, t_ins)
    return tagged, rec_t


def _bs_core(arrival, cls, need, service, slots, s_max: int, h: int,
             q_cap: int):
    """BS-FCFS sample paths as a 2J-event scan over R lanes.

    Every job contributes its arrival plus either its A completion or its
    helper start, so exactly 2J events exist per lane.  Returns the raw
    event streams ``(tagged [R, 2J] int32, rec_t [R, 2J] float64)`` and the
    ring-overflow flag ``ovf [R] bool``; :func:`_bs_scatter_events` turns
    them into per-job arrays on the host.
    """
    R, J = arrival.shape
    C = slots.shape[0]
    s = _bs_init(R, J, C, s_max, h, q_cap, slots)
    cls = cls.long()
    need = need.long()
    tagged = torch.empty(R, 2 * J, dtype=torch.int32, device=arrival.device)
    rec_t = torch.empty(R, 2 * J, dtype=_F64, device=arrival.device)
    for e in range(2 * J):
        tagged[:, e], rec_t[:, e] = _bs_step(s, arrival, service, cls, need,
                                             C, s_max, h, q_cap)
    return tagged, rec_t, s["ovf"]


def _bs_scatter_events(J: int, tagged, rec_t):
    """Scatter [R, 2J] event records to per-job [R, J] numpy arrays.

    ``tagged`` encodes the event: j = job j started in its A_i (the record
    time is its start), j + J = job j was routed to H on arrival, j + 2J =
    job j started on a helper server.  Each job yields exactly one start
    record and at most one routing record per replication, so every target
    cell is written at most once.
    """
    tagged = np.asarray(tagged)
    rec_t = np.asarray(rec_t)
    R = tagged.shape[0]
    rows = np.broadcast_to(np.arange(R)[:, None], tagged.shape)
    start = np.zeros((R, J))
    served = np.zeros((R, J), bool)
    routed = np.zeros((R, J), bool)
    m_a = (tagged >= 0) & (tagged < J)
    m_r = (tagged >= J) & (tagged < 2 * J)
    m_h = tagged >= 2 * J
    start[rows[m_a], tagged[m_a]] = rec_t[m_a]
    routed[rows[m_r], tagged[m_r] - J] = True
    start[rows[m_h], tagged[m_h] - 2 * J] = rec_t[m_h]
    served[rows[m_h], tagged[m_h] - 2 * J] = True
    return start, served, routed


def _check_classes(batch, C: int) -> None:
    """Class ids must index the partition's C classes."""
    bad = (batch.cls < 0) | (batch.cls >= C)
    if bad.any():
        raise ValueError(f"class ids outside the partition's [0, {C}) range "
                         f"(first bad replication "
                         f"{int(np.argmax(bad.any(axis=1)))})")


def _bs_args(batch, partition, wl, queue_cap):
    """(slots, s_max, h, q_cap) of a BS-FCFS run, validated for the batch.

    ``queue_cap`` bounds the per-class helper-wait rings (default
    ``min(J, 8192)``); an overflow raises after the scan.
    """
    if partition is None:
        if wl is None:
            raise ValueError("need a partition or a workload")
        partition = balanced_partition(wl)
    slots = np.asarray(partition.slots, dtype=np.int32)
    h = int(partition.helpers)
    if h < int(batch.need.max()):
        raise ValueError("helper set smaller than the largest server need")
    _check_classes(batch, len(slots))
    s_max = max(1, int(slots.max()))
    if queue_cap is None:
        queue_cap = max(1, min(batch.num_jobs, 8192))
    elif queue_cap < 1:
        raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
    return slots, s_max, h, queue_cap
