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

* ``_loss_core``  — the M/GI/s/s loss queue (``sim_jax._loss_core``), the
  Property-1 building block: each class row of ModifiedBS-π is one;
* ``_fcfs_core``  — multiserver-job FCFS (Kiefer–Wolfowitz, O(k) sorted
  roll-and-insert step, ``sim_jax._fcfs_sorted_step``/``_fcfs_core``);
* ``_modbs_core`` — ModifiedBS-π with π = FCFS (Definition 2): per-class
  loss queues plus the helper FCFS on h servers;
* ``_bs_core``    — BS-π proper (Definition 1): the event-indexed 2J-step
  scan with per-class helper-wait rings and rule-3 pull-backs;
* ``_fcfs_fail_core``, ``_modbs_fail_core``, ``_bs_fail_core`` — the
  three in drain mode (``sim_jax._fcfs_fail_step``, ``_modbs_fail_step``,
  ``_bs_fail_make_step``): FCFS and ModBS scan the host-merged
  arrival+failure stream, a failure row holding the earliest-free unit of
  its block until ``t_up`` (``_kw_drain`` on a free-time vector); BS-π
  reads the failure records through a cursor, a fourth candidate event
  that wins ties;
* ``_srpt_core``  — the preemptive ServerFilling-SRPT / FirstFit-SRPT
  2J-event scan over a Q-slot table (``sim_jax._srpt_make_step``, the
  reference step, not its XLA:CPU rewrite ``_srpt_fast_make_step``).

The single-trace API at the end (``loss_queue_sim``, ``fcfs_sim``,
``modified_bs_sim``, ``bs_sim``, ``estimate_p_helper``, returning
:class:`SimResult`) is the counterpart of ``sim_jax``'s: each runs a trace
as a one-replication batch through :mod:`repro_torch.core.engines` (the
loss queue through :func:`repro_torch.core.sim_batch.loss_queue_sim_batch`),
on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .partition import balanced_partition

_BIG = 1e30
_INF = math.inf
_F64 = torch.float64


# --------------------------------------------------------------------------
# Per-lane sizes.  A grid stacks cells of different k, partitions and J on
# one lane axis; every size a lane has of its own is data here, as in the
# reference's grid plans: dead servers are _BIG tail entries of a free-time
# vector (no finite completion undercuts them, so every read and insert
# sees the live prefix), padded class slots are permanently busy _BIG
# completion entries, and the event scans never admit a job at or past the
# lane's ``j_live``.  A single cell is the case where every lane has the
# full sizes.
# --------------------------------------------------------------------------


def _lanes(x, R: int, device, default: int):
    """Per-lane sizes as an [R] int64 tensor: ``x`` an [R] tensor, an int,
    or None for ``default``."""
    if x is None:
        x = default
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).expand(R)
    return torch.full((R,), int(x), dtype=torch.int64, device=device)


def _free_times(R: int, m: int, live, device):
    """[R, m] free-time vectors of empty systems: 0 for each lane's
    ``live`` servers, _BIG (dead: never free) past them."""
    live = _lanes(live, R, device, m)
    dead = torch.arange(m, device=device)[None, :] >= live[:, None]
    return torch.zeros(R, m, dtype=_F64, device=device).masked_fill_(dead,
                                                                     _BIG)


# --------------------------------------------------------------------------
# M/GI/s/s loss queue
# --------------------------------------------------------------------------


def _loss_core(arrival, service, s: int):
    """Blocked masks of R M/GI/s/s sample paths: [R, J] float64 arrival
    and service -> [R, J] bool (``sim_jax._loss_core``).

    A job is blocked when all ``s`` completion times are above its
    arrival; otherwise it takes the earliest (argmin, first index on
    ties) and holds it until ``t + svc``.  ``s < 1`` raises (the
    reference's argmin of an empty row fails).
    """
    if s < 1:
        raise ValueError(f"the loss queue needs s >= 1 servers, got {s}")
    R, J = arrival.shape
    dev = arrival.device
    comp = torch.zeros(R, s, dtype=_F64, device=dev)
    lanes = torch.arange(R, device=dev)
    blocked = torch.empty(R, J, dtype=torch.bool, device=dev)
    for j in range(J):
        t = arrival[:, j]
        b = (comp > t[:, None]).sum(1) >= s
        idx = comp.argmin(1)
        comp[lanes, idx] = torch.where(b, comp[lanes, idx],
                                       t + service[:, j])
        blocked[:, j] = b
    return blocked


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


def _fcfs_stream_core(W, t_prev, arrival, need, service):
    """R FCFS sample paths over one chunk [R, J], resumed from the carry
    ``(W [R, k] sorted, t_prev [R])`` (``sim_jax._fcfs_stream_core``).

    Returns ``(W', t_prev', starts [R, J])`` with ``W'`` in the port's
    canonical form, clamped to ``>= t_prev'``: every later start is at
    least t_prev', so an entry at or below it reaches no output whatever
    its value — the CUDA kernel keeps only their count.
    """
    R, J = arrival.shape
    need = need.long()
    starts = torch.empty(R, J, dtype=_F64, device=arrival.device)
    for j in range(J):
        W, t_prev = _fcfs_sorted_step(W, t_prev, arrival[:, j], need[:, j],
                                      service[:, j])
        starts[:, j] = t_prev
    return torch.maximum(W, t_prev[:, None]), t_prev, starts


def _fcfs_core(arrival, need, service, k: int, k_lane=None):
    """Start times [R, J] of R FCFS sample paths from an empty system on
    ``k_lane`` [R] servers each (None: k), padded to k."""
    R = arrival.shape[0]
    W = _free_times(R, k, k_lane, arrival.device)
    t_prev = torch.zeros(R, dtype=_F64, device=arrival.device)
    return _fcfs_stream_core(W, t_prev, arrival, need, service)[2]


def _kw_drain(W, t_up):
    """One drain event per lane on sorted free-time vectors ``W`` [R, k].

    A breakdown claims the earliest-free capacity unit until ``t_up``:
    ``W[0] := max(W[0], t_up)``, re-sorted by the roll-and-insert of
    :func:`_fcfs_sorted_step` with n = 1.  ``t_up = 0`` is the identity
    (the no-op padding rows of a merged failure stream).
    """
    k = W.shape[1]
    comp_f = torch.maximum(W[:, 0], t_up)
    p = torch.searchsorted(W, comp_f[:, None], right=True) - 1
    i = torch.arange(k, device=W.device)[None, :]
    return torch.where(i == p, comp_f[:, None],
                       W.gather(1, torch.where(i < p, i + 1, i)))


def _fcfs_fail_step(W, t_prev, t, n, svc, tu, isf):
    """One merged arrival-or-failure row per lane of the FCFS drain scan.

    Rows with ``isf`` drain W (:func:`_kw_drain`); arrival rows are the
    ordinary Kiefer–Wolfowitz step.  Failures never touch ``t_prev``.
    Returns ``(W', t_prev', start)``; ``start`` of a failure row is the
    step's value all the same (the host reads arrival rows only).
    """
    W_a, start = _fcfs_sorted_step(W, t_prev, t, n, svc)
    W_new = torch.where(isf[:, None], _kw_drain(W, tu), W_a)
    return W_new, torch.where(isf, t_prev, start), start


def _fcfs_fail_core(t, n, svc, t_up, is_fail, k: int, k_lane=None):
    """Start times [R, L] of R FCFS paths over merged arrival+failure
    streams (``sim_jax._fcfs_fail_core``), from an empty system on
    ``k_lane`` [R] servers each (None: k), padded to k."""
    R, L = t.shape
    W = _free_times(R, k, k_lane, t.device)
    t_prev = torch.zeros(R, dtype=_F64, device=t.device)
    n = n.long()
    starts = torch.empty(R, L, dtype=_F64, device=t.device)
    for j in range(L):
        W, t_prev, starts[:, j] = _fcfs_fail_step(
            W, t_prev, t[:, j], n[:, j], svc[:, j], t_up[:, j],
            is_fail[:, j])
    return starts


# --------------------------------------------------------------------------
# ModifiedBS-π with π = FCFS
# --------------------------------------------------------------------------


def _modbs_init(slots, s_max: int, h: int, R: int, h_lane=None):
    """Initial (comp [R, C, s_max], W [R, h], t_prev [R]) state.

    ``slots`` is [C] (every lane) or [R, C] (a lane each).  Slots beyond
    ``slots[c]`` in a class row hold ``_BIG``: permanently busy, so they
    are never the row's argmin and always count as busy.  The helper has
    ``h_lane`` [R] live servers (None: h), dead ones past them.
    """
    dev = slots.device
    pad = (torch.arange(s_max, device=dev)
           >= slots.long()[..., None])
    comp0 = torch.where(pad, torch.tensor(_BIG, dtype=_F64, device=dev),
                        torch.tensor(0.0, dtype=_F64, device=dev))
    return (comp0.expand(R, *comp0.shape[-2:]).clone(),
            _free_times(R, h, h_lane, dev),
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


def _modbs_stream_core(comp, W, t_prev, arrival, cls, need, service):
    """ModifiedBS-π over one chunk [R, J], resumed from the carry
    ``(comp [R, C, s_max], W [R, h], t_prev [R])``
    (``sim_jax._modbs_stream_core``); the caller's ``comp`` is not
    touched.

    Returns ``(comp', W', t_prev', blocked [R, J] bool, starts [R, J])``
    with the carry in the port's canonical form: each class row sorted
    ascending (only a row's multiset reaches an output — a job is blocked
    when every entry is above t, and a start replaces a smallest entry)
    and ``W'`` clamped to ``>= t_prev'`` as in :func:`_fcfs_stream_core`.
    """
    R, J = arrival.shape
    comp = comp.clone()
    cls = cls.long()
    need = need.long()
    blocked = torch.empty(R, J, dtype=torch.bool, device=arrival.device)
    starts = torch.empty(R, J, dtype=_F64, device=arrival.device)
    for j in range(J):
        W, t_prev, blocked[:, j], starts[:, j] = _modbs_step(
            comp, W, t_prev, arrival[:, j], cls[:, j], need[:, j],
            service[:, j])
    return (torch.sort(comp, dim=2).values, torch.maximum(W, t_prev[:, None]),
            t_prev, blocked, starts)


def _modbs_core(arrival, cls, need, service, slots, s_max: int, h: int,
                h_lane=None):
    """Per-class loss queues (padded to s_max) + helper FCFS on h servers
    (``h_lane`` [R] live; see :func:`_modbs_init`).

    Returns ``(blocked [R, J] bool, starts [R, J] float64)``.
    """
    carry = _modbs_init(slots, s_max, h, arrival.shape[0], h_lane)
    return _modbs_stream_core(*carry, arrival, cls, need, service)[3:]


def _modbs_fail_step(comp, W, t_prev, t, c, n, svc, tu, isf, C: int):
    """One merged arrival-or-failure row per lane of the ModBS drain scan
    (``sim_jax._modbs_fail_step`` statement for statement); ``comp`` is
    updated in place.

    Failure rows carry the target block in the class column: ``c < C``
    extends the argmin completion entry of class row c to ``t_up``;
    ``c == C`` drains the helper W.  Padding rows are helper drains with
    ``t_up = 0``, the identity.
    """
    R = comp.shape[0]
    s_max = comp.shape[2]
    lanes = torch.arange(R, device=comp.device)
    helper_fail = isf & (c == C)
    class_fail = isf & ~helper_fail
    cc = c.clamp(max=C - 1)
    row = comp[lanes, cc]
    busy = (row > t[:, None]).sum(1)
    blocked = busy >= s_max
    idx = row.argmin(1)
    old = row[lanes, idx]
    new_val = torch.where(class_fail, torch.maximum(old, tu),
                          torch.where(blocked, old, t + svc))
    touch = class_fail | ~isf
    comp[lanes, cc, idx] = torch.where(touch, new_val, old)
    W_upd, start_h = _fcfs_sorted_step(W, t_prev, t, n, svc)
    engage = ~isf & blocked
    W_new = torch.where(helper_fail[:, None], _kw_drain(W, tu),
                        torch.where(engage[:, None], W_upd, W))
    t_prev_new = torch.where(engage, start_h, t_prev)
    start = torch.where(blocked, start_h, t)
    return W_new, t_prev_new, blocked & ~isf, start


def _modbs_fail_core(t, c, n, svc, t_up, is_fail, slots, s_max: int,
                     h: int, h_lane=None):
    """ModBS-FCFS over merged arrival+failure streams [R, L]
    (``sim_jax._modbs_fail_core``) -> (blocked [R, L], starts [R, L]).
    ``slots`` and ``h_lane`` as in :func:`_modbs_init`; ``c == C`` (the
    padded class count) marks a helper drain."""
    R, L = t.shape
    C = slots.shape[-1]
    comp, W, t_prev = _modbs_init(slots, s_max, h, R, h_lane)
    c = c.long()
    n = n.long()
    blocked = torch.empty(R, L, dtype=torch.bool, device=t.device)
    starts = torch.empty(R, L, dtype=_F64, device=t.device)
    for j in range(L):
        W, t_prev, blocked[:, j], starts[:, j] = _modbs_fail_step(
            comp, W, t_prev, t[:, j], c[:, j], n[:, j], svc[:, j],
            t_up[:, j], is_fail[:, j], C)
    return blocked, starts


# --------------------------------------------------------------------------
# BS-π proper (Definition 1, rule-3 pull-backs) with π = FCFS
# --------------------------------------------------------------------------


def _bs_init(R: int, J: int, C: int, s_max: int, h: int, q_cap: int,
             slots, h_lane=None):
    """Initial BS-FCFS event-scan state, one dict of [R, ...] tensors.

    ``st`` packs the per-class counters: [0:C] free A slots, [C:2C] ring
    heads, [2C:3C] ring tails.  ``st``, ``comp``, ``ring`` and ``heads``
    carry one extra trailing column that dropped scatters write to.
    ``slots`` is [C] or [R, C] (padded classes have none); the helper has
    ``h_lane`` [R] live servers (None: h), dead ones past them.
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
        W=_free_times(R, h, h_lane, dev),
        t_prev=torch.zeros(R, dtype=_F64, device=dev),
        t_hol=torch.zeros(R, dtype=_F64, device=dev),
        ovf=torch.zeros(R, dtype=torch.bool, device=dev))


def _bs_step(s, arrival, service, cls, need, C: int, s_max: int, h: int,
             q_cap: int, jl=None, live=None, horizon=None):
    """One BS-FCFS event per lane (``sim_jax._bs_make_step`` statement for
    statement); updates the state dict ``s`` and returns the event record
    ``(tagged, rec_t)``.

    The three candidate events are the next arrival (Ta), the earliest
    outstanding A completion (Tc) and the helper-queue head's FCFS start
    (Th); a commit wins ties, and an arrival precedes a completion at
    equal times.  ``jl`` [R]: the lane's jobs (None: J; jobs past it are
    never admitted); ``live`` [R] bool: the lane has events left (None:
    every lane) — a lane past its 2 jl events records (-1, Tc) and keeps
    its state.  ``horizon`` [R] makes the step a chunk step of a stream
    (``sim_jax._bs_stream_make_step``): a commit needs Th <= horizon and
    a completion Tc < horizon (and below 0.5 BIG), an arrival ai < jl;
    a deferred event leaves the state as it is, and ``s["ne"]`` counts
    the events processed.
    """
    R, J = arrival.shape
    dev = arrival.device
    lanes = torch.arange(R, device=dev)
    st, comp, ring, heads, W = s["st"], s["comp"], s["ring"], s["heads"], \
        s["W"]
    ai, t_prev, t_hol = s["ai"], s["t_prev"], s["t_hol"]
    jl = J if jl is None else jl

    j_arr = ai.clamp(max=J - 1)
    Ta = torch.where(ai < jl, arrival[lanes, j_arr], _INF)
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
    if horizon is not None:
        is_commit &= Th <= horizon
    is_comp = ~is_commit & (Tc < Ta)
    if horizon is not None:
        is_comp &= (Tc < horizon) & (Tc < 0.5 * _BIG)
    is_arr = ~is_commit & ~is_comp
    if horizon is not None:
        is_arr &= ai < jl
        s["ne"] = s["ne"] + (is_commit | is_comp | is_arr).int()
    if live is not None:
        is_commit, is_comp, is_arr = (is_commit & live, is_comp & live,
                                      is_arr & live)

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
             q_cap: int, h_lane=None, j_live=None):
    """BS-FCFS sample paths as a 2J-event scan over R lanes.

    Every job contributes its arrival plus either its A completion or its
    helper start, so exactly 2J events exist per lane; a lane of
    ``j_live`` [R] jobs (None: J; the rest are padding it never admits)
    has 2 j_live, and records (-1, Tc) past them.  ``slots`` [C] or
    [R, C] and ``h_lane`` as in :func:`_bs_init`.  Returns the raw event
    streams ``(tagged [R, 2J] int32, rec_t [R, 2J] float64)`` and the
    ring-overflow flag ``ovf [R] bool``; :func:`_bs_scatter_events` turns
    them into per-job arrays on the host.
    """
    R, J = arrival.shape
    C = slots.shape[-1]
    s = _bs_init(R, J, C, s_max, h, q_cap, slots, h_lane)
    jl = _lanes(j_live, R, arrival.device, J)
    cls = cls.long()
    need = need.long()
    tagged = torch.empty(R, 2 * J, dtype=torch.int32, device=arrival.device)
    rec_t = torch.empty(R, 2 * J, dtype=_F64, device=arrival.device)
    for e in range(2 * J):
        tagged[:, e], rec_t[:, e] = _bs_step(s, arrival, service, cls, need,
                                             C, s_max, h, q_cap, jl,
                                             e < 2 * jl)
    return tagged, rec_t, s["ovf"]


#: dtypes of the BS stream carry (ai, st, comp, ring, heads, W, t_prev,
#: t_hol, ovf, ne), the reference's ``_BS_CARRY_DTYPES``
BS_CARRY_DTYPES = (torch.int32, torch.int32, _F64, torch.int32, torch.int32,
                   _F64, _F64, _F64, torch.bool, torch.int32)


def bs_live_ring(ring, st, C: int, q_cap: int):
    """``ring`` [R, C q_cap] with every position outside a class's queue
    set to 0: the port's canonical ring.  Class c's queue is the last
    min(tail - head, q_cap) writes before its tail (``st`` [R, 3C] holds
    the free counts, heads and tails)."""
    hd = st[:, C:2 * C].long()
    n = (st[:, 2 * C:].long() - hd).clamp(max=q_cap)
    pos = torch.arange(q_cap, device=ring.device)
    live = (pos[None, None, :] - hd[:, :, None]) % q_cap < n[:, :, None]
    return torch.where(live.reshape(ring.shape), ring, 0)


def _bs_stream_core(arrival, cls, need, service, horizon, carry, C: int,
                    s_max: int, h: int, q_cap: int, length: int):
    """One BS-FCFS chunk scan over R lanes resumed from ``carry``
    (``sim_jax._bs_stream_core``).

    ``carry`` is the reference's chunk carry ``(ai, st, comp, ring,
    heads, W, t_prev, t_hol, ovf, ne)`` ([R] / [R, 3C] / [R, C s_max] /
    [R, C q_cap] / [R, C] / [R, h] / [R] ..., dtypes
    :data:`BS_CARRY_DTYPES`), ``horizon`` [R] the next chunk's first
    arrival (inf when draining).  Runs ``length`` steps of
    :func:`_bs_step` with the stream rules and returns ``(carry',
    tagged [R, length] int32, rec_t [R, length] float64)``; the ring of
    ``carry'`` holds only the queued entries (:func:`bs_live_ring`).
    """
    R, J = arrival.shape
    ai, st, comp, ring, heads, W, t_prev, t_hol, ovf, ne = carry

    def pad(x, v):   # a fresh copy with the column dropped writes go to
        x = x.long() if x.dtype == torch.int32 else x
        return torch.cat([x, torch.full_like(x[:, :1], v)], 1)

    s = dict(ai=ai.long(), st=pad(st, 0), comp=pad(comp, _BIG),
             ring=pad(ring, 0), heads=pad(heads, J), W=W, t_prev=t_prev,
             t_hol=t_hol, ovf=ovf, ne=ne)
    cls = cls.long()
    need = need.long()
    tagged = torch.empty(R, length, dtype=torch.int32, device=arrival.device)
    rec_t = torch.empty(R, length, dtype=_F64, device=arrival.device)
    for e in range(length):
        tagged[:, e], rec_t[:, e] = _bs_step(s, arrival, service, cls, need,
                                             C, s_max, h, q_cap,
                                             horizon=horizon)
    st_out = s["st"][:, :3 * C].int()
    out = (s["ai"].int(), st_out, s["comp"][:, :C * s_max].contiguous(),
           bs_live_ring(s["ring"][:, :C * q_cap].int(), st_out, C, q_cap),
           s["heads"][:, :C].int(), s["W"], s["t_prev"], s["t_hol"],
           s["ovf"], s["ne"])
    return out, tagged, rec_t


def _bs_fail_step(s, arrival, service, cls, need, ft, ftgt, fup, C: int,
                  s_max: int, h: int, q_cap: int, jl=None):
    """One BS-FCFS drain-mode event per lane
    (``sim_jax._bs_fail_make_step`` statement for statement); updates the
    state dict ``s`` (with the failure cursor ``fi``) and returns the event
    record ``(tagged, rec_t)``.

    A fourth candidate event, the next breakdown (Tf), wins ties and
    claims the earliest-free capacity unit of its target block: the
    helper's W (target C), a free A slot of its class (which then fires
    as an ordinary A completion at ``t_up``, the repair), or, with the
    class fully busy, the argmin completion entry extended to ``t_up``.
    Trailing steps past a lane's events are no-ops: completions need
    ``Tc`` below ``0.5 * _BIG`` and arrivals need ``ai < jl`` (``jl`` [R]
    the lane's jobs; None: J).
    """
    R, J = arrival.shape
    F = ft.shape[1]
    dev = arrival.device
    lanes = torch.arange(R, device=dev)
    st, comp, ring, heads, W = s["st"], s["comp"], s["ring"], s["heads"], \
        s["W"]
    ai, fi, t_prev, t_hol = s["ai"], s["fi"], s["t_prev"], s["t_hol"]
    jl = J if jl is None else jl

    j_arr = ai.clamp(max=J - 1)
    Ta = torch.where(ai < jl, arrival[lanes, j_arr], _INF)
    cm = comp[:, :C * s_max].argmin(1)
    Tc = comp[lanes, cm]
    gh_job = heads[:, :C].min(1).values
    has_head = gh_job < J
    jh = gh_job.clamp(max=J - 1)
    nh = need[lanes, jh]
    Wn = W[lanes, (nh - 1).clamp(0, h - 1)]
    Th = torch.where(has_head,
                     torch.maximum(torch.maximum(arrival[lanes, jh], t_hol),
                                   torch.maximum(t_prev, Wn)),
                     _INF)
    fi_c = fi.clamp(max=F - 1)
    Tf = torch.where(fi < F, ft[lanes, fi_c], _INF)
    fc = ftgt[lanes, fi_c]
    fu = fup[lanes, fi_c]

    is_fail = (Tf <= Ta) & (Tf <= Tc) & (Tf <= Th) & (Tf < _INF)
    is_commit = ~is_fail & (Th <= Tc) & (Th <= Ta)
    is_comp = ~is_fail & ~is_commit & (Tc < Ta) & (Tc < 0.5 * _BIG)
    is_arr = ~is_fail & ~is_commit & ~is_comp & (ai < jl)
    s["fi"] = fi + is_fail.long()

    # arrival (rule 1), as in _bs_step
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

    # A completion: rule-3 pull
    c_comp = cm // s_max
    pull = heads[lanes, c_comp]
    can_pull = is_comp & (pull < J)
    jp = pull.clamp(max=J - 1)
    s["t_hol"] = torch.where(can_pull & (pull == gh_job),
                             torch.maximum(t_hol, Tc), t_hol)

    # failure target: the helper (fc == C) or class row fcc
    ar_s = torch.arange(s_max, device=dev)[None, :]
    fcc = fc.clamp(max=C - 1)
    helper_fail = is_fail & (fc == C)
    class_fail = is_fail & ~helper_fail
    free_f = st[lanes, fcc]
    row_f = comp.gather(1, fcc[:, None] * s_max + ar_s)
    pos_free = row_f.argmax(1)
    cmf = row_f.argmin(1)
    vmin = row_f[lanes, cmf]
    fail_free = class_fail & (free_f > 0)
    fail_busy = class_fail & ~(free_f > 0)

    # comp: the two entries of _bs_step plus the failure entry (disjoint:
    # on a failure step the first two drop)
    ins = has_slot | can_pull
    j_ins = torch.where(is_arr, j_arr, jp)
    t_ins = torch.where(is_arr, Ta, Tc)
    svc_ins = service[lanes, j_ins]
    row = comp.gather(1, c_arr[:, None] * s_max + ar_s)
    pos = row.argmax(1)
    oobc = C * s_max
    idx3 = torch.stack(
        [torch.where(is_comp & ~can_pull, cm, oobc),
         torch.where(has_slot, c_arr * s_max + pos,
                     torch.where(can_pull, cm, oobc)),
         torch.where(fail_free, fcc * s_max + pos_free,
                     torch.where(fail_busy, fcc * s_max + cmf, oobc))], 1)
    val3 = torch.stack([torch.full_like(t_ins, _BIG), t_ins + svc_ins,
                        torch.where(fail_free, fu,
                                    torch.maximum(vmin, fu))], 1)
    comp.scatter_(1, idx3, val3)

    # helper commit and helper drain (disjoint lane masks), both from the
    # W of the step's start
    comp_h = Th + service[lanes, jh]
    p = (W <= comp_h[:, None]).sum(1)[:, None] - nh[:, None]
    ar = torch.arange(h, device=dev)[None, :]
    nh_ = nh[:, None]
    W_roll = W.gather(1, torch.where(ar < p, ar + nh_, ar).clamp(max=h - 1))
    W2 = torch.where((ar >= p) & (ar < p + nh_), comp_h[:, None], W_roll)
    comp_f = torch.maximum(W[:, 0], fu)
    pf = (W <= comp_f[:, None]).sum(1)[:, None] - 1
    W_roll_f = W.gather(1, torch.where(ar < pf, ar + 1, ar).clamp(max=h - 1))
    Wf = torch.where(ar == pf, comp_f[:, None], W_roll_f)
    s["W"] = torch.where(is_commit[:, None], W2,
                         torch.where(helper_fail[:, None], Wf, W))
    s["t_prev"] = torch.where(is_commit, Th, t_prev)

    # counters: the three entries of _bs_step plus a class drain's claim
    # of a free slot
    did_pop = can_pull | is_commit
    pop_c = torch.where(can_pull, c_comp, cls[lanes, jh])
    oobs = 3 * C
    idx4 = torch.stack(
        [torch.where(is_arr, c_arr, torch.where(is_comp, c_comp, oobs)),
         torch.where(enq, 2 * C + c_arr, oobs),
         torch.where(did_pop, C + pop_c, oobs),
         torch.where(fail_free, fcc, oobs)], 1)
    one = torch.ones_like(ai)
    val4 = torch.stack(
        [torch.where(has_slot, -1, 0) + (is_comp & ~can_pull).long(),
         one, one, -one], 1)
    st.scatter_add_(1, idx4, val4)

    # per-class head jobs, as in _bs_step
    g0 = st[lanes, C + pop_c]
    g1 = st[lanes, 2 * C + pop_c]
    nxt = torch.where(g0 < g1, ring[lanes, pop_c * q_cap + g0 % q_cap], J)
    hidx = torch.stack(
        [torch.where(enq & (head_c == tail_c), c_arr, C),
         torch.where(did_pop, pop_c, C)], 1)
    heads.scatter_(1, hidx, torch.stack([j_arr, nxt], 1))

    tagged = torch.where(is_commit, jh + 2 * J,
                         torch.where(ins, j_ins,
                                     torch.where(enq, j_arr + J, -1)))
    rec_t = torch.where(is_commit, Th, t_ins)
    return tagged, rec_t


def _bs_fail_core(arrival, cls, need, service, ft, ftgt, fup, slots,
                  s_max: int, h: int, q_cap: int, length: int, h_lane=None,
                  j_live=None):
    """BS-FCFS sample paths with drained-capacity failure events
    (``sim_jax._bs_fail_core``).

    ``ft``/``ftgt``/``fup`` [R, F] are the chronological failure records
    of :func:`repro_torch.core.failures.partition_targets` (F >= 1; pad
    rows carry ``ft = +inf`` and never fire).  The scan runs ``length`` =
    2J + F + F_A steps.  ``slots``, ``h_lane`` and ``j_live`` as in
    :func:`_bs_core`.  Returns ``(tagged [R, length] int32,
    rec_t [R, length] float64, ovf [R] bool)``.
    """
    R, J = arrival.shape
    C = slots.shape[-1]
    s = _bs_init(R, J, C, s_max, h, q_cap, slots, h_lane)
    jl = _lanes(j_live, R, arrival.device, J)
    s["fi"] = torch.zeros(R, dtype=torch.int64, device=arrival.device)
    cls = cls.long()
    need = need.long()
    ftgt = ftgt.long()
    tagged = torch.empty(R, length, dtype=torch.int32,
                         device=arrival.device)
    rec_t = torch.empty(R, length, dtype=_F64, device=arrival.device)
    for e in range(length):
        tagged[:, e], rec_t[:, e] = _bs_fail_step(
            s, arrival, service, cls, need, ft, ftgt, fup, C, s_max, h,
            q_cap, jl)
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


# --------------------------------------------------------------------------
# Preemptive SRPT family: ServerFilling-SRPT (sf) and FirstFit-SRPT (ff)
#
# At every event (an arrival, or the earliest departure) the in-system jobs
# are re-ranked — rank = current remaining work (ff) or remaining x need
# (sf), ties by arrival time, then by slot — and the desired running set is
# recomputed: ff packs first-fit over the rank order; sf takes the shortest
# rank prefix M whose cumulative need reaches k (all jobs when the total
# need is below k) and packs it first-fit in (-need, rank) order.  Running
# jobs outside the set are preempted (remaining work frozen), desired jobs
# not running start.  Exactly 2J events exist per lane.
#
# The slot table is one [R, Q, 8] float64 tensor with the reference's
# columns (_SRPT_COLS): job id (-1 = empty), arrival, need, remaining work,
# run start, running, started, first start.
# --------------------------------------------------------------------------

_SRPT_COLS = 8  # job, arrival, need, rem, run_start, running, started, fstart


def _lexsort_perm(keys, perm=None):
    """Stable ascending lexicographic order of [R, Q] key rows.

    Returns the permutation [R, Q] int64 (position -> original index).
    ``perm`` is the starting order (identity when None); it breaks every
    tie left by the keys.  Built from stable single-key ``torch.sort``
    passes, least significant key first — so the result equals
    ``jax.lax.sort(..., num_keys=len(keys), is_stable=True)`` and the
    stable bitonic network with the index as its final key.
    """
    R, Q = keys[0].shape
    if perm is None:
        perm = torch.arange(Q, device=keys[0].device).expand(R, Q)
    for key in reversed(keys):
        order = torch.sort(key.gather(1, perm), dim=1, stable=True).indices
        perm = perm.gather(1, order)
    return perm


def _srpt_first_fit(kk, need_w, cand, NU: tuple):
    """Vectorized first-fit packing walk over pre-ordered candidates.

    ``need_w`` [R, Q] holds the candidate needs in packing order (0 for
    empty slots), ``cand`` [R, Q] the candidate mask, ``kk`` [R] the free
    servers and ``NU`` the ascending tuple of distinct need values.
    Returns the taken mask, equal to the sequential walk ``for j in order:
    if need[j] <= free: take; free -= need[j]`` (``sim_jax._srpt_first_fit``
    op for op: a round takes, among the jobs with need <= u = the largest
    need value <= F, the prefix whose running need sum fits, so u strictly
    falls and len(NU) rounds finish any walk).
    """
    R, Q = need_w.shape
    dev = need_w.device
    pos = torch.arange(Q, device=dev)[None, :]
    F = kk
    take = torch.zeros(R, Q, dtype=torch.bool, device=dev)
    ptr = torch.zeros(R, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=_F64, device=dev)
    for _ in range(len(NU)):
        u = torch.zeros_like(F)
        for v in NU:  # ascending: ends at the largest need value <= F
            u = torch.where(v <= F, float(v), u)
        elig = (cand & ~take & (need_w >= 1.0) & (need_w <= u[:, None])
                & (pos >= ptr[:, None]))
        csum = torch.cumsum(torch.where(elig, need_w, zero), dim=1)
        newt = elig & (F[:, None] - (csum - need_w) >= u[:, None])
        take = take | newt
        F = F - torch.where(newt, need_w, zero).sum(1)
        missed = elig & ~newt
        ptr = torch.where(missed.any(1), missed.to(torch.int8).argmax(1),
                          Q)
    return take


def _srpt_prefix_m(kk, need_s, occ_s):
    """ServerFilling's candidate prefix over the sort-1 order: the shortest
    rank prefix whose cumulative need reaches ``kk`` -> (in_M [R, Q] bool,
    has_m [R] bool; without it every job runs)."""
    Q = need_s.shape[1]
    pos = torch.arange(Q, device=need_s.device)[None, :]
    cum = torch.cumsum(torch.where(occ_s, need_s, 0.0), dim=1)
    has_m = cum[:, -1] >= kk
    idx_m = (cum >= kk[:, None]).to(torch.int8).argmax(1)
    return occ_s & (pos <= idx_m[:, None]), has_m


def _srpt_sf_take(kk, rk_s, need_s, occ_s, NU: tuple):
    """ServerFilling's running set as the reference forms it: M re-sorted
    by (-need, rank, position) and packed first-fit.  ``rk_s``, ``need_s``,
    ``occ_s`` [R, Q] are in sort-1 order; returns (take [R, Q] in sort-1
    positions, has_m [R])."""
    in_M, has_m = _srpt_prefix_m(kk, need_s, occ_s)
    key1 = torch.where(in_M, -need_s, _BIG)
    perm = _lexsort_perm((key1, rk_s))
    take_w = _srpt_first_fit(kk, need_s.gather(1, perm),
                             key1.gather(1, perm) < 0.5 * _BIG, NU)
    return torch.zeros_like(take_w).scatter_(1, perm, take_w), has_m


def _srpt_init(R: int, Q: int, device):
    """Empty slot table + counters: (arrival cursor, S [R, Q, 8], ovf,
    preemptions, processed events, peak in-system count)."""
    S = torch.zeros(R, Q, _SRPT_COLS, dtype=_F64, device=device)
    S[..., 0] = -1.0
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.zeros(R, dtype=torch.int64, device=device), S,
            torch.zeros(R, dtype=torch.bool, device=device),
            torch.zeros(R, **i32), torch.zeros(R, **i32),
            torch.zeros(R, **i32))


def _srpt_step(carry, arrival, need, service, kk, NU: tuple, sf: bool,
               jl=None):
    """One event per lane of ``sim_jax._srpt_make_step``, statement for
    statement.  Returns the new carry and the record (job, t, fstart) —
    job -1.0 with t = fstart = 0 on steps that are not departures.
    ``jl`` [R]: the lane's jobs (None: J); it never admits one past them."""
    ai, S, ovf, npre, ne, peak = carry
    R, J = arrival.shape
    jl = J if jl is None else jl
    Q = S.shape[1]
    dev = S.device
    lanes = torch.arange(R, device=dev)
    zero = torch.zeros((), dtype=_F64, device=dev)
    job, s_rem, s_rs = S[..., 0], S[..., 3], S[..., 4]
    s_run = S[..., 5] > 0

    # candidate events: the next arrival against the earliest departure
    # (run_start + rem, the oracle's addition); an arrival wins ties
    j_arr = ai.clamp(max=J - 1)
    a_arr = arrival[lanes, j_arr]
    Ta = torch.where(ai < jl, a_arr, _INF)
    comp = torch.where(s_run, s_rs + s_rem, _BIG)
    qd = comp.argmin(1)
    Tc = comp[lanes, qd]
    is_arr = (ai < jl) & (Ta <= Tc)
    is_dep = ~is_arr & (Tc < 0.5 * _BIG)
    active = is_arr | is_dep
    ne = ne + active.int()
    t = torch.where(is_arr, Ta, Tc)

    # departure record, read before the slot is cleared
    dep = S[lanes, qd]
    job_out = torch.where(is_dep, dep[:, 0], -1.0)
    t_out = torch.where(is_dep, Tc, zero)
    fs_out = torch.where(is_dep, dep[:, 7], zero)

    # admit the arrival into the first free slot, or clear the departed
    # slot; an arrival that finds no free slot is dropped and flags ovf
    free = job < 0
    fs = free.to(torch.int8).argmax(1)
    has_free = free[lanes, fs]
    do_ins = is_arr & has_free
    ovf = ovf | (is_arr & ~has_free)
    idx = torch.where(do_ins, fs, torch.where(is_dep, qd, Q))
    vals = torch.zeros(R, _SRPT_COLS, dtype=_F64, device=dev)
    vals[:, 0] = torch.where(is_arr, j_arr.to(_F64), -1.0)
    vals[:, 1] = torch.where(is_arr, a_arr, zero)
    vals[:, 2] = torch.where(is_arr, need[lanes, j_arr], zero)
    vals[:, 3] = torch.where(is_arr, service[lanes, j_arr], zero)
    hit = idx < Q
    S[lanes[hit], idx[hit]] = vals[hit]     # in place: S is the scan's own
    ai = ai + is_arr.long()
    job, s_arr, s_need, s_rem = S[..., 0], S[..., 1], S[..., 2], S[..., 3]
    s_rs, s_run = S[..., 4], S[..., 5] > 0
    s_started, s_fstart = S[..., 6] > 0, S[..., 7]
    occ = job >= 0
    # a dropped arrival still counts: on overflow the peak is the capacity
    # the run needed (a lower bound)
    peak = torch.maximum(
        peak, (occ.sum(1) + (is_arr & ~has_free).long()).int())

    # reconcile at t: rank-sort the in-system jobs, pick the running set
    cur_rem = torch.where(
        s_run, torch.maximum(zero, s_rem - (t[:, None] - s_rs)), s_rem)
    rank = cur_rem * s_need if sf else cur_rem
    rk = torch.where(occ, rank, _INF)
    ak = torch.where(occ, s_arr, _INF)
    slot_s = _lexsort_perm((rk, ak))
    rk_s = rk.gather(1, slot_s)
    need_s = s_need.gather(1, slot_s)
    occ_s = rk_s < 0.5 * _BIG
    desired = torch.zeros(R, Q, dtype=torch.bool, device=dev)
    if sf:
        take, has_m = _srpt_sf_take(kk, rk_s, need_s, occ_s, NU)
        desired.scatter_(1, slot_s, take)
        desired = torch.where(has_m[:, None], desired, occ)
    else:
        take = _srpt_first_fit(kk, need_s, occ_s, NU)
        desired.scatter_(1, slot_s, take)

    act = active[:, None]
    to_pre = act & s_run & ~desired
    to_start = act & desired & ~s_run
    npre = npre + to_pre.sum(1).int()
    tt = t[:, None].expand(R, Q)
    S = torch.stack(
        [job, s_arr, s_need,
         torch.where(to_pre, cur_rem, s_rem),
         torch.where(to_start, tt, s_rs),
         torch.where(act, desired, s_run).to(_F64),
         (s_started | to_start).to(_F64),
         torch.where(to_start & ~s_started, tt, s_fstart)], dim=2)
    return (ai, S, ovf, npre, ne, peak), (job_out, t_out, fs_out)


def _srpt_core(arrival, need, service, kk, Q: int, NU: tuple, sf: bool,
               j_live=None):
    """Full-trace SRPT event scan: 2J steps from an empty system.

    ``arrival``, ``need``, ``service`` [R, J] float64, ``kk`` [R] float64
    servers, ``j_live`` [R] the lane's jobs (None: J; the rest are padding
    it never admits, and steps past its 2 j_live events record nothing).
    Returns the departure-record streams ``(job_ev, t_ev,
    fs_ev)`` [R, 2J] float64 (-1 job ids mark non-departure steps) and the
    per-lane counters ``ovf`` [R] bool (slot-table overflow), ``npre``
    (preemptions), ``ne`` (processed events, 2J on success) and ``peak``
    (peak in-system count), [R] int32.
    """
    R, J = arrival.shape
    dev = arrival.device
    carry = _srpt_init(R, Q, dev)
    jl = _lanes(j_live, R, dev, J)
    job_ev = torch.empty(R, 2 * J, dtype=_F64, device=dev)
    t_ev = torch.empty(R, 2 * J, dtype=_F64, device=dev)
    fs_ev = torch.empty(R, 2 * J, dtype=_F64, device=dev)
    for e in range(2 * J):
        carry, (job_ev[:, e], t_ev[:, e], fs_ev[:, e]) = _srpt_step(
            carry, arrival, need, service, kk, NU, sf, jl)
    _, _, ovf, npre, ne, peak = carry
    return job_ev, t_ev, fs_ev, ovf, npre, ne, peak


def _srpt_scatter_events(J: int, job_ev, t_ev, fs_ev):
    """Scatter [R, 2J] departure records to per-job [R, J] numpy arrays
    (completion, first start); each job departs exactly once."""
    job_ev = np.asarray(job_ev)
    jobs = job_ev.astype(np.int64)
    valid = jobs >= 0
    rows = np.broadcast_to(np.arange(job_ev.shape[0])[:, None],
                           job_ev.shape)[valid]
    cols = jobs[valid]
    comp = np.zeros((job_ev.shape[0], J))
    fstart = np.zeros((job_ev.shape[0], J))
    comp[rows, cols] = np.asarray(t_ev)[valid]
    fstart[rows, cols] = np.asarray(fs_ev)[valid]
    return comp, fstart


def _srpt_args(batch, queue_cap) -> int:
    """The slot-table capacity ``Q`` of an SRPT scan.

    Default ``max(4k, 256)``, capped at J and rounded up to a power of two,
    as the reference's.  Results do not depend on Q unless the in-system
    count exceeds it, which raises after the scan.  The CUDA kernel keeps
    the table in shared memory up to Q = 4096 and in global scratch above.
    """
    J = int(batch.num_jobs)
    if queue_cap is None:
        queue_cap = max(4 * int(batch.k), 256)
    elif queue_cap < 1:
        raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
    q = max(1, min(J, int(queue_cap)))
    return 1 << (q - 1).bit_length()


# --------------------------------------------------------------------------
# The single-trace API (``sim_jax``'s wrappers).  Imports of ``engines``,
# ``sim_batch`` and ``workload`` are local: they import this module.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimResult:
    """One sample path's results (the reference's ``JaxSimResult``)."""

    response: np.ndarray        # [J] response time per job
    p_helper: float | None      # fraction SERVED on helpers (BSF only)
    blocked: np.ndarray | None  # [J] bool, loss queue and ModBS only
    p_routed: float | None = None  # fraction routed to H on arrival (BSF);
                                   # > p_helper under Def.-1 pull-backs
    start: np.ndarray | None = None  # [J] raw start times (BS-FCFS only)

    @property
    def mean_response(self) -> float:
        return float(self.response.mean())


def _as_batch(trace):
    """The trace as a one-replication batch (the registry cores' input)."""
    from .workload import BatchTrace

    return BatchTrace(arrival=trace.arrival[None], cls=trace.cls[None],
                      service=trace.service[None], need=trace.need[None],
                      k=trace.k, C=trace.C)


def loss_queue_sim(arrival, service, s: int, *, device="cuda") -> SimResult:
    """Exact M/GI/s/s sample path of one [J] trace: the per-job blocked
    mask, and response = service where admitted, 0 where blocked.  Runs
    the ``loss_scan`` kernel on the card, its plain version with
    ``device="cpu"``."""
    from .sim_batch import loss_queue_sim_batch

    res = loss_queue_sim_batch(np.asarray(arrival)[None],
                               np.asarray(service)[None], s, device=device)
    return SimResult(response=res.response[0], p_helper=None,
                     blocked=res.blocked[0])


def fcfs_sim(trace, engine: str = "torch", *, device="cuda") -> SimResult:
    """Multiserver-job FCFS (head-of-line blocking), exact sample path,
    through the registry's ``(fcfs, engine)`` core."""
    from . import engines

    return engines.simulate("fcfs", _as_batch(trace), engine=engine,
                            device=device).rep(0)


def modified_bs_sim(trace, partition=None, wl=None, engine: str = "torch",
                    *, device="cuda") -> SimResult:
    """ModifiedBS-FCFS (Definition 2), exact sample path."""
    from . import engines

    return engines.simulate("modbs-fcfs", _as_batch(trace), engine=engine,
                            device=device, partition=partition,
                            wl=wl).rep(0)


def bs_sim(trace, partition=None, wl=None, queue_cap: int | None = None,
           engine: str = "torch", *, device="cuda") -> SimResult:
    """BS-FCFS (Definition 1, rule-3 pull-backs), exact sample path.

    ``queue_cap`` bounds the per-class helper-wait rings (default
    ``min(J, 8192)``); an overflow raises rather than returning a wrong
    path.
    """
    from . import engines

    return engines.simulate("bs-fcfs", _as_batch(trace), engine=engine,
                            device=device, partition=partition, wl=wl,
                            queue_cap=queue_cap).rep(0)


def estimate_p_helper(wl, num_jobs: int = 200_000, seed: int = 0,
                      reps: int = 1, *, device=None) -> float:
    """Monte-Carlo P_H^{ModifiedBS-π} (the Cor.-1 upper bound): ``reps``
    Philox replications of ``num_jobs`` arrivals, averaged.  Runs the
    ``modbs_scan`` kernel on the card (``device=None`` or ``"cuda"``),
    its plain version with ``device="cpu"``."""
    from .sim_batch import modified_bs_sim_batch

    batch = wl.sample_traces(num_jobs, reps, seed=seed)
    res = modified_bs_sim_batch(batch, wl=wl, device=device or "cuda")
    return float(res.p_helper.mean())
