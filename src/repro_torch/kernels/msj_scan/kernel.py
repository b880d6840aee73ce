"""Wrappers of the hand-written msj_scan CUDA kernels, beside their plain
PyTorch versions.

Each wrapper takes the trace as [R, J] tensors (float64 times, int32 class
ids and needs; float64 needs for SRPT) plus the partition's ``slots`` [C]
int32 or the SRPT servers ``kk`` [R], exactly the signatures and outputs
of the reference's Pallas kernels (``repro/kernels/msj_scan/kernel.py``,
``srpt.py``; ``stable_sort_fwd`` is the standalone entry to the SRPT
kernel's sort, the counterpart of ``sort.py``'s ``bitonic_sort``).  The
drain-mode ``*_fail_scan_fwd`` wrappers take the host-merged
arrival+failure stream [R, L] (``t_up`` float64, ``is_fail`` bool), or for
BS-π the trace plus the failure records [R, F].  The carried
``*_stream_fwd`` wrappers run one chunk of a stream: they take the carry
the previous chunk gave out and give out the next, in the port's
canonical form on both devices (``repro_torch.core.stream``).
``loss_scan_fwd`` runs the M/GI/s/s loss queue ([R, J] arrival and
service, ``s`` servers), which the reference computes as a ``lax.scan``
with no Pallas kernel (``sim_jax._loss_core``).

A grid stacks cells of different sizes on the R axis (lanes), so each
wrapper also takes per-lane sizes, int32 [R] tensors: ``k_lane`` (FCFS
servers), ``h_lane`` (helper servers), ``j_live`` (the lane's jobs; BS-π
and SRPT never admit one past them), and ``slots`` as [R, C].  The scalar
``k``, ``h``, ``s_max``, J and C are then their maxima, as the reference's
grid plans pad them (dead servers, permanently busy slots, sentinel jobs);
left out, every lane has the scalar sizes.  Each wrapper checks device,
dtype, shape and contiguity, then

* for CPU tensors returns its plain version (``*_ref``: the
  :mod:`repro_torch.core.sim_torch` event scans);
* for CUDA tensors allocates the outputs (and the scratch: the BS rings,
  an SRPT slot table too large for shared memory), launches
  the kernel of ``csrc/msj_scan.cu`` or
  ``csrc/srpt_scan.cu`` on the current stream,
  raises if the launch is refused, and adds one to its ``launches``
  count.  There is no fallback: a CUDA tensor never reaches the plain
  version through a wrapper.

The scan kernels run one warp per replication with the whole event
loop inside the kernel (``stable_sort_fwd``: one block per row); see
each source's header note for what bounds them and where bit-identity
with the reference needs care.  The FCFS kernels take k <=
:data:`FCFS_K_MAX` (12 bytes of shared memory a server past the first
128).
"""

from __future__ import annotations

import ctypes

import torch

from ...core import sim_torch
from . import build

_F64, _I32 = torch.float64, torch.int32
#: the longest trace whose BS event tags (up to 3J) fit in int32
_J_MAX = (2**31 - 1) // 3


# -- plain versions ----------------------------------------------------------


def loss_scan_ref(arrival, service, *, s: int):
    """Plain M/GI/s/s scan: [R, J] arrival/service -> blocked [R, J]
    bool."""
    return sim_torch._loss_core(arrival, service, s)


def fcfs_scan_ref(arrival, need, service, *, k: int, k_lane=None):
    """Plain FCFS scan: [R, J] arrays -> start times [R, J]."""
    return sim_torch._fcfs_core(arrival, need, service, k, k_lane)


def modbs_scan_ref(arrival, cls, need, service, slots, *, s_max: int,
                   h: int, h_lane=None):
    """Plain ModifiedBS-π scan -> (blocked [R, J] bool, starts [R, J])."""
    return sim_torch._modbs_core(arrival, cls, need, service, slots, s_max,
                                 h, h_lane)


def bs_scan_ref(arrival, cls, need, service, slots, *, s_max: int, h: int,
                q_cap: int, h_lane=None, j_live=None):
    """Plain BS-π event scan -> (tagged [R, 2J] int32, rec_t [R, 2J],
    ovf [R] bool)."""
    return sim_torch._bs_core(arrival, cls, need, service, slots, s_max, h,
                              q_cap, h_lane, j_live)


def fcfs_fail_scan_ref(t, need, svc, t_up, is_fail, *, k: int,
                       k_lane=None):
    """Plain FCFS drain scan: merged [R, L] stream -> starts [R, L]."""
    return sim_torch._fcfs_fail_core(t, need, svc, t_up, is_fail, k, k_lane)


def modbs_fail_scan_ref(t, cls, need, svc, t_up, is_fail, slots, *,
                        s_max: int, h: int, h_lane=None):
    """Plain ModifiedBS-π drain scan -> (blocked [R, L], starts [R, L])."""
    return sim_torch._modbs_fail_core(t, cls, need, svc, t_up, is_fail,
                                      slots, s_max, h, h_lane)


def bs_fail_scan_ref(arrival, cls, need, service, ft, ftgt, fup, slots, *,
                     s_max: int, h: int, q_cap: int, length: int,
                     h_lane=None, j_live=None):
    """Plain BS-π drain scan -> (tagged [R, length] int32,
    rec_t [R, length], ovf [R] bool)."""
    return sim_torch._bs_fail_core(arrival, cls, need, service, ft, ftgt,
                                   fup, slots, s_max, h, q_cap, length,
                                   h_lane, j_live)


def fcfs_stream_ref(arrival, need, service, W, t_prev):
    """Plain FCFS chunk scan from the carry (W [R, k], t_prev [R]) ->
    (starts [R, J], W' [R, k], t_prev' [R]), the carry canonical."""
    W, t_prev, starts = sim_torch._fcfs_stream_core(W, t_prev, arrival,
                                                    need, service)
    return starts, W, t_prev


def modbs_stream_ref(arrival, cls, need, service, comp, W, t_prev):
    """Plain ModifiedBS-π chunk scan from the carry (comp [R, C, s_max],
    W [R, h], t_prev [R]) -> (blocked, starts [R, J], comp', W',
    t_prev'), the carry canonical."""
    comp, W, t_prev, blocked, starts = sim_torch._modbs_stream_core(
        comp, W, t_prev, arrival, cls, need, service)
    return blocked, starts, comp, W, t_prev


def bs_stream_ref(arrival, cls, need, service, slots, horizon, carry, *,
                  s_max: int, h: int, q_cap: int, length: int):
    """Plain BS-π chunk scan from the reference's chunk carry -> (carry',
    tagged [R, length] int32, rec_t [R, length]); ``slots`` [C] gives
    the class count (the carry's ``st`` holds the free slots)."""
    return sim_torch._bs_stream_core(arrival, cls, need, service, horizon,
                                     carry, slots.shape[0], s_max, h, q_cap,
                                     length)


def srpt_scan_ref(arrival, need, service, kk, *, Q: int, NU: tuple,
                  sf: bool, j_live=None):
    """Plain SRPT event scan -> (job_ev, t_ev, fs_ev [R, 2J] float64,
    ovf [R] bool, npre, ne, peak [R] int32)."""
    return sim_torch._srpt_core(arrival, need, service, kk, Q, NU, sf,
                                j_live)


def stable_sort_ref(*operands, num_keys: int):
    """Plain stable ascending sort of [R, W] rows: the first ``num_keys``
    operands are float64 keys compared lexicographically, the last an
    int32 payload; ties keep the input order."""
    perm = sim_torch._lexsort_perm(operands[:num_keys])
    return tuple(x.gather(1, perm) for x in operands)


# -- checks and launch plumbing ---------------------------------------------


_DTYPES = {"arrival": _F64, "service": _F64, "cls": _I32, "need": _I32,
           "t": _F64, "svc": _F64, "t_up": _F64, "is_fail": torch.bool,
           "ft": _F64, "ftgt": _I32, "fup": _F64}
_SRPT_DTYPES = dict(_DTYPES, need=_F64)
_SORT_W_MAX = 4096
#: bytes of one BS ring entry: (arrival, service) float64 and (job id,
#: need) int32 (``csrc/msj_scan.cu``, ``bs_rings``)
_BS_RING_ENTRY = 24
#: shared memory one thread block can use on an H100 (227 KiB)
_SMEM_MAX = 232_448
#: the FCFS kernels' free-time state (``csrc/msj_scan.cu``, ``RunState``)
#: keeps up to 128 groups in registers and spills a server's slot past
#: them to shared memory: a float64 value and a 32-bit count, 12 bytes
_SPILL_BYTES = 12


def _spill_bytes(m: int) -> int:
    """Shared-memory bytes of the state of m servers
    (``msj_spill_slots``)."""
    return _SPILL_BYTES * 32 * max(0, -(-m // 32) - 4)


#: the most servers the FCFS kernels take (19 488)
FCFS_K_MAX = 32 * (_SMEM_MAX // (32 * _SPILL_BYTES) + 4)


def _check(slots=None, dtypes=_DTYPES, **named) -> torch.device:
    """Validate the [R, J] inputs (and ``slots``); their common device.
    The first named tensor sets the shape the others must have."""
    first = next(iter(named.values()))
    if first.dim() != 2:
        raise ValueError(f"trace arrays must be [R, J], got "
                         f"{tuple(first.shape)}")
    if first.shape[1] > _J_MAX:
        raise ValueError(f"J={first.shape[1]} exceeds {_J_MAX}")
    for name, t in named.items():
        if t.shape != first.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(first.shape)}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if slots is not None:
        if (slots.dim() not in (1, 2) or slots.dtype != _I32
                or not slots.is_contiguous()):
            raise TypeError("slots must be a contiguous 1-D [C] or 2-D "
                            "[R, C] int32 tensor")
        if slots.dim() == 2 and slots.shape[0] != first.shape[0]:
            raise ValueError(f"slots has {slots.shape[0]} rows, expected "
                             f"R={first.shape[0]}")
        if slots.device != first.device:
            raise ValueError(f"slots is on {slots.device}, expected "
                             f"{first.device}")
    dev = first.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; expected cpu or cuda")
    return dev


def _check_lanes(R: int, dev: torch.device, **sizes) -> None:
    """Validate per-lane sizes: each None, or a contiguous int32 [R]
    tensor on ``dev`` whose values lie in its (lo, hi) range."""
    for name, (x, lo, hi) in sizes.items():
        if x is None:
            continue
        if (x.shape != (R,) or x.dtype != _I32 or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [R]={R} "
                             f"tensor on {dev}")
        if R and (int(x.min()) < lo or int(x.max()) > hi):
            raise ValueError(f"{name} must lie in [{lo}, {hi}]")


def _lane_sizes(x, R: int, dev: torch.device, default: int):
    """The kernel's [R] int32 per-lane sizes: ``x``, or ``default`` in
    every lane."""
    if x is not None:
        return x
    return torch.full((R,), default, dtype=_I32, device=dev)


def _slot_rows(slots, R: int):
    """The kernel's [R, C] slots: a row per lane (a [C] tensor in every
    lane)."""
    return slots if slots.dim() == 2 else slots.expand(R, -1).contiguous()


def _fcfs_fits(k: int) -> None:
    if k > FCFS_K_MAX:
        raise ValueError(f"k={k} exceeds {FCFS_K_MAX}: the FCFS kernel "
                         f"spills {_SPILL_BYTES} bytes a server past its "
                         f"first 128 into one block's shared memory "
                         f"({_SMEM_MAX} bytes on an H100)")


#: the most servers the loss-queue kernel takes: their completion times,
#: 8 bytes each, fill one block's shared memory (29 056)
LOSS_S_MAX = _SMEM_MAX // 8


def _loss_fits(s: int) -> None:
    if s > LOSS_S_MAX:
        raise ValueError(f"s={s} exceeds {LOSS_S_MAX}: the loss-queue "
                         f"kernel keeps the s completion times, 8 bytes "
                         f"each, in one block's shared memory ({_SMEM_MAX} "
                         f"bytes on an H100)")


def _modbs_fits(C: int, s_max: int, h: int) -> None:
    need = 8 * C * s_max + _spill_bytes(h)
    if need > _SMEM_MAX:
        raise ValueError(f"C={C}, s_max={s_max}, h={h} need {need} bytes of "
                         f"shared memory (the class rows, 8 C s_max, and the "
                         f"helper's spill, {_SPILL_BYTES} bytes a server past "
                         f"128); one block has {_SMEM_MAX} on an H100")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# -- wrappers ----------------------------------------------------------------


def loss_scan_fwd(arrival, service, *, s: int):
    """arrival/service [R, J] float64 -> blocked [R, J] bool.

    The M/GI/s/s loss queue (Property 1's building block): job j is
    blocked when all s servers are busy at its arrival (every completion
    time > A_j); otherwise it takes the earliest-free server until
    A_j + S_j.  ``s`` must lie in [1, :data:`LOSS_S_MAX`] on the card
    (>= 1 on the CPU).
    """
    dev = _check(arrival=arrival, service=service)
    if s < 1:
        raise ValueError(f"the loss queue needs s >= 1 servers, got {s}")
    if dev.type == "cpu":
        return loss_scan_ref(arrival, service, s=s)
    _loss_fits(s)
    R, J = arrival.shape
    blocked = torch.empty(R, J, dtype=torch.bool, device=dev)
    if R == 0 or J == 0:
        return blocked
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_loss_scan(_ptr(arrival), _ptr(service), _ptr(blocked),
                               R, J, s, _stream(dev))
    build.LIBRARY.raise_on(rc, "loss_scan", f"R={R} J={J} s={s}")
    loss_scan_fwd.launches += 1
    return blocked


def fcfs_scan_fwd(arrival, need, service, *, k: int, k_lane=None):
    """arrival/need/service [R, J] -> start times [R, J] float64.

    Multiserver-job FCFS (Kiefer–Wolfowitz): job j with need n starts at
    max(A_j, T_{j-1}, W[n-1]) on the sorted free-time vector W of the k
    servers, then n copies of its completion are rolled into W.  Lane r
    has ``k_lane[r]`` live servers (None: k), the rest dead.
    """
    dev = _check(arrival=arrival, need=need, service=service)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    R, J = arrival.shape
    _check_lanes(R, dev, k_lane=(k_lane, 1, k))
    if dev.type == "cpu":
        return fcfs_scan_ref(arrival, need, service, k=k, k_lane=k_lane)
    _fcfs_fits(k)
    starts = torch.empty_like(arrival)
    if R == 0 or J == 0:
        return starts
    kl = _lane_sizes(k_lane, R, dev, k)
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_fcfs_scan(_ptr(arrival), _ptr(need), _ptr(service),
                               _ptr(kl), _ptr(starts), R, J, k,
                               _stream(dev))
    build.LIBRARY.raise_on(rc, "fcfs_scan", f"R={R} J={J} k={k}")
    fcfs_scan_fwd.launches += 1
    return starts


def modbs_scan_fwd(arrival, cls, need, service, slots, *, s_max: int,
                   h: int, h_lane=None):
    """[R, J] trace arrays + slots [C] or [R, C] -> (blocked [R, J] bool,
    starts [R, J] float64).

    ModifiedBS-π (Definition 2): per-class loss queues of ``slots[c]``
    slots (rows padded to ``s_max``); a job that finds its class full is
    blocked and served by FCFS on the h helper servers (``h_lane[r]`` of
    them live in lane r; None: h).
    """
    dev = _check(slots, arrival=arrival, cls=cls, need=need,
                 service=service)
    if s_max < 1 or h < 1:
        raise ValueError(f"s_max and h must be >= 1, got {s_max}, {h}")
    R, J = arrival.shape
    _check_lanes(R, dev, h_lane=(h_lane, 1, h))
    if dev.type == "cpu":
        return modbs_scan_ref(arrival, cls, need, service, slots,
                              s_max=s_max, h=h, h_lane=h_lane)
    C = slots.shape[-1]
    _modbs_fits(C, s_max, h)
    blocked = torch.empty(R, J, dtype=torch.bool, device=dev)
    starts = torch.empty_like(arrival)
    if R == 0 or J == 0:
        return blocked, starts
    sl, hl = _slot_rows(slots, R), _lane_sizes(h_lane, R, dev, h)
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_modbs_scan(_ptr(arrival), _ptr(cls), _ptr(need),
                                _ptr(service), _ptr(sl), _ptr(hl),
                                _ptr(blocked), _ptr(starts), R, J, C, s_max,
                                h, _stream(dev))
    build.LIBRARY.raise_on(rc, "modbs_scan",
                           f"R={R} J={J} C={C} s_max={s_max} h={h}")
    modbs_scan_fwd.launches += 1
    return blocked, starts


def bs_scan_fwd(arrival, cls, need, service, slots, *, s_max: int, h: int,
                q_cap: int, h_lane=None, j_live=None):
    """[R, J] trace arrays + slots [C] or [R, C] -> (tagged [R, 2J] int32,
    rec_t [R, 2J] float64, ovf [R] bool).

    BS-π (Definition 1) as the 2J-event scan.  ``tagged`` encodes each
    event: j = job j started in its A_i at ``rec_t``, j + J = job j was
    routed to H on arrival, j + 2J = job j started on a helper at
    ``rec_t``, -1 = no record.  ``ovf`` flags a helper-wait ring that
    outgrew ``q_cap``; the caller must raise on it.  Lane r has
    ``h_lane[r]`` live helper servers (None: h) and ``j_live[r]`` jobs
    (None: J): it runs 2 j_live events and records (-1, Tc) past them.
    """
    dev = _check(slots, arrival=arrival, cls=cls, need=need,
                 service=service)
    if s_max < 1 or h < 1 or q_cap < 1:
        raise ValueError(f"s_max, h and q_cap must be >= 1, got {s_max}, "
                         f"{h}, {q_cap}")
    R, J = arrival.shape
    _check_lanes(R, dev, h_lane=(h_lane, 1, h), j_live=(j_live, 0, J))
    if dev.type == "cpu":
        return bs_scan_ref(arrival, cls, need, service, slots, s_max=s_max,
                           h=h, q_cap=q_cap, h_lane=h_lane, j_live=j_live)
    C = slots.shape[-1]
    tagged = torch.empty(R, 2 * J, dtype=_I32, device=dev)
    rec_t = torch.empty(R, 2 * J, dtype=_F64, device=dev)
    ovf = torch.zeros(R, dtype=torch.bool, device=dev)
    if R == 0 or J == 0:
        return tagged, rec_t, ovf
    ring = torch.empty(R * C * q_cap * _BS_RING_ENTRY, dtype=torch.uint8,
                       device=dev)
    sl, hl = _slot_rows(slots, R), _lane_sizes(h_lane, R, dev, h)
    jl = _lane_sizes(j_live, R, dev, J)
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_bs_scan(_ptr(arrival), _ptr(cls), _ptr(need),
                             _ptr(service), _ptr(sl), _ptr(hl), _ptr(jl),
                             _ptr(tagged), _ptr(rec_t), _ptr(ovf),
                             _ptr(ring), R, J, C, s_max, h, q_cap,
                             _stream(dev))
    build.LIBRARY.raise_on(rc, "bs_scan", f"R={R} J={J} C={C} s_max={s_max} "
                           f"h={h} q_cap={q_cap}")
    bs_scan_fwd.launches += 1
    return tagged, rec_t, ovf


def srpt_scan_fwd(arrival, need, service, kk, *, Q: int, NU: tuple,
                  sf: bool, j_live=None):
    """[R, J] trace arrays (float64 needs) + kk [R] float64 servers ->
    (job_ev, t_ev, fs_ev [R, 2J] float64, ovf [R] bool, npre, ne,
    peak [R] int32).

    Preemptive ServerFilling-SRPT (``sf=True``) or FirstFit-SRPT as the
    2J-event scan over a ``Q``-slot table (Q a power of two).  ``job_ev``
    holds the departing job id at each departure event (-1 elsewhere),
    ``t_ev`` its completion and ``fs_ev`` its first start; ``ovf`` flags a
    table that overflowed (the caller must raise), ``npre`` counts
    preemptions, ``ne`` processed events (2J on success) and ``peak`` the
    peak in-system count.  ``NU`` is the ascending tuple of distinct needs
    (every need must be in it).  Lane r has ``j_live[r]`` jobs (None: J;
    it never admits one past them).  On the card the slot table lives in
    shared memory while it fits (Q <= 4096 on an H100), else in a global
    scratch of one table per replication.
    """
    dev = _check(dtypes=_SRPT_DTYPES, arrival=arrival, need=need,
                 service=service)
    R, J = arrival.shape
    if Q < 1 or Q & (Q - 1):
        raise ValueError(f"Q must be a power of two, got {Q}")
    NU = tuple(int(v) for v in NU)
    if not NU or list(NU) != sorted(set(NU)) or NU[0] < 1 or len(NU) > 64:
        raise ValueError(f"NU must be 1 to 64 ascending distinct needs "
                         f">= 1, got {NU}")
    if (kk.shape != (R,) or kk.dtype != _F64 or kk.device != dev
            or not kk.is_contiguous()):
        raise ValueError(f"kk must be a contiguous float64 [R]={R} tensor "
                         f"on {dev}")
    _check_lanes(R, dev, j_live=(j_live, 0, J))
    if dev.type == "cpu":
        return srpt_scan_ref(arrival, need, service, kk, Q=Q, NU=NU, sf=sf,
                             j_live=j_live)
    job_ev = torch.empty(R, 2 * J, dtype=_F64, device=dev)
    t_ev = torch.empty_like(job_ev)
    fs_ev = torch.empty_like(job_ev)
    ovf = torch.zeros(R, dtype=torch.bool, device=dev)
    npre, ne, peak = (torch.zeros(R, dtype=_I32, device=dev)
                      for _ in range(3))
    if R == 0 or J == 0:
        return job_ev, t_ev, fs_ev, ovf, npre, ne, peak
    nu = torch.tensor(NU, dtype=_I32, device=dev)
    jl = _lane_sizes(j_live, R, dev, J)
    if not bool(torch.isin(need, nu.to(_F64)).all()):
        raise ValueError(f"every need must be one of NU={NU}")
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        nbytes = ctypes.c_longlong(0)
        rc = lib.msj_srpt_table_bytes(Q, ctypes.byref(nbytes))
        build.LIBRARY.raise_on(rc, "srpt_scan", f"Q={Q}")
        table = (torch.empty(R * nbytes.value, dtype=torch.uint8, device=dev)
                 if nbytes.value else None)
        rc = lib.msj_srpt_scan(_ptr(arrival), _ptr(need), _ptr(service),
                               _ptr(kk), _ptr(jl), _ptr(nu), len(NU),
                               _ptr(job_ev), _ptr(t_ev), _ptr(fs_ev),
                               _ptr(ovf), _ptr(npre), _ptr(ne), _ptr(peak),
                               None if table is None else _ptr(table), R, J,
                               Q, int(sf), _stream(dev))
    build.LIBRARY.raise_on(rc, "srpt_scan", f"R={R} J={J} Q={Q} sf={sf}")
    srpt_scan_fwd.launches += 1
    return job_ev, t_ev, fs_ev, ovf, npre, ne, peak


def stable_sort_fwd(*operands, num_keys: int):
    """Stable ascending sort of [R, W] rows, W <= 4096: ``num_keys``
    (1 or 2) float64 key tensors compared lexicographically, then one int32
    payload; returns the sorted keys and the payload.  Ties keep the input
    order (the index is the final key), +inf sorts last and rows are padded
    to a power of two with +inf, as in the reference's ``bitonic_sort``.
    NaN keys are not supported.
    """
    if num_keys not in (1, 2) or len(operands) != num_keys + 1:
        raise ValueError("expected 1 or 2 float64 keys and one int32 "
                         "payload")
    first = operands[0]
    if first.dim() != 2:
        raise ValueError(f"sort operands must be [R, W], got "
                         f"{tuple(first.shape)}")
    R, W = first.shape
    if not 1 <= W <= _SORT_W_MAX:
        raise ValueError(f"W={W} outside [1, {_SORT_W_MAX}]")
    for i, t in enumerate(operands):
        want = _I32 if i == num_keys else _F64
        if t.dtype != want:
            raise TypeError(f"operand {i} must be {want}, got {t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"operand {i} must be {tuple(first.shape)} on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"operand {i} must be contiguous")
    dev = first.device
    if dev.type == "cpu":
        return stable_sort_ref(*operands, num_keys=num_keys)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; expected cpu or cuda")
    outs = tuple(torch.empty_like(t) for t in operands)
    if R == 0:
        return outs
    k2, k2_out = ((operands[1], outs[1]) if num_keys == 2
                  else (None, None))
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_stable_sort(
            _ptr(operands[0]), None if k2 is None else _ptr(k2),
            _ptr(operands[-1]), _ptr(outs[0]),
            None if k2_out is None else _ptr(k2_out), _ptr(outs[-1]), R, W,
            _stream(dev))
    build.LIBRARY.raise_on(rc, "stable_sort",
                           f"R={R} W={W} num_keys={num_keys}")
    stable_sort_fwd.launches += 1
    return outs


def fcfs_fail_scan_fwd(t, need, svc, t_up, is_fail, *, k: int,
                       k_lane=None):
    """Merged [R, L] arrival+failure stream -> start times [R, L] float64.

    Row j is an arrival (``is_fail`` False: the FCFS step of
    :func:`fcfs_scan_fwd`) or a drain (``is_fail`` True: the earliest-free
    server is held until ``t_up``; pad rows have ``t = +inf, t_up = 0``).
    Every row's start is written, failure rows included; the host reads
    the arrival rows (``MergedStream.job_pos``).  ``k_lane`` as in
    :func:`fcfs_scan_fwd`.
    """
    dev = _check(t=t, need=need, svc=svc, t_up=t_up, is_fail=is_fail)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    R, L = t.shape
    _check_lanes(R, dev, k_lane=(k_lane, 1, k))
    if dev.type == "cpu":
        return fcfs_fail_scan_ref(t, need, svc, t_up, is_fail, k=k,
                                  k_lane=k_lane)
    _fcfs_fits(k)
    starts = torch.empty_like(t)
    if R == 0 or L == 0:
        return starts
    kl = _lane_sizes(k_lane, R, dev, k)
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_fcfs_fail_scan(_ptr(t), _ptr(need), _ptr(svc),
                                    _ptr(t_up), _ptr(is_fail), _ptr(kl),
                                    _ptr(starts), R, L, k, _stream(dev))
    build.LIBRARY.raise_on(rc, "fcfs_fail_scan", f"R={R} L={L} k={k}")
    fcfs_fail_scan_fwd.launches += 1
    return starts


def modbs_fail_scan_fwd(t, cls, need, svc, t_up, is_fail, slots, *,
                        s_max: int, h: int, h_lane=None):
    """Merged [R, L] stream + slots [C] or [R, C] -> (blocked [R, L] bool,
    starts [R, L] float64).

    Failure rows carry their target block in ``cls``: ``cls == C`` drains
    the helper's free-time vector, ``cls < C`` extends the class row's
    earliest completion to ``t_up``.  ``blocked`` is False on failure rows.
    ``h_lane`` as in :func:`modbs_scan_fwd`.
    """
    dev = _check(slots, t=t, cls=cls, need=need, svc=svc, t_up=t_up,
                 is_fail=is_fail)
    if s_max < 1 or h < 1:
        raise ValueError(f"s_max and h must be >= 1, got {s_max}, {h}")
    R, L = t.shape
    _check_lanes(R, dev, h_lane=(h_lane, 1, h))
    if dev.type == "cpu":
        return modbs_fail_scan_ref(t, cls, need, svc, t_up, is_fail, slots,
                                   s_max=s_max, h=h, h_lane=h_lane)
    C = slots.shape[-1]
    _modbs_fits(C, s_max, h)
    blocked = torch.empty(R, L, dtype=torch.bool, device=dev)
    starts = torch.empty_like(t)
    if R == 0 or L == 0:
        return blocked, starts
    sl, hl = _slot_rows(slots, R), _lane_sizes(h_lane, R, dev, h)
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_modbs_fail_scan(_ptr(t), _ptr(cls), _ptr(need),
                                     _ptr(svc), _ptr(t_up), _ptr(is_fail),
                                     _ptr(sl), _ptr(hl), _ptr(blocked),
                                     _ptr(starts), R, L, C, s_max, h,
                                     _stream(dev))
    build.LIBRARY.raise_on(rc, "modbs_fail_scan",
                           f"R={R} L={L} C={C} s_max={s_max} h={h}")
    modbs_fail_scan_fwd.launches += 1
    return blocked, starts


def bs_fail_scan_fwd(arrival, cls, need, service, ft, ftgt, fup, slots, *,
                     s_max: int, h: int, q_cap: int, length: int,
                     h_lane=None, j_live=None):
    """[R, J] trace arrays + failure records ft/fup float64, ftgt int32
    [R, F] + slots [C] -> (tagged [R, length] int32, rec_t [R, length]
    float64, ovf [R] bool).

    Drain-mode BS-π: the event scan of :func:`bs_scan_fwd` with a fourth
    candidate event, the next failure (chronological per replication, pad
    rows ``ft = +inf``; F >= 1), which wins ties and claims the
    earliest-free capacity unit of its target block (``ftgt == C``: the
    helper).  ``length`` = 2J + F + F_A steps; the caller must raise on
    ``ovf``.  ``slots``, ``h_lane`` and ``j_live`` as in
    :func:`bs_scan_fwd` (every lane runs ``length`` steps).
    """
    dev = _check(slots, arrival=arrival, cls=cls, need=need,
                 service=service)
    R, J = arrival.shape
    if ft.dim() != 2 or ft.shape[0] != R or ft.shape[1] < 1:
        raise ValueError(f"failure records must be [R={R}, F>=1], got "
                         f"{tuple(ft.shape)}")
    _check(ft=ft, ftgt=ftgt, fup=fup)
    if ft.device != dev:
        raise ValueError(f"failure records are on {ft.device}, expected "
                         f"{dev}")
    if s_max < 1 or h < 1 or q_cap < 1:
        raise ValueError(f"s_max, h and q_cap must be >= 1, got {s_max}, "
                         f"{h}, {q_cap}")
    if not 0 <= length < 2**31:
        raise ValueError(f"length={length} outside [0, 2**31)")
    _check_lanes(R, dev, h_lane=(h_lane, 1, h), j_live=(j_live, 0, J))
    if dev.type == "cpu":
        return bs_fail_scan_ref(arrival, cls, need, service, ft, ftgt, fup,
                                slots, s_max=s_max, h=h, q_cap=q_cap,
                                length=length, h_lane=h_lane, j_live=j_live)
    F = ft.shape[1]
    C = slots.shape[-1]
    tagged = torch.empty(R, length, dtype=_I32, device=dev)
    rec_t = torch.empty(R, length, dtype=_F64, device=dev)
    ovf = torch.zeros(R, dtype=torch.bool, device=dev)
    if R == 0 or J == 0 or length == 0:
        return tagged, rec_t, ovf
    ring = torch.empty(R * C * q_cap * _BS_RING_ENTRY, dtype=torch.uint8,
                       device=dev)
    sl, hl = _slot_rows(slots, R), _lane_sizes(h_lane, R, dev, h)
    jl = _lane_sizes(j_live, R, dev, J)
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_bs_fail_scan(_ptr(arrival), _ptr(cls), _ptr(need),
                                  _ptr(service), _ptr(ft), _ptr(ftgt),
                                  _ptr(fup), _ptr(sl), _ptr(hl), _ptr(jl),
                                  _ptr(tagged), _ptr(rec_t), _ptr(ovf),
                                  _ptr(ring), R, J, F, C, s_max, h, q_cap,
                                  length, _stream(dev))
    build.LIBRARY.raise_on(rc, "bs_fail_scan",
                           f"R={R} J={J} F={F} C={C} s_max={s_max} h={h} "
                           f"q_cap={q_cap} length={length}")
    bs_fail_scan_fwd.launches += 1
    return tagged, rec_t, ovf


# -- carried (stream) entries ------------------------------------------------


def _check_carry(dev: torch.device, **named) -> None:
    """Validate carry tensors: each a contiguous (dtype, shape) match on
    ``dev``."""
    for name, (t, dtype, shape) in named.items():
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} "
                             f"{list(shape)} tensor on {dev}, got "
                             f"{t.dtype} {list(t.shape)} on {t.device}")


def _chunk_jobs(J: int) -> None:
    if J < 1:
        raise ValueError("a stream chunk needs at least one job")


def fcfs_stream_fwd(arrival, need, service, W, t_prev):
    """One FCFS chunk [R, J] resumed from the carry ``W`` [R, k] (sorted
    free times) and ``t_prev`` [R] (last starts) -> (starts [R, J],
    W' [R, k], t_prev' [R]).

    The carry is the port's canonical one on both devices: W' clamped to
    ``>= t_prev'`` (entries at or below the last start reach no output;
    the kernel keeps only their count).  The kernel builds its run-length
    state from W at entry and writes W' back at exit; the caller's
    tensors are not changed.
    """
    dev = _check(arrival=arrival, need=need, service=service)
    R, J = arrival.shape
    _chunk_jobs(J)
    k = W.shape[-1]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    _check_carry(dev, W=(W, _F64, (R, k)), t_prev=(t_prev, _F64, (R,)))
    if dev.type == "cpu":
        return fcfs_stream_ref(arrival, need, service, W, t_prev)
    _fcfs_fits(k)
    starts = torch.empty_like(arrival)
    W, t_prev = W.clone(), t_prev.clone()   # the kernel writes them back
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_fcfs_stream(_ptr(arrival), _ptr(need), _ptr(service),
                                 _ptr(W), _ptr(t_prev), _ptr(starts), R, J,
                                 k, _stream(dev))
    build.LIBRARY.raise_on(rc, "fcfs_stream_scan", f"R={R} J={J} k={k}")
    fcfs_stream_fwd.launches += 1
    return starts, W, t_prev


def modbs_stream_fwd(arrival, cls, need, service, comp, W, t_prev):
    """One ModifiedBS-π chunk [R, J] resumed from the carry ``comp``
    [R, C, s_max] (each class row's completion times; padded slots BIG),
    ``W`` [R, h] (the helper's sorted free times) and ``t_prev`` [R] ->
    (blocked [R, J] bool, starts [R, J], comp', W', t_prev').

    The carry is canonical on both devices: each class row sorted
    ascending (the kernel keeps rows sorted, so ``comp`` must come in
    sorted) and W' clamped as in :func:`fcfs_stream_fwd`.  The caller's
    tensors are not changed.
    """
    dev = _check(arrival=arrival, cls=cls, need=need, service=service)
    R, J = arrival.shape
    _chunk_jobs(J)
    if comp.dim() != 3 or W.dim() != 2:
        raise ValueError("comp must be [R, C, s_max] and W [R, h]")
    C, s_max, h = comp.shape[1], comp.shape[2], W.shape[1]
    if min(C, s_max, h) < 1:
        raise ValueError(f"C, s_max and h must be >= 1, got {C}, {s_max}, "
                         f"{h}")
    _check_carry(dev, comp=(comp, _F64, (R, C, s_max)),
                 W=(W, _F64, (R, h)), t_prev=(t_prev, _F64, (R,)))
    if dev.type == "cpu":
        return modbs_stream_ref(arrival, cls, need, service, comp, W, t_prev)
    _modbs_fits(C, s_max, h)
    blocked = torch.empty(R, J, dtype=torch.bool, device=dev)
    starts = torch.empty_like(arrival)
    comp, W, t_prev = comp.clone(), W.clone(), t_prev.clone()
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_modbs_stream(_ptr(arrival), _ptr(cls), _ptr(need),
                                  _ptr(service), _ptr(comp), _ptr(W),
                                  _ptr(t_prev), _ptr(blocked), _ptr(starts),
                                  R, J, C, s_max, h, _stream(dev))
    build.LIBRARY.raise_on(rc, "modbs_stream_scan",
                           f"R={R} J={J} C={C} s_max={s_max} h={h}")
    modbs_stream_fwd.launches += 1
    return blocked, starts, comp, W, t_prev


#: names of the BS stream carry's tensors, in order
BS_CARRY = ("ai", "st", "comp", "ring", "heads", "W", "t_prev", "t_hol",
            "ovf", "ne")


def bs_stream_fwd(arrival, cls, need, service, slots, horizon, carry, *,
                  s_max: int, h: int, q_cap: int, length: int):
    """One BS-π chunk resumed from the reference's chunk carry ``(ai, st,
    comp, ring, heads, W, t_prev, t_hol, ovf, ne)`` -> (carry', tagged
    [R, length] int32, rec_t [R, length] float64).

    The trace [R, J] is the chunk's local layout (the still-queued jobs
    of earlier chunks first, ``core.stream._bs_inflate``), ``slots`` [C]
    the classes' A slots (a class row's free slots are its BIG entries
    below ``slots[c]``), ``horizon`` [R] the next chunk's first arrival
    (inf when draining).  The scan runs ``length`` steps: a commit is
    processed while Th <= horizon, a completion while Tc < horizon (and
    below 0.5 BIG), an arrival while ai < J; a deferred event leaves the
    carry as it is, and ``ne`` counts the events processed.  carry' holds
    in its ring only each class's queued entries (0 elsewhere,
    ``sim_torch.bs_live_ring``), on both devices.  The caller must raise
    on carry'[8] (ring overflow).  The caller's tensors are not changed.
    """
    dev = _check(slots, arrival=arrival, cls=cls, need=need, service=service)
    R, J = arrival.shape
    _chunk_jobs(J)
    if s_max < 1 or h < 1 or q_cap < 1:
        raise ValueError(f"s_max, h and q_cap must be >= 1, got {s_max}, "
                         f"{h}, {q_cap}")
    if slots.dim() != 1:
        raise ValueError("slots must be [C]")
    C = slots.shape[0]
    if not 0 <= length < 2**31:
        raise ValueError(f"length={length} outside [0, 2**31)")
    if len(carry) != len(BS_CARRY):
        raise ValueError(f"carry must be {BS_CARRY}")
    shapes = ((R,), (R, 3 * C), (R, C * s_max), (R, C * q_cap), (R, C),
              (R, h), (R,), (R,), (R,), (R,))
    _check_carry(dev, horizon=(horizon, _F64, (R,)), **{
        n: (t, d, sh) for n, t, d, sh in zip(
            BS_CARRY, carry, sim_torch.BS_CARRY_DTYPES, shapes)})
    if dev.type == "cpu":
        return bs_stream_ref(arrival, cls, need, service, slots, horizon,
                             carry, s_max=s_max, h=h, q_cap=q_cap,
                             length=length)
    carry = tuple(t.clone() for t in carry)   # the kernel writes them back
    sl = _slot_rows(slots, R)
    tagged = torch.empty(R, length, dtype=_I32, device=dev)
    rec_t = torch.empty(R, length, dtype=_F64, device=dev)
    ring = torch.empty(R * C * q_cap * _BS_RING_ENTRY, dtype=torch.uint8,
                       device=dev)
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_bs_stream(_ptr(arrival), _ptr(cls), _ptr(need),
                               _ptr(service), _ptr(sl), _ptr(horizon),
                               *(_ptr(t) for t in carry), _ptr(tagged),
                               _ptr(rec_t), _ptr(ring), R, J, C, s_max, h,
                               q_cap, length, _stream(dev))
    build.LIBRARY.raise_on(rc, "bs_stream_scan",
                           f"R={R} J={J} C={C} s_max={s_max} h={h} "
                           f"q_cap={q_cap} length={length}")
    bs_stream_fwd.launches += 1
    return carry, tagged, rec_t


WRAPPERS = (fcfs_scan_fwd, modbs_scan_fwd, bs_scan_fwd, srpt_scan_fwd,
            stable_sort_fwd, fcfs_fail_scan_fwd, modbs_fail_scan_fwd,
            bs_fail_scan_fwd, fcfs_stream_fwd, modbs_stream_fwd,
            bs_stream_fwd, loss_scan_fwd)

for _w in WRAPPERS:
    _w.launches = 0


def reset_launches() -> None:
    """Set every wrapper's ``launches`` count to 0."""
    for w in WRAPPERS:
        w.launches = 0


def launches() -> dict[str, int]:
    """Each wrapper's kernel launches since the last reset."""
    return {w.__name__: w.launches for w in WRAPPERS}
