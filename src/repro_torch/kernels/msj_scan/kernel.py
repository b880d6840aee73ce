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
BS-π the trace plus the failure records [R, F].  It checks device, dtype,
shape and contiguity, then

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


def fcfs_scan_ref(arrival, need, service, *, k: int):
    """Plain FCFS scan: [R, J] arrays -> start times [R, J]."""
    return sim_torch._fcfs_core(arrival, need, service, k)


def modbs_scan_ref(arrival, cls, need, service, slots, *, s_max: int,
                   h: int):
    """Plain ModifiedBS-π scan -> (blocked [R, J] bool, starts [R, J])."""
    return sim_torch._modbs_core(arrival, cls, need, service, slots, s_max,
                                 h)


def bs_scan_ref(arrival, cls, need, service, slots, *, s_max: int, h: int,
                q_cap: int):
    """Plain BS-π event scan -> (tagged [R, 2J] int32, rec_t [R, 2J],
    ovf [R] bool)."""
    return sim_torch._bs_core(arrival, cls, need, service, slots, s_max, h,
                              q_cap)


def fcfs_fail_scan_ref(t, need, svc, t_up, is_fail, *, k: int):
    """Plain FCFS drain scan: merged [R, L] stream -> starts [R, L]."""
    return sim_torch._fcfs_fail_core(t, need, svc, t_up, is_fail, k)


def modbs_fail_scan_ref(t, cls, need, svc, t_up, is_fail, slots, *,
                        s_max: int, h: int):
    """Plain ModifiedBS-π drain scan -> (blocked [R, L], starts [R, L])."""
    return sim_torch._modbs_fail_core(t, cls, need, svc, t_up, is_fail,
                                      slots, s_max, h)


def bs_fail_scan_ref(arrival, cls, need, service, ft, ftgt, fup, slots, *,
                     s_max: int, h: int, q_cap: int, length: int):
    """Plain BS-π drain scan -> (tagged [R, length] int32,
    rec_t [R, length], ovf [R] bool)."""
    return sim_torch._bs_fail_core(arrival, cls, need, service, ft, ftgt,
                                   fup, slots, s_max, h, q_cap, length)


def srpt_scan_ref(arrival, need, service, kk, *, Q: int, NU: tuple,
                  sf: bool):
    """Plain SRPT event scan -> (job_ev, t_ev, fs_ev [R, 2J] float64,
    ovf [R] bool, npre, ne, peak [R] int32)."""
    return sim_torch._srpt_core(arrival, need, service, kk, Q, NU, sf)


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
        if (slots.dim() != 1 or slots.dtype != _I32
                or not slots.is_contiguous()):
            raise TypeError("slots must be a contiguous 1-D int32 tensor")
        if slots.device != first.device:
            raise ValueError(f"slots is on {slots.device}, expected "
                             f"{first.device}")
    dev = first.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; expected cpu or cuda")
    return dev


def _fcfs_fits(k: int) -> None:
    if k > FCFS_K_MAX:
        raise ValueError(f"k={k} exceeds {FCFS_K_MAX}: the FCFS kernel "
                         f"spills {_SPILL_BYTES} bytes a server past its "
                         f"first 128 into one block's shared memory "
                         f"({_SMEM_MAX} bytes on an H100)")


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


def fcfs_scan_fwd(arrival, need, service, *, k: int):
    """arrival/need/service [R, J] -> start times [R, J] float64.

    Multiserver-job FCFS (Kiefer–Wolfowitz): job j with need n starts at
    max(A_j, T_{j-1}, W[n-1]) on the sorted free-time vector W of the k
    servers, then n copies of its completion are rolled into W.
    """
    dev = _check(arrival=arrival, need=need, service=service)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if dev.type == "cpu":
        return fcfs_scan_ref(arrival, need, service, k=k)
    _fcfs_fits(k)
    R, J = arrival.shape
    starts = torch.empty_like(arrival)
    if R == 0 or J == 0:
        return starts
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_fcfs_scan(_ptr(arrival), _ptr(need), _ptr(service),
                               _ptr(starts), R, J, k, _stream(dev))
    build.LIBRARY.raise_on(rc, "fcfs_scan", f"R={R} J={J} k={k}")
    fcfs_scan_fwd.launches += 1
    return starts


def modbs_scan_fwd(arrival, cls, need, service, slots, *, s_max: int,
                   h: int):
    """[R, J] trace arrays + slots [C] -> (blocked [R, J] bool,
    starts [R, J] float64).

    ModifiedBS-π (Definition 2): per-class loss queues of ``slots[c]``
    slots (rows padded to ``s_max``); a job that finds its class full is
    blocked and served by FCFS on the h helper servers.
    """
    dev = _check(slots, arrival=arrival, cls=cls, need=need,
                 service=service)
    if s_max < 1 or h < 1:
        raise ValueError(f"s_max and h must be >= 1, got {s_max}, {h}")
    if dev.type == "cpu":
        return modbs_scan_ref(arrival, cls, need, service, slots,
                              s_max=s_max, h=h)
    C = slots.shape[0]
    _modbs_fits(C, s_max, h)
    R, J = arrival.shape
    blocked = torch.empty(R, J, dtype=torch.bool, device=dev)
    starts = torch.empty_like(arrival)
    if R == 0 or J == 0:
        return blocked, starts
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_modbs_scan(_ptr(arrival), _ptr(cls), _ptr(need),
                                _ptr(service), _ptr(slots), _ptr(blocked),
                                _ptr(starts), R, J, C, s_max, h,
                                _stream(dev))
    build.LIBRARY.raise_on(rc, "modbs_scan",
                           f"R={R} J={J} C={C} s_max={s_max} h={h}")
    modbs_scan_fwd.launches += 1
    return blocked, starts


def bs_scan_fwd(arrival, cls, need, service, slots, *, s_max: int, h: int,
                q_cap: int):
    """[R, J] trace arrays + slots [C] -> (tagged [R, 2J] int32,
    rec_t [R, 2J] float64, ovf [R] bool).

    BS-π (Definition 1) as the 2J-event scan.  ``tagged`` encodes each
    event: j = job j started in its A_i at ``rec_t``, j + J = job j was
    routed to H on arrival, j + 2J = job j started on a helper at
    ``rec_t``, -1 = no record.  ``ovf`` flags a helper-wait ring that
    outgrew ``q_cap``; the caller must raise on it.
    """
    dev = _check(slots, arrival=arrival, cls=cls, need=need,
                 service=service)
    if s_max < 1 or h < 1 or q_cap < 1:
        raise ValueError(f"s_max, h and q_cap must be >= 1, got {s_max}, "
                         f"{h}, {q_cap}")
    if dev.type == "cpu":
        return bs_scan_ref(arrival, cls, need, service, slots, s_max=s_max,
                           h=h, q_cap=q_cap)
    R, J = arrival.shape
    C = slots.shape[0]
    tagged = torch.empty(R, 2 * J, dtype=_I32, device=dev)
    rec_t = torch.empty(R, 2 * J, dtype=_F64, device=dev)
    ovf = torch.zeros(R, dtype=torch.bool, device=dev)
    if R == 0 or J == 0:
        return tagged, rec_t, ovf
    ring = torch.empty(R * C * q_cap * _BS_RING_ENTRY, dtype=torch.uint8,
                       device=dev)
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_bs_scan(_ptr(arrival), _ptr(cls), _ptr(need),
                             _ptr(service), _ptr(slots), _ptr(tagged),
                             _ptr(rec_t), _ptr(ovf), _ptr(ring), R, J, C,
                             s_max, h, q_cap, _stream(dev))
    build.LIBRARY.raise_on(rc, "bs_scan", f"R={R} J={J} C={C} s_max={s_max} "
                           f"h={h} q_cap={q_cap}")
    bs_scan_fwd.launches += 1
    return tagged, rec_t, ovf


def srpt_scan_fwd(arrival, need, service, kk, *, Q: int, NU: tuple,
                  sf: bool):
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
    (every need must be in it).  On the card the slot table lives in
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
    if dev.type == "cpu":
        return srpt_scan_ref(arrival, need, service, kk, Q=Q, NU=NU, sf=sf)
    job_ev = torch.empty(R, 2 * J, dtype=_F64, device=dev)
    t_ev = torch.empty_like(job_ev)
    fs_ev = torch.empty_like(job_ev)
    ovf = torch.zeros(R, dtype=torch.bool, device=dev)
    npre, ne, peak = (torch.zeros(R, dtype=_I32, device=dev)
                      for _ in range(3))
    if R == 0 or J == 0:
        return job_ev, t_ev, fs_ev, ovf, npre, ne, peak
    nu = torch.tensor(NU, dtype=_I32, device=dev)
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
                               _ptr(kk), _ptr(nu), len(NU), _ptr(job_ev),
                               _ptr(t_ev), _ptr(fs_ev), _ptr(ovf),
                               _ptr(npre), _ptr(ne), _ptr(peak),
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


def fcfs_fail_scan_fwd(t, need, svc, t_up, is_fail, *, k: int):
    """Merged [R, L] arrival+failure stream -> start times [R, L] float64.

    Row j is an arrival (``is_fail`` False: the FCFS step of
    :func:`fcfs_scan_fwd`) or a drain (``is_fail`` True: the earliest-free
    server is held until ``t_up``; pad rows have ``t = +inf, t_up = 0``).
    Every row's start is written, failure rows included; the host reads
    the arrival rows (``MergedStream.job_pos``).
    """
    dev = _check(t=t, need=need, svc=svc, t_up=t_up, is_fail=is_fail)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if dev.type == "cpu":
        return fcfs_fail_scan_ref(t, need, svc, t_up, is_fail, k=k)
    _fcfs_fits(k)
    R, L = t.shape
    starts = torch.empty_like(t)
    if R == 0 or L == 0:
        return starts
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_fcfs_fail_scan(_ptr(t), _ptr(need), _ptr(svc),
                                    _ptr(t_up), _ptr(is_fail), _ptr(starts),
                                    R, L, k, _stream(dev))
    build.LIBRARY.raise_on(rc, "fcfs_fail_scan", f"R={R} L={L} k={k}")
    fcfs_fail_scan_fwd.launches += 1
    return starts


def modbs_fail_scan_fwd(t, cls, need, svc, t_up, is_fail, slots, *,
                        s_max: int, h: int):
    """Merged [R, L] stream + slots [C] -> (blocked [R, L] bool,
    starts [R, L] float64).

    Failure rows carry their target block in ``cls``: ``cls == C`` drains
    the helper's free-time vector, ``cls < C`` extends the class row's
    earliest completion to ``t_up``.  ``blocked`` is False on failure rows.
    """
    dev = _check(slots, t=t, cls=cls, need=need, svc=svc, t_up=t_up,
                 is_fail=is_fail)
    if s_max < 1 or h < 1:
        raise ValueError(f"s_max and h must be >= 1, got {s_max}, {h}")
    if dev.type == "cpu":
        return modbs_fail_scan_ref(t, cls, need, svc, t_up, is_fail, slots,
                                   s_max=s_max, h=h)
    C = slots.shape[0]
    _modbs_fits(C, s_max, h)
    R, L = t.shape
    blocked = torch.empty(R, L, dtype=torch.bool, device=dev)
    starts = torch.empty_like(t)
    if R == 0 or L == 0:
        return blocked, starts
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_modbs_fail_scan(_ptr(t), _ptr(cls), _ptr(need),
                                     _ptr(svc), _ptr(t_up), _ptr(is_fail),
                                     _ptr(slots), _ptr(blocked),
                                     _ptr(starts), R, L, C, s_max, h,
                                     _stream(dev))
    build.LIBRARY.raise_on(rc, "modbs_fail_scan",
                           f"R={R} L={L} C={C} s_max={s_max} h={h}")
    modbs_fail_scan_fwd.launches += 1
    return blocked, starts


def bs_fail_scan_fwd(arrival, cls, need, service, ft, ftgt, fup, slots, *,
                     s_max: int, h: int, q_cap: int, length: int):
    """[R, J] trace arrays + failure records ft/fup float64, ftgt int32
    [R, F] + slots [C] -> (tagged [R, length] int32, rec_t [R, length]
    float64, ovf [R] bool).

    Drain-mode BS-π: the event scan of :func:`bs_scan_fwd` with a fourth
    candidate event, the next failure (chronological per replication, pad
    rows ``ft = +inf``; F >= 1), which wins ties and claims the
    earliest-free capacity unit of its target block (``ftgt == C``: the
    helper).  ``length`` = 2J + F + F_A steps; the caller must raise on
    ``ovf``.
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
    if dev.type == "cpu":
        return bs_fail_scan_ref(arrival, cls, need, service, ft, ftgt, fup,
                                slots, s_max=s_max, h=h, q_cap=q_cap,
                                length=length)
    F = ft.shape[1]
    C = slots.shape[0]
    tagged = torch.empty(R, length, dtype=_I32, device=dev)
    rec_t = torch.empty(R, length, dtype=_F64, device=dev)
    ovf = torch.zeros(R, dtype=torch.bool, device=dev)
    if R == 0 or J == 0 or length == 0:
        return tagged, rec_t, ovf
    ring = torch.empty(R * C * q_cap * _BS_RING_ENTRY, dtype=torch.uint8,
                       device=dev)
    lib = build.LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.msj_bs_fail_scan(_ptr(arrival), _ptr(cls), _ptr(need),
                                  _ptr(service), _ptr(ft), _ptr(ftgt),
                                  _ptr(fup), _ptr(slots), _ptr(tagged),
                                  _ptr(rec_t), _ptr(ovf), _ptr(ring), R, J,
                                  F, C, s_max, h, q_cap, length,
                                  _stream(dev))
    build.LIBRARY.raise_on(rc, "bs_fail_scan",
                           f"R={R} J={J} F={F} C={C} s_max={s_max} h={h} "
                           f"q_cap={q_cap} length={length}")
    bs_fail_scan_fwd.launches += 1
    return tagged, rec_t, ovf


WRAPPERS = (fcfs_scan_fwd, modbs_scan_fwd, bs_scan_fwd, srpt_scan_fwd,
            stable_sort_fwd, fcfs_fail_scan_fwd, modbs_fail_scan_fwd,
            bs_fail_scan_fwd)
for _w in WRAPPERS:
    _w.launches = 0


def reset_launches() -> None:
    """Set every wrapper's ``launches`` count to 0."""
    for w in WRAPPERS:
        w.launches = 0


def launches() -> dict[str, int]:
    """Each wrapper's kernel launches since the last reset."""
    return {w.__name__: w.launches for w in WRAPPERS}
