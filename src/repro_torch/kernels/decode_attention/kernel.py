"""Wrapper of the hand-written flash-decoding CUDA kernels, beside their
plain PyTorch version.

``decode_attention_fwd(q, k, v, pos)`` takes one query token per sequence,
q [B, H, D], a KV cache k / v [B, Sk, Kh, D / Dv] (float32 or bfloat16,
one dtype, contiguous, H % Kh == 0, query head h on kv head h // (H / Kh))
and pos [B] int32, masks cache positions > pos[b], and returns
[B, H, Dv] in q's dtype: the signature of the reference's Pallas kernel
``repro/kernels/decode_attention/kernel.py:decode_attention_fwd`` without
its block size.  It checks its inputs, then

* for CPU tensors returns the plain version, :func:`decode_attention_ref`;
* for CUDA tensors plans the grid (:func:`decode_plan`, a pure function
  of the shapes; the kernel cuts the splits from pos on the card as
  :func:`split_ranges` does), allocates the output and one float32 buffer
  of partials, launches the split and combine kernels of
  ``csrc/decode_attention.cu`` on the current stream (one C call), raises
  if a launch is refused, and adds one to
  ``decode_attention_fwd.launches``.  There is no fallback.

On the card the wrapper raises ``NotImplementedError`` when autograd
tracks one of its inputs (``kernels.refuse_grad``): the kernel has no
backward kernel yet, and its output would carry no gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import refuse_grad
from ..attention_build import LIBRARY

NEG_INF = -1e30
G_MAX = 64
_DTYPES = (torch.float32, torch.bfloat16)
_CTAS_PER_SM = 2          # the grid: one wave of this many CTAs per SM
_OUT_MAX = 4096           # Dv at most (the combine's outputs)
_SCORES_MAX = 12288       # G * KC float32 scores a CTA holds
_PARTIAL_SHARE = 6        # a split reads >= this x its partial's bytes
# csrc/decode_attention.cu's constants: threads (at most), ring tiles,
# bytes of a tile's 128-element rows (64 bf16 or 32 float32 rows), float32
# P.V sums per thread, and an H100 SM's shared memory
_NT_MAX, _STAGES, _KT_BYTES, _PV_REGS, _SMEM_PER_SM = 256, 4, 16384, 32, 233472


def decode_attention_ref(q, k, v, pos):
    """Plain version: scores q.k in float32 times the float32 scale
    1/sqrt(D), positions > pos[b] masked to NEG_INF, softmax and P.V in
    float32, one cast to q's dtype (``repro/models/layers.py:
    attention_decode``'s cast points)."""
    B, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    G = H // Kh
    qf = q.float().reshape(B, Kh, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float()) * (1.0 / math.sqrt(D))
    valid = (torch.arange(Sk, device=q.device)[None, :]
             <= pos.to(torch.int64)[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhv->bhgv", p, v.float())
    return o.reshape(B, H, Dv).to(q.dtype)


def _check(q, k, v, pos) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be [B, H, D] and k, v [B, Sk, Kh, dim], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    if k.shape != (B, Sk, Kh, D) or v.shape[0] != B:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if min(B, Sk, H, Kh, D, Dv) < 1 or H % Kh:
        raise ValueError(f"empty dimension or H={H} not a multiple of "
                         f"Kh={Kh}")
    if H // Kh > G_MAX:
        raise ValueError(f"{H // Kh} query heads per kv head exceed the "
                         f"kernel's {G_MAX}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} must be float32 or bfloat16 like q, got "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (pos.shape != (B,) or pos.dtype != torch.int32
            or pos.device != q.device):
        raise TypeError(f"pos must be a [B] int32 tensor on {q.device}, got "
                        f"{tuple(pos.shape)} {pos.dtype} on {pos.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class DecodePlan(NamedTuple):
    """How ``csrc/decode_attention.cu`` cuts one call (the kernel checks
    ``kt`` and ``stages`` against its own)."""
    nx: int            # CTAs per kv head (the grid is nx x Kh)
    kc: int            # most cache positions one split holds
    cmin: int          # fewest positions a split is given
    kt: int            # rows of a ring tile
    stages: int        # ring tiles per CTA
    smem: int          # shared-memory bytes per CTA
    ctas_per_sm: int   # resident CTAs per SM (shared memory, registers)
    in_flight: int     # ring bytes in flight an SM: resident x 3 tiles


def decode_plan(B: int, Kh: int, Sk: int, G: int, D: int, Dv: int,
                itemsize: int, n_sm: int) -> DecodePlan:
    """The grid and split sizes of one call, from the shapes alone (which
    positions a split takes depends on pos, on the card:
    :func:`split_ranges`).  One wave of ``_CTAS_PER_SM`` CTAs per SM, or
    more where that gives a kv head fewer than 4 per sequence (with fewer
    extra CTAs than sequences the proportional split is coarse: stablelm-3b
    at B = 4 put 3674 of its 15 344 rows in one CTA); a split holds at
    most KC positions, so that its G x KC float32 scores fit
    ``_SCORES_MAX``, and
    at least ``cmin`` (whole tiles, enough that the float32 partial of a
    split, G (Dv + 2) floats, stays under 1 / ``_PARTIAL_SHARE`` of the
    cache bytes it read)."""
    kt = _KT_BYTES // (128 * itemsize)
    kc_max = max(1, _SCORES_MAX // G)
    rows = _cdiv(_PARTIAL_SHARE * G * (Dv + 2) * 4, (D + Dv) * itemsize)
    cmin = min(_cdiv(rows, kt) * kt, kc_max)      # whole tiles
    nx = max(_CTAS_PER_SM * n_sm // Kh, 4 * B)
    if kc_max < Sk:       # a split holds <= ceil(B Sk / (nx - B)) positions
        nx = max(nx, B + _cdiv(B * Sk, kc_max))
    kc = min(Sk, max(cmin, _cdiv(_cdiv(B * Sk, nx - B), kt) * kt))
    v = 16 // itemsize
    gm = 1 << (G - 1).bit_length()
    if G <= 2 and D % v == 0 and Dv % v == 0 and max(D, Dv) <= 256:
        row = max(D, Dv) * itemsize     # TMA tiles, unpadded rows
    else:                               # rows padded to odd 16-byte units
        row = max(_cdiv(D, v) | 1, _cdiv(Dv, v) | 1) * 16
    ring = _cdiv(max(_STAGES * kt * row, 4 * _NT_MAX * _PV_REGS), 1024) * 1024
    smem = 1024 + ring + 4 * (G * (D + 4) + gm * (kc | 1))
    # resident CTAs per SM: shared memory's count, at most the two that the
    # kernel's registers allow (__launch_bounds__(NT, 2): 128 a thread)
    resident = min(_SMEM_PER_SM // (smem + 1024), 2)
    return DecodePlan(nx, kc, cmin, kt, _STAGES, smem, resident,
                      resident * (_STAGES - 1) * kt * row)


def split_ranges(n_kept, nx: int, cmin: int, kt: int):
    """The split each of the ``nx`` CTAs of a kv head takes, as the kernel
    derives it on the card from the sequences' kept positions ``n_kept``
    (min(pos + 1, Sk), or Sk when pos < 0): a list of (b, start, end), or
    None for a CTA with no work.  Sequence b takes ns_b = 1 + floor((nx -
    B) n_b / R) CTAs in order of b (R = sum n_b), each holding max(ceil(n_b
    / ns_b) rounded up to whole tiles of ``kt`` rows, cmin) positions."""
    B, R = len(n_kept), sum(n_kept)
    out = []
    for b, n in enumerate(n_kept):
        ns = 1 + (nx - B) * n // R
        c = max(_cdiv(_cdiv(n, ns), kt) * kt, cmin)
        out += [(b, s * c, min(s * c + c, n)) if s * c < n else None
                for s in range(ns)]
    return out + [None] * (nx - len(out))


def decode_attention_fwd(q, k, v, pos):
    """q [B, H, D]; k/v [B, Sk, Kh, D/Dv]; pos [B] int32 -> [B, H, Dv]."""
    _check(q, k, v, pos)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos)
    refuse_grad("decode_attention", q, k, v)
    B, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    v16, G = 16 // q.element_size(), H // Kh
    gm = 1 << (G - 1).bit_length()              # the kernel's GM
    gh = min(gm, _PV_REGS // v16)
    nt = 128 if gm >= 8 else _NT_MAX            # the kernel's nt_of(GM)
    if Dv > _OUT_MAX or gm // gh * _cdiv(Dv, v16) > nt:
        raise ValueError(f"G={G} heads of Dv={Dv} exceed the CUDA kernel's "
                         f"{nt} P.V units or {_OUT_MAX} outputs")
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = decode_plan(B, Kh, Sk, H // Kh, D, Dv, q.element_size(), n_sm)
    part = torch.empty(plan.nx * H * (Dv + 2), dtype=torch.float32,
                       device=q.device)
    o = torch.empty(B, H, Dv, dtype=q.dtype, device=q.device)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attn_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            part.data_ptr(), o.data_ptr(), B, Sk, H, Kh, D, Dv, plan.kc,
            plan.cmin, plan.nx, plan.kt, plan.stages,
            ctypes.c_float(1.0 / math.sqrt(D)),
            int(q.dtype == torch.bfloat16), stream)
    LIBRARY.raise_on(rc, "decode_attention",
                     f"B={B} Sk={Sk} H={H} Kh={Kh} D={D} Dv={Dv} "
                     f"KC={plan.kc} nx={plan.nx}")
    decode_attention_fwd.launches += 1
    return o


decode_attention_fwd.launches = 0
