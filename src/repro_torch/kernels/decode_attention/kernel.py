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
* for CUDA tensors allocates the output and the float32 partials, launches
  the split and combine kernels of ``csrc/decode_attention.cu`` on the
  current stream (one C call), raises if a launch is refused, and adds one
  to ``decode_attention_fwd.launches``.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..attention_build import LIBRARY

NEG_INF = -1e30
G_MAX = 64
_DTYPES = (torch.float32, torch.bfloat16)
_CTAS_PER_SM = 4          # split the cache until the grid is this full
_KC_MIN, _SCORES_MAX = 32, 8192   # keys per split; G * KC float32 scores


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


def split_plan(B: int, Kh: int, Sk: int, G: int, n_sm: int):
    """(KC, n_split): positions per split and splits per (b, kv head), so
    that B * Kh * n_split CTAs fill about ``_CTAS_PER_SM`` per SM and the
    G x KC float32 scores of a CTA stay within ``_SCORES_MAX``."""
    want = -(-(_CTAS_PER_SM * n_sm) // (B * Kh))
    kc = -(-Sk // want)
    kc = -(-kc // _KC_MIN) * _KC_MIN
    kc_max = max(_KC_MIN, _SCORES_MAX // G // _KC_MIN * _KC_MIN)
    kc = min(max(kc, _KC_MIN), kc_max)
    return kc, -(-Sk // kc)


def decode_attention_fwd(q, k, v, pos):
    """q [B, H, D]; k/v [B, Sk, Kh, D/Dv]; pos [B] int32 -> [B, H, Dv]."""
    _check(q, k, v, pos)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos)
    B, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    kc, n_split = split_plan(B, Kh, Sk, H // Kh, n_sm)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty(B, H, n_split, **f32)
    part_l = torch.empty(B, H, n_split, **f32)
    part_acc = torch.empty(B, H, n_split, Dv, **f32)
    o = torch.empty(B, H, Dv, dtype=q.dtype, device=q.device)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attn_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            o.data_ptr(), B, Sk, H, Kh, D, Dv, kc, n_split,
            ctypes.c_float(1.0 / math.sqrt(D)),
            int(q.dtype == torch.bfloat16), stream)
    LIBRARY.raise_on(rc, "decode_attention",
                     f"B={B} Sk={Sk} H={H} Kh={Kh} D={D} Dv={Dv} KC={kc} "
                     f"n_split={n_split}")
    decode_attention_fwd.launches += 1
    return o


decode_attention_fwd.launches = 0
