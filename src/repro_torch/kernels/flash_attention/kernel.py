"""Wrapper of the hand-written flash-attention CUDA kernel, beside its plain
PyTorch version.

``flash_attention_fwd(q, k, v, causal=)`` takes q [B, Sq, H, D] and
k / v [B, Sk, Kh, D / Dv] (float32 or bfloat16, one dtype, contiguous,
H % Kh == 0, query head h on kv head h // (H / Kh)) and returns
[B, Sq, H, Dv] in q's dtype: the signature of the reference's Pallas
kernel ``repro/kernels/flash_attention/kernel.py:flash_attention_fwd``
without its block sizes (the CUDA kernel picks its own tiles).  It checks
its inputs, then

* for CPU tensors returns the plain version, :func:`flash_attention_ref`;
* for CUDA tensors allocates the output, launches one of two kernels on
  the current stream, raises if the launch is refused, adds one to
  ``flash_attention_fwd.launches`` and records the route it took in
  ``flash_attention_fwd.last_route``.  :func:`_flash_route`, a pure
  function of the call, picks the kernel before the launch: ``"wgmma"``,
  ``csrc/flash_attention_tc.cu`` on the tensor cores, for bf16 with head
  dims that are multiples of 16 up to 128 (every served config: 64, 80,
  128); ``"simt"``, ``csrc/flash_attention.cu`` on the CUDA cores, for
  float32 (tensor cores would compute in TF32, another function) and any
  other shape.  Both are hand-written kernels; there is no fallback: a
  CUDA tensor never reaches the plain version through the wrapper, and a
  refused launch raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..attention_build import LIBRARY

NEG_INF = -1e30
D_MAX, DV_MAX = 256, 128
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain version: scores q.k in float32 times the float32 scale
    1/sqrt(D), masked to NEG_INF where key > query when causal, softmax
    and P.V in float32, one cast to q's dtype (the cast points of
    ``repro/models/layers.py:flash_attention``)."""
    B, Sq, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    G = H // Kh
    qf = q.float().reshape(B, Sq, Kh, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * (1.0 / math.sqrt(D))
    if causal:
        qp = torch.arange(Sq, device=q.device)
        mask = qp[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhv->bqhgv", p, v.float())
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def _flash_route(dtype, D: int, Dv: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` (tensor cores) for bf16
    with D and Dv multiples of 16 up to 128, else ``"simt"``."""
    if (dtype == torch.bfloat16 and D % 16 == 0 and Dv % 16 == 0
            and D <= 128 and Dv <= 128):
        return "wgmma"
    return "simt"


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, S, heads, dim], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    if k.shape != (B, Sk, Kh, D) or v.shape[0] != B:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if min(B, Sq, Sk, H, Kh, D, Dv) < 1 or H % Kh:
        raise ValueError(f"empty dimension or H={H} not a multiple of "
                         f"Kh={Kh}")
    if D > D_MAX or Dv > DV_MAX:
        raise ValueError(f"head dims D={D}, Dv={Dv} exceed the kernel's "
                         f"{D_MAX}, {DV_MAX}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} must be float32 or bfloat16 like q, got "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _launch(q, k, v, causal: bool, route: str):
    """Launch the kernel of ``route`` on CUDA tensors that passed
    :func:`_check` and return o; counts nothing (the wrapper counts)."""
    B, Sq, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    if route == "wgmma" and _flash_route(q.dtype, D, Dv) != "wgmma":
        raise ValueError(f"the wgmma kernel takes bf16 with head dims that "
                         f"are multiples of 16 up to 128, got {q.dtype} "
                         f"D={D} Dv={Dv}")
    o = torch.empty(B, Sq, H, Dv, dtype=q.dtype, device=q.device)
    lib = LIBRARY.load()
    scale = ctypes.c_float(1.0 / math.sqrt(D))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        if route == "wgmma":
            rc = lib.attn_flash_fwd_tc(*ptrs, B, Sq, Sk, H, Kh, D, Dv, scale,
                                       int(causal), stream)
        else:
            rc = lib.attn_flash_fwd(*ptrs, B, Sq, Sk, H, Kh, D, Dv, scale,
                                    int(causal),
                                    int(q.dtype == torch.bfloat16), stream)
    LIBRARY.raise_on(rc, f"flash_attention ({route})",
                     f"B={B} Sq={Sq} Sk={Sk} H={H} Kh={Kh} D={D} Dv={Dv}")
    return o


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q [B, Sq, H, D]; k/v [B, Sk, Kh, D/Dv] -> [B, Sq, H, Dv]."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    route = _flash_route(q.dtype, q.shape[3], v.shape[3])
    o = _launch(q, k, v, causal, route)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.last_route = route
    return o


flash_attention_fwd.launches = 0
flash_attention_fwd.last_route = None
