"""Wrappers of the hand-written flash-attention CUDA kernels, forward and
backward, each beside its plain PyTorch version.

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

``return_lse=True`` also returns each row's log-sum-exp, lse [B, H, Sq]
float32 (m + log(max(l, 1e-30)) in natural-log units, the reference's
``_flash_fwd_impl``), which both kernels write when given the buffer.  On
the card the forward wrapper refuses inputs that autograd tracks
(``kernels.refuse_grad``): ``models.layers.flash_attention`` wraps it in
an autograd Function whose backward is the backward kernel.

``flash_attention_bwd(q, k, v, o, lse, do, causal=)`` -> (dq, dk, dv): the
backward of the reference's custom VJP ``_flash_bwd``
(``repro/models/layers.py:269``), which is not a Pallas kernel; on CPU
tensors :func:`flash_attention_bwd_ref`, on CUDA tensors
``csrc/flash_attention_bwd.cu`` (three kernels: delta, dq, dk / dv),
counted in ``flash_attention_bwd.launches`` once a call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import refuse_grad
from ..attention_build import LIBRARY

NEG_INF = -1e30
D_MAX, DV_MAX = 256, 128
_DTYPES = (torch.float32, torch.bfloat16)


def _scores(q, k, causal: bool):
    """q.k in float32 times the float32 scale 1/sqrt(D), [B, Kh, G, Sq,
    Sk], masked to NEG_INF where key > query when causal."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, Kh, H // Kh, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * (1.0 / math.sqrt(D))
    if causal:
        qp = torch.arange(Sq, device=q.device)
        mask = qp[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    return s


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        return_lse: bool = False):
    """Plain version: scores q.k in float32 times the float32 scale
    1/sqrt(D), masked to NEG_INF where key > query when causal, softmax
    and P.V in float32, one cast to q's dtype (the cast points of
    ``repro/models/layers.py:flash_attention``).  ``return_lse``: also
    m + log(max(l, 1e-30)) [B, H, Sq] float32, m the row max and l the
    row sum of exp(s - m) (``_flash_fwd_impl``'s lse)."""
    B, Sq, H, _ = q.shape
    Dv = v.shape[3]
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhv->bqhgv", p, v.float())
    o = o.reshape(B, Sq, H, Dv).to(q.dtype).contiguous()
    if not return_lse:
        return o
    m = s.amax(dim=-1)
    lse = m + torch.log(torch.exp(s - m[..., None]).sum(-1).clamp_min(1e-30))
    return o, lse.reshape(B, H, Sq).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True):
    """Plain version of the backward, cast point for cast point
    ``repro/models/layers.py:_flash_bwd``: delta = rowsum(do.f32 o.f32)
    from the rounded o; p = exp(s - lse) with masked scores at NEG_INF;
    dp = do.f32 v.f32; ds = p (dp - delta); dq = ds k.f32 scale; dv = p
    do.f32 and dk = ds q.f32 scale per query head, summed over the G query
    heads of a kv head in float32 before the one cast to k's / v's
    dtype."""
    B, Sq, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    G = H // Kh
    scale = 1.0 / math.sqrt(D)
    p = torch.exp(_scores(q, k, causal)
                  - lse.reshape(B, Kh, G, Sq)[..., None])
    dof = do.float().reshape(B, Sq, Kh, G, Dv)
    delta = (dof * o.float().reshape(B, Sq, Kh, G, Dv)).sum(-1)
    dp = torch.einsum("bqhgv,bkhv->bhgqk", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dv = torch.einsum("bhgqk,bqhgv->bkhgv", p, dof).sum(3)
    dk = torch.einsum("bhgqk,bqhgd->bkhgd", ds,
                      q.float().reshape(B, Sq, Kh, G, D)) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.sum(3).to(k.dtype),
            dv.to(v.dtype))


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


def _launch(q, k, v, causal: bool, route: str, lse=None):
    """Launch the kernel of ``route`` on CUDA tensors that passed
    :func:`_check` and return o, writing each row's log-sum-exp into
    ``lse`` [B, H, Sq] float32 where given; counts nothing (the wrapper
    counts)."""
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
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr())
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


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        return_lse: bool = False):
    """q [B, Sq, H, D]; k/v [B, Sk, Kh, D/Dv] -> [B, Sq, H, Dv], and lse
    [B, H, Sq] float32 with ``return_lse``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   return_lse=return_lse)
    refuse_grad("flash_attention (use models.layers.flash_attention, "
                "whose backward is the backward kernel)", q, k, v)
    route = _flash_route(q.dtype, q.shape[3], v.shape[3])
    lse = (torch.empty(q.shape[0], q.shape[2], q.shape[1],
                       dtype=torch.float32, device=q.device)
           if return_lse else None)
    o = _launch(q, k, v, causal, route, lse)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.last_route = route
    return (o, lse) if return_lse else o


flash_attention_fwd.launches = 0
flash_attention_fwd.last_route = None


def _check_bwd(q, k, v, o, lse, do) -> None:
    _check(q, k, v)
    B, Sq, H, _ = q.shape
    Dv = v.shape[3]
    for name, t, shape, dtype in (("o", o, (B, Sq, H, Dv), q.dtype),
                                  ("do", do, (B, Sq, H, Dv), q.dtype),
                                  ("lse", lse, (B, H, Sq), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """q [B, Sq, H, D], k / v [B, Sk, Kh, D / Dv], o / do [B, Sq, H, Dv]
    in q's dtype, lse [B, H, Sq] float32 (the forward's) -> (dq, dk, dv)
    in q's, k's and v's shapes and dtype."""
    _check_bwd(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    B, Sq, H, D = q.shape
    _, Sk, Kh, Dv = v.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attn_flash_bwd(
            *(t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv,
                                     delta)),
            B, Sq, Sk, H, Kh, D, Dv, ctypes.c_float(1.0 / math.sqrt(D)),
            int(causal), int(q.dtype == torch.bfloat16), stream)
    LIBRARY.raise_on(rc, "flash_attention_bwd",
                     f"B={B} Sq={Sq} Sk={Sk} H={H} Kh={Kh} D={D} Dv={Dv}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
