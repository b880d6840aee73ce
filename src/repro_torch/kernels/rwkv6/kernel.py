"""Wrapper of the hand-written chunked WKV6 CUDA kernel, beside its two
plain PyTorch versions.

``wkv_fwd(r, k, v, logw, u, s0=None, chunk=64)`` takes r / k / v
[B, S, H, N] (float32 or bfloat16, one dtype), logw [B, S, H, N] float32
(the log decay, <= 0), u [H, N] float32 and the carried state s0
[B, H, N, N] float32 (``None``: zeros), and returns ``(y, s_T)``: y
[B, S, H, N] in r's dtype and the state after the last step, [B, H, N, N]
float32.  With ``s0 = None`` y is the function of the reference's Pallas
kernel ``repro/kernels/rwkv6/kernel.py:wkv_fwd``; the state in and out is
the port's extension, which the model needs to hand prefill's state to
decode.  It checks its inputs, then

* for CPU tensors returns the plain version, :func:`wkv_chunked_ref`;
* for CUDA tensors allocates the outputs and the kernels' scratch (each
  chunk's state increment, then the state before it, and e^{c_T}:
  :func:`scratch_floats`), launches the three kernels of ``csrc/wkv.cu``
  on the current stream in one C call (the chunks' state increments, the
  walk over the chunks, the chunks' y), raises if a launch is refused,
  and adds one to ``wkv_fwd.launches``.  There is no fallback: a CUDA
  tensor never reaches the plain version through the wrapper.

Chunks start at multiples of ``chunk`` (1..64); the last one may be
shorter (``S % chunk != 0``).  The reference's ``wkv_chunked`` instead
takes one chunk of length S when ``chunk`` does not divide S: the same
function, summed in another order.

On the card the wrapper raises ``NotImplementedError`` when autograd
tracks one of its inputs (``kernels.refuse_grad``): the kernel has no
backward kernel yet, and its output would carry no gradient.
"""

from __future__ import annotations

import torch

from .. import refuse_grad
from .build import LIBRARY

N_MAX, CHUNK_MAX = 64, 64
_DTYPES = (torch.float32, torch.bfloat16)


def wkv_ref(r, k, v, logw, u, s0=None):
    """The exact sequential recurrence in float32, step by step (the
    reference's oracle ``repro/kernels/rwkv6/ref.py:wkv_ref``, with the
    state carried in and out)::

        y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
        S_t = diag(e^{w_t}) S_{t-1} + k_tᵀ v_t

    Returns ``(y in r's dtype, S_T float32)``."""
    B, S, H, N = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, logw))
    uf = u.float()[None, :, :, None]
    St = (torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
          if s0 is None else s0.float().clone())
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], St + uf * kv))
        St = torch.exp(wf[:, t])[..., None] * St + kv
    return torch.stack(ys, 1).to(r.dtype), St


def wkv_chunked_ref(r, k, v, logw, u, s0=None, *, chunk: int = 64):
    """The kernel's plain version: the chunk-parallel form of
    ``repro/models/rwkv.py:wkv_chunked`` (and of the Pallas kernel), in
    float32 with one cast of y.  Per chunk of T steps, with c the
    inclusive cumulative sum of logw and c_prev = c - logw::

        y  = (r e^{c_prev}) S + tril_strict((r e^{c_prev})(k e^{-c})ᵀ) v
             + diag(r · u · k) v
        S <- e^{c_T} S + (k e^{c_T - c})ᵀ v

    The last chunk is shorter when ``chunk`` does not divide S.  Returns
    ``(y in r's dtype, S_T float32)``."""
    B, S, H, N = r.shape
    St = (torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
          if s0 is None else s0.float().clone())
    uf = u.float()
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, wc = (x[:, c0:c0 + chunk].float()
                          for x in (r, k, v, logw))      # [B, T, H, N]
        T = rc.shape[1]
        c = torch.cumsum(wc, dim=1)
        r_dec = rc * torch.exp(c - wc)
        k_dec = kc * torch.exp(-c)
        y = torch.einsum("bthn,bhnm->bthm", r_dec, St)
        scores = torch.einsum("bihn,bjhn->bhij", r_dec, k_dec)
        ii = torch.arange(T, device=r.device)
        scores = torch.where(ii[:, None] > ii[None, :], scores, 0.0)
        diag = torch.einsum("bihn,hn,bihn->bhi", rc, uf, kc)
        scores = scores + torch.diag_embed(diag)
        y = y + torch.einsum("bhij,bjhn->bihn", scores, vc)
        cT = c[:, -1]                                     # [B, H, N]
        St = torch.exp(cT)[..., None] * St + torch.einsum(
            "bjhn,bjhm->bhnm", k_dec * torch.exp(cT)[:, None], vc)
        ys.append(y.to(r.dtype))
    return torch.cat(ys, 1), St


def scratch_floats(B: int, S: int, H: int, N: int, chunk: int) -> int:
    """Floats of scratch the CUDA kernels take: each chunk's [N, N]
    state increment (then the state before the chunk) and its e^{c_T}
    [N], per (b, h)."""
    return B * H * -(-S // chunk) * N * (N + 1)


def _check(r, k, v, logw, u, s0, chunk: int) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be [B, S, H, N], got {tuple(r.shape)}")
    B, S, H, N = r.shape
    if min(B, S, H, N) < 1 or N > N_MAX:
        raise ValueError(f"r {tuple(r.shape)}: the kernel takes 1 <= N <= "
                         f"{N_MAX} and non-empty B, S, H")
    if not 1 <= chunk <= CHUNK_MAX:
        raise ValueError(f"chunk={chunk} must lie in 1..{CHUNK_MAX}")
    want = {"k": (k, (B, S, H, N)), "v": (v, (B, S, H, N)),
            "logw": (logw, (B, S, H, N)), "u": (u, (H, N))}
    if s0 is not None:
        want["s0"] = (s0, (B, H, N, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} must be {r.dtype} like r, got {t.dtype}")
    for name, t in (("logw", logw), ("u", u), ("s0", s0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("s0", s0)):
        if t is None:
            continue
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, expected {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {r.device}")


def wkv_fwd(r, k, v, logw, u, s0=None, *, chunk: int = 64):
    """r, k, v [B, S, H, N]; logw [B, S, H, N] float32; u [H, N] float32;
    s0 [B, H, N, N] float32 or None -> (y [B, S, H, N] in r's dtype,
    s_T [B, H, N, N] float32)."""
    _check(r, k, v, logw, u, s0, chunk)
    if r.device.type == "cpu":
        return wkv_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
    refuse_grad("wkv", r, k, v, logw, u, s0)
    B, S, H, N = r.shape
    y = torch.empty_like(r)
    s_T = torch.empty(B, H, N, N, dtype=torch.float32, device=r.device)
    scratch = torch.empty(scratch_floats(B, S, H, N, chunk),
                          dtype=torch.float32, device=r.device)
    lib = LIBRARY.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                         logw.data_ptr(), u.data_ptr(),
                         None if s0 is None else s0.data_ptr(),
                         y.data_ptr(), s_T.data_ptr(), scratch.data_ptr(),
                         B, S, H, N, chunk,
                         int(r.dtype == torch.bfloat16), stream)
    LIBRARY.raise_on(rc, "wkv", f"B={B} S={S} H={H} N={N} chunk={chunk} "
                     f"{r.dtype}")
    wkv_fwd.launches += 1
    return y, s_T


wkv_fwd.launches = 0
