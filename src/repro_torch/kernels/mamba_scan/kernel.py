"""Wrappers of the hand-written Mamba-1 selective-scan CUDA kernel, beside
their plain PyTorch versions.

Both entries run the recurrence, per channel d and state n,

    h_t = a_t h_{t-1} + b_t,        y_t[d] = sum_n h_t[d, n] C_t[n]

in float32, in order over t.

* ``mamba_scan_fwd(a, b, c, *, chunk=64, block_d=256)`` is the function
  and signature of the reference's Pallas kernel
  ``repro/kernels/mamba_scan/kernel.py:mamba_scan_fwd``: a / b
  [B, S, d_in, N] pre-discretised (float32 or bfloat16, one dtype), c
  [B, S, N] (float32 or bfloat16), h starting from zero, y [B, S, d_in] in
  a's dtype.  ``chunk`` and ``block_d`` are the Pallas kernel's tiles; the
  CUDA kernel picks its own, and the result does not depend on them.
* ``mamba_scan_fused(dt, A, Bm, u, C, h0=None)`` is the port's entry for
  the model (``models/mamba.py``): dt [B, S, d_in] float32, A [d_in, N]
  float32 (already ``-exp(A_log)``), Bm / C [B, S, N] float32, u
  [B, S, d_in] in the compute dtype and the carried state h0 [B, d_in, N]
  float32 (``None``: zeros).  It forms ``a = exp(dt A)`` and
  ``b = (dt Bm) u`` inside the kernel, in the order of the reference's
  ``mamba_apply``, and returns ``(y float32 [B, S, d_in], h_T float32
  [B, d_in, N])``.  The a and b of jamba-1.5-large's layer would take
  2.15 GB each in float32 at 2048 tokens, and decode needs the state.

Each checks its inputs, then

* for CPU tensors returns its plain version (:func:`mamba_scan_ref`,
  :func:`mamba_scan_fused_ref`: the sequential loop in float32);
* for CUDA tensors allocates the outputs, launches its kernel of
  ``csrc/mamba_scan.cu`` on the current stream, raises if the launch is
  refused, and adds one to its own ``.launches``.  There is no fallback:
  a CUDA tensor never reaches a plain version through a wrapper.

On the card the wrapper raises ``NotImplementedError`` when autograd
tracks one of its inputs (``kernels.refuse_grad``): the kernel has no
backward kernel yet, and its output would carry no gradient.
"""

from __future__ import annotations

import torch

from .. import refuse_grad
from .build import LIBRARY

N_MAX = 16
_DTYPES = (torch.float32, torch.bfloat16)


def mamba_scan_ref(a, b, c):
    """Plain version of :func:`mamba_scan_fwd`: the reference's oracle
    ``repro/kernels/mamba_scan/ref.py:mamba_scan_ref``, step by step in
    float32 from h = 0, y cast once to a's dtype."""
    B, S, d_in, N = a.shape
    af, bf, cf = a.float(), b.float(), c.float()
    h = torch.zeros(B, d_in, N, dtype=torch.float32, device=a.device)
    ys = []
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, 1).to(a.dtype)


def mamba_scan_fused_ref(dt, A, Bm, u, C, h0=None):
    """Plain version of :func:`mamba_scan_fused`: per step, ``a = exp(dt
    A)``, ``b = (dt Bm) u``, ``h = a h + b``, ``y = h · C``, in float32.
    Returns ``(y float32, h_T float32)``."""
    B, S, d_in = dt.shape
    N = A.shape[-1]
    Af, uf = A.float(), u.float()
    h = (torch.zeros(B, d_in, N, dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float().clone())
    ys = []
    for t in range(S):
        d = dt[:, t, :, None]
        h = torch.exp(d * Af) * h + (d * Bm[:, t, None, :]) * uf[:, t, :, None]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, 1), h


def _same_place(ref, named) -> None:
    for name, t in named:
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ref.device}")


def _check_sizes(B, S, d_in, N) -> None:
    if min(B, S, d_in, N) < 1 or N > N_MAX:
        raise ValueError(f"[B, S, d_in, N] = {[B, S, d_in, N]}: the kernel "
                         f"takes 1 <= N <= {N_MAX} and non-empty B, S, d_in")


def _check_shapes(want: dict) -> None:
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")


def mamba_scan_fwd(a, b, c, *, chunk: int = 64, block_d: int = 256):
    """a / b [B, S, d_in, N]; c [B, S, N] -> y [B, S, d_in] in a's
    dtype."""
    if a.dim() != 4:
        raise ValueError(f"a must be [B, S, d_in, N], got {tuple(a.shape)}")
    B, S, d_in, N = a.shape
    _check_sizes(B, S, d_in, N)
    if chunk < 1 or block_d < 1:
        raise ValueError(f"chunk={chunk} and block_d={block_d} must be >= 1")
    _check_shapes({"b": (b, (B, S, d_in, N)), "c": (c, (B, S, N))})
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must be one of float32 / bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if c.dtype not in _DTYPES:
        raise TypeError(f"c must be float32 or bfloat16, got {c.dtype}")
    _same_place(a, (("a", a), ("b", b), ("c", c)))
    if a.device.type == "cpu":
        return mamba_scan_ref(a, b, c)
    refuse_grad("mamba_scan_fwd", a, b, c)
    y = torch.empty(B, S, d_in, dtype=a.dtype, device=a.device)
    lib = LIBRARY.load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.mamba_scan_fwd(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                y.data_ptr(), B, S, d_in, N,
                                int(a.dtype == torch.bfloat16),
                                int(c.dtype == torch.bfloat16), stream)
    LIBRARY.raise_on(rc, "mamba_scan_fwd", f"B={B} S={S} d_in={d_in} N={N} "
                     f"{a.dtype}")
    mamba_scan_fwd.launches += 1
    return y


def mamba_scan_fused(dt, A, Bm, u, C, h0=None):
    """dt [B, S, d_in] float32; A [d_in, N] float32; Bm / C [B, S, N]
    float32; u [B, S, d_in] float32 or bfloat16; h0 [B, d_in, N] float32 or
    None -> (y [B, S, d_in] float32, h_T [B, d_in, N] float32)."""
    if dt.dim() != 3 or A.dim() != 2:
        raise ValueError(f"dt must be [B, S, d_in] and A [d_in, N], got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    B, S, d_in = dt.shape
    N = A.shape[1]
    _check_sizes(B, S, d_in, N)
    _check_shapes({"A": (A, (d_in, N)), "Bm": (Bm, (B, S, N)),
                   "u": (u, (B, S, d_in)), "C": (C, (B, S, N)),
                   "h0": (h0, (B, d_in, N))})
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("C", C), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if u.dtype not in _DTYPES:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    _same_place(dt, (("dt", dt), ("A", A), ("Bm", Bm), ("u", u), ("C", C),
                     ("h0", h0)))
    if dt.device.type == "cpu":
        return mamba_scan_fused_ref(dt, A, Bm, u, C, h0)
    refuse_grad("mamba_scan_fused", dt, A, Bm, u, C, h0)
    y = torch.empty(B, S, d_in, dtype=torch.float32, device=dt.device)
    h_T = torch.empty(B, d_in, N, dtype=torch.float32, device=dt.device)
    lib = LIBRARY.load()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        rc = lib.mamba_scan_fused(dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                                  u.data_ptr(), C.data_ptr(),
                                  None if h0 is None else h0.data_ptr(),
                                  y.data_ptr(), h_T.data_ptr(), B, S, d_in, N,
                                  int(u.dtype == torch.bfloat16), stream)
    LIBRARY.raise_on(rc, "mamba_scan_fused", f"B={B} S={S} d_in={d_in} "
                     f"N={N} u {u.dtype}")
    mamba_scan_fused.launches += 1
    return y, h_T


mamba_scan_fwd.launches = 0
mamba_scan_fused.launches = 0
