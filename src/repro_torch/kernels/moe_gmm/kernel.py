"""Wrapper of the hand-written grouped-matmul CUDA kernel, beside its plain
PyTorch version and the reference's static-capacity layout helper.

``gmm(x, w, block_expert, nvalid, block_m=)`` takes x [M, K] (rows sorted
by expert, M % block_m == 0), w [E, K, N] (float32 or bfloat16, one dtype,
contiguous) and block_expert / nvalid [M // block_m] int32, and returns
out [M, N] in x's dtype: the signature of the reference's Pallas kernel
``repro/kernels/moe_gmm/kernel.py:gmm`` without its ``block_n`` /
``block_k`` (the CUDA kernel picks its own tiles).  ``block_m`` must be a
multiple of 16 (the kernel's smallest row tile).  It checks its inputs,
then

* for CPU tensors returns the plain version, :func:`gmm_ref`;
* for CUDA tensors allocates the output, launches one of three kernels on
  the current stream, raises if the launch is refused, adds one to
  ``gmm.launches`` and records the route it took in ``gmm.last_route``.
  :func:`_gmm_route`, a pure function of the call, picks the kernel before
  the launch: for bf16 with K and N multiples of 8, ``"wgmma"``,
  ``csrc/moe_gmm_tc.cu`` on the tensor cores, for prefill blocks (block_m
  a multiple of 64), and ``"mma"``, ``csrc/moe_gmm_dec.cu`` (mma.sync fed
  by TMA, split K; memory-bound), for the decode blocks of 16 and 32
  rows; ``"simt"``, ``csrc/moe_gmm.cu`` on the CUDA cores, for float32
  and ragged shapes.  All three are hand-written kernels; there is no
  fallback: a CUDA tensor never reaches the plain version through the
  wrapper, and a refused launch raises.

On the card the wrapper raises ``NotImplementedError`` when autograd
tracks one of its inputs (``kernels.refuse_grad``): the kernel has no
backward kernel yet, and its output would carry no gradient.
"""

from __future__ import annotations

import torch

from .. import refuse_grad
from .build import LIBRARY

_DTYPES = (torch.float32, torch.bfloat16)
# csrc/moe_gmm_dec.cu's output tile width, K-stage depth and most K
# splits, and the CTAs it may keep per SM (its grid is at most this many
# per SM, fewer where fewer fit)
_DEC_TN, _DEC_TK, _DEC_S_MAX, _DEC_CTAS_PER_SM = 128, 64, 16, 3
# the "mma" route's split-K counters, one buffer per (device, stream): the
# tile's last CTA sets its counter back to 0, so the counters are zero
# between launches (no memset), and launches on one stream run in order
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def gmm_ref(x, w, block_expert, nvalid, *, block_m: int):
    """Plain version: ``out[i] = x[i] @ w[block_expert[i // block_m]]``
    with float32 products and sums and one cast to x's dtype, and zero
    rows for blocks with ``nvalid == 0``.

    It follows the Pallas kernel (``dot_general`` with
    ``preferred_element_type=float32`` into a float32 accumulator, cast
    once at the end), not the reference's oracle
    ``repro/kernels/moe_gmm/ref.py:gmm_ref``, whose einsum runs in x's
    dtype; in float32 the two are the same function."""
    M, K = x.shape
    N = w.shape[-1]
    nm = M // block_m
    out = torch.zeros(nm, block_m, N, dtype=torch.float32, device=x.device)
    keep = torch.nonzero(nvalid > 0)[:, 0]
    xb = x.reshape(nm, block_m, K)[keep].float()
    out[keep] = torch.bmm(xb, w[block_expert[keep].long()].float())
    return out.reshape(M, N).to(x.dtype)


def pad_groups(x_groups, block_m: int):
    """Static capacity path: x_groups [E, C, K] -> (x [E*Cp, K],
    block_expert, nvalid) with C padded to a block_m multiple."""
    E, C, K = x_groups.shape
    Cp = (C + block_m - 1) // block_m * block_m
    pad = Cp - C
    dev = x_groups.device
    xg = torch.nn.functional.pad(x_groups, (0, 0, 0, pad))
    x = xg.reshape(E * Cp, K)
    blocks_per_e = Cp // block_m
    block_expert = torch.arange(E, dtype=torch.int32,
                                device=dev).repeat_interleave(blocks_per_e)
    row_valid = torch.cat([torch.ones(C, dtype=torch.int32, device=dev),
                           torch.zeros(pad, dtype=torch.int32, device=dev)])
    nvalid = row_valid.reshape(blocks_per_e, block_m).sum(1,
                                                         dtype=torch.int32)
    nvalid = nvalid.tile(E)
    return x, block_expert, nvalid


def _gmm_route(dtype, block_m: int, K: int, N: int) -> str:
    """The kernel a CUDA call takes: for bf16 with K and N multiples of 8
    (rows of 16 bytes, for TMA), ``"wgmma"`` (tensor cores, prefill) when
    block_m is a multiple of 64 and ``"mma"`` (tensor cores, decode) when
    it is 16 or 32; else ``"simt"``."""
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0:
        if block_m % 64 == 0:
            return "wgmma"
        if block_m in (16, 32):
            return "mma"
    return "simt"


def dec_splits(n_valid_blocks: int, K: int, N: int, grid: int) -> int:
    """The K splits of the ``"mma"`` route, as each of its ``grid`` CTAs
    derives them on the card from the count of valid blocks: enough that
    the ``n_valid_blocks x ceil(N / 128)`` output tiles times the splits
    fill the grid, at most one per 64-deep K tile and at most 16."""
    if n_valid_blocks == 0:
        return 1
    nt, nk = -(-N // _DEC_TN), -(-K // _DEC_TK)
    return max(1, min(grid // (n_valid_blocks * nt), nk, _DEC_S_MAX))


def dec_split_range(K: int, S: int, s: int) -> tuple[int, int]:
    """The 64-deep K tiles [k0, k1) that split ``s`` of ``S`` sums."""
    nk = -(-K // _DEC_TK)
    return s * nk // S, (s + 1) * nk // S


def _check(x, w, block_expert, nvalid, block_m: int) -> None:
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"x must be [M, K] and w [E, K, N], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    M, K = x.shape
    E, Kw, N = w.shape
    if Kw != K or min(M, K, E, N) < 1:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do "
                         f"not match")
    if block_m < 16 or block_m % 16 or M % block_m:
        raise ValueError(f"block_m={block_m} must be a multiple of 16 that "
                         f"divides M={M}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise TypeError(f"{name} must be float32 or bfloat16 like x, got "
                            f"{t.dtype}")
    for name, t in (("block_expert", block_expert), ("nvalid", nvalid)):
        if t.dtype != torch.int32 or tuple(t.shape) != (M // block_m,):
            raise ValueError(f"{name} must be int32 [{M // block_m}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("x", x), ("w", w), ("block_expert", block_expert),
                    ("nvalid", nvalid)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _launch(x, w, block_expert, nvalid, block_m: int, route: str):
    """Launch the kernel of ``route`` on CUDA tensors that passed
    :func:`_check` and return out; counts nothing (the wrapper counts)."""
    M, K = x.shape
    E, _, N = w.shape
    if route != "simt" and _gmm_route(x.dtype, block_m, K, N) != route:
        raise ValueError(f"the {route} kernel does not take {x.dtype} "
                         f"block_m={block_m} K={K} N={N} (see _gmm_route)")
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
                nvalid.data_ptr(), out.data_ptr())
        if route == "wgmma":
            rc = lib.moe_gmm_tc(*ptrs, M, K, N, E, block_m, stream)
        elif route == "mma":
            grid = _DEC_CTAS_PER_SM * torch.cuda.get_device_properties(
                x.device).multi_processor_count
            scratch = torch.empty(grid * block_m * _DEC_TN,
                                  dtype=torch.float32, device=x.device)
            key = (x.device.index, stream)
            counters = _COUNTERS.get(key)
            if counters is None or counters.numel() < grid:
                counters = torch.zeros(grid, dtype=torch.int32,
                                       device=x.device)
                _COUNTERS[key] = counters
            rc = lib.moe_gmm_dec(*ptrs, scratch.data_ptr(),
                                 counters.data_ptr(), M, K, N, E, block_m,
                                 grid, stream)
        else:
            rc = lib.moe_gmm(*ptrs, M, K, N, E, block_m,
                             int(x.dtype == torch.bfloat16), stream)
    LIBRARY.raise_on(rc, f"gmm ({route})", f"M={M} K={K} N={N} E={E} "
                     f"block_m={block_m} {x.dtype}")
    return out


def gmm(x, w, block_expert, nvalid, *, block_m: int = 128):
    """x [M, K]; w [E, K, N]; block_expert / nvalid [M // block_m] int32
    -> out [M, N]."""
    _check(x, w, block_expert, nvalid, block_m)
    if x.device.type == "cpu":
        return gmm_ref(x, w, block_expert, nvalid, block_m=block_m)
    refuse_grad("gmm", x, w)
    route = _gmm_route(x.dtype, block_m, x.shape[1], w.shape[2])
    out = _launch(x, w, block_expert, nvalid, block_m, route)
    gmm.launches += 1
    gmm.last_route = route
    return out


gmm.launches = 0
gmm.last_route = None
