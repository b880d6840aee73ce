"""Mamba-1 selective-scan block (Jamba's SSM layer).

The port's counterpart of ``repro/models/mamba.py``.  Per channel d of
d_inner and state n of d_state,

    h_t = exp(dt_t A) ⊙ h_{t-1} + (dt_t B_t) x_t,   y_t = h_t · C_t + D x_t

with dt, B and C data-dependent projections of x (float32).  Prefill runs
the recurrence in the hand-written selective-scan kernel's fused entry
(``kernels/mamba_scan.mamba_scan_fused``, its plain version on the CPU),
which discretises inside the kernel, takes the carried state in and gives
the final state out; decode runs one step in plain PyTorch, as the
reference computes it in jnp outside any kernel.

Where the reference differs in form, not in function:

* it runs the recurrence as a ``lax.associative_scan`` per chunk of
  ``cfg.mamba.chunk`` steps with h carried across chunks (one chunk of
  length S when ``chunk`` does not divide S); the kernel walks the steps
  in order: the same function, summed in another order;
* it applies the causal depthwise conv per chunk with the conv state
  carried; the port applies it once over the whole prompt with the
  carried state, which gives every output the same K terms in the same
  order.

The cast points follow the reference line for line: the in / out
projections and the conv run in the activations' dtype (weights cast to it
at use), ``_dt_B_C``, ``A_log`` and ``D_skip`` in float32, the state h in
float32 and y cast once to the activations' dtype before the ``silu(z)``
gate.  The seven leaves read in float32 carry ``read_f32=True`` so a
bfloat16 engine keeps them float32.  The reference's ``shard_constraint``
is a no-op on one device and is left out; its ``*_specs`` / ``*_axes``
helpers have no counterpart (the serving side reads shapes off a cache on
the ``meta`` device).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import mamba_scan_fused
from .config import ArchConfig
from .layers import PDef


def _dims(cfg: ArchConfig):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or math.ceil(cfg.d_model / 16)
    return d_inner, m.d_state, m.d_conv, dt_rank


def mamba_param_defs(cfg: ArchConfig) -> dict[str, Any]:
    d = cfg.d_model
    d_in, N, K, R = _dims(cfg)
    return {
        "in_proj": PDef((d, 2 * d_in), ("fsdp", "tp"), "scaled"),
        "conv_w": PDef((K, d_in), (None, "tp"), "scaled"),
        "conv_b": PDef((d_in,), ("tp",), "zeros"),
        # read in float32 (_dt_B_C, mamba_apply, mamba_decode)
        "x_dt": PDef((d_in, R), ("tp", None), "scaled", read_f32=True),
        "dt_proj": PDef((R, d_in), (None, "tp"), "scaled", read_f32=True),
        "dt_bias": PDef((d_in,), ("tp",), "mamba_dt", read_f32=True),
        "x_B": PDef((d_in, N), ("tp", None), "scaled", read_f32=True),
        "x_C": PDef((d_in, N), ("tp", None), "scaled", read_f32=True),
        "A_log": PDef((d_in, N), ("tp", None), "mamba_A", read_f32=True),
        "D_skip": PDef((d_in,), ("tp",), "ones", read_f32=True),
        "out_proj": PDef((d_in, d), ("tp", "fsdp"), "scaled"),
    }


def _dt_B_C(p, x):
    """x [..., d_in] (post-conv, post-silu) -> (dt, B, C) in float32;
    dt = softplus(x x_dt dt_proj + dt_bias), as ``jax.nn.softplus``
    computes it (``logaddexp(., 0)``)."""
    xf = x.float()
    v = (xf @ p["x_dt"].float()) @ p["dt_proj"].float() + p["dt_bias"].float()
    dt = torch.logaddexp(v, torch.zeros((), dtype=v.dtype, device=v.device))
    return dt, xf @ p["x_B"].float(), xf @ p["x_C"].float()


def _causal_conv_chunk(x, conv_state, w, b):
    """x [Bt, T, d_in]; conv_state [Bt, K-1, d_in] -> (y, new_state):
    the depthwise causal conv y_t = sum_k w_k x_{t-K+1+k} + b over the
    carried state and x, in x's dtype."""
    K = w.shape[0]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    T = x.shape[1]
    y = sum(xp[:, i:i + T] * w[i].to(x.dtype) for i in range(K))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(K - 1):] if K > 1 else conv_state
    return y, new_state


def mamba_apply(p, x, cfg: ArchConfig, state=None):
    """Full-sequence (prefill) mamba block.  x [B, S, D] -> (y [B, S, D],
    final state {"h", "conv"}); ``state=None`` starts from zeros."""
    Bt = x.shape[0]
    dt_c = x.dtype
    xz = x @ p["in_proj"].to(dt_c)
    xin, z = xz.chunk(2, dim=-1)
    if state is None:
        state = init_mamba_state(cfg, Bt, dt_c, device=x.device)
    A = -torch.exp(p["A_log"].float())                   # [d_in, N]
    xc, conv = _causal_conv_chunk(xin, state["conv"], p["conv_w"],
                                  p["conv_b"])
    u = F.silu(xc)
    dt, Bm, Cm = _dt_B_C(p, u)                           # [B,S,d_in],[B,S,N]
    y, h = mamba_scan_fused(dt.contiguous(), A.contiguous(),
                            Bm.contiguous(), u.contiguous(), Cm.contiguous(),
                            state["h"].float().contiguous())
    y = (y + u.float() * p["D_skip"].float()).to(dt_c)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(dt_c), {"h": h, "conv": conv}


def mamba_decode(p, x, cfg: ArchConfig, state):
    """One-token step.  x [B, 1, D] -> (y [B, 1, D], new state); ``state``
    is not modified (the layer copies the new state into its cache)."""
    xz = x @ p["in_proj"].to(x.dtype)
    xin, z = xz.chunk(2, dim=-1)
    xc, conv = _causal_conv_chunk(xin, state["conv"], p["conv_w"],
                                  p["conv_b"])
    u = F.silu(xc)                                       # [B, 1, d_in]
    dt, Bm, Cm = _dt_B_C(p, u)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[:, 0, :, None] * A)                 # [B, d_in, N]
    b = (dt[:, 0, :, None] * Bm[:, 0, None, :]) * u.float()[:, 0, :, None]
    h = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None]
    y = y + u.float() * p["D_skip"].float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"].to(x.dtype), {"h": h, "conv": conv}


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, *, device) -> dict:
    """Zero state: h [B, d_in, N] float32, conv [B, K-1, d_in] in ``dtype``
    (``device="meta"`` gives shapes without memory)."""
    d_in, N, K, _ = _dims(cfg)
    return {
        "h": torch.zeros(batch, d_in, N, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, K - 1, d_in, dtype=dtype, device=device),
    }
