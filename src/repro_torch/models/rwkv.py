"""RWKV6 "Finch": attention-free time-mix with data-dependent decay.

The port's counterpart of ``repro/models/rwkv.py``.  Per head (size N) the
WKV state is an [N, N] matrix S and

    y_t = (S_{t-1} + diag(u) k_tᵀ v_t) r_t
    S_t = diag(exp(-exp(w_t))) S_{t-1} + k_tᵀ v_t

with w_t data-dependent (a LoRA on x).  Prefill runs the recurrence
chunk-parallel in the hand-written WKV kernel (``kernels/rwkv6``, its
plain version on the CPU), which takes the carried state in and gives the
final state out; decode runs one step in plain PyTorch, as the reference
computes it in jnp outside any kernel.

The cast points follow the reference line for line: the projections run
in the activations' dtype (weights cast to it at use), the decay LoRA,
the decay and the bonus ``u`` in float32, the WKV state in float32 with
one cast of y, and the per-head group norm in float32.  The reference's
``_act`` sharding constraints are no-ops on one device and are left out;
its ``*_specs`` / ``*_axes`` helpers have no counterpart (the serving
side reads shapes off a cache on the ``meta`` device).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.rwkv6 import wkv_fwd
from .config import ArchConfig
from .layers import PDef

_DECAY_LORA = 64


def _dims(cfg: ArchConfig):
    H = cfg.num_heads
    N = cfg.d_model // H
    return H, N


def rwkv_time_param_defs(cfg: ArchConfig) -> dict[str, Any]:
    d = cfg.d_model
    H, N = _dims(cfg)
    r = _DECAY_LORA
    return {
        "mix_r": PDef((d,), (None,), "ones"),
        "mix_k": PDef((d,), (None,), "ones"),
        "mix_v": PDef((d,), (None,), "ones"),
        "mix_g": PDef((d,), (None,), "ones"),
        "mix_w": PDef((d,), (None,), "ones"),
        "w_r": PDef((d, d), ("fsdp", "tp"), "scaled"),
        "w_k": PDef((d, d), ("fsdp", "tp"), "scaled"),
        "w_v": PDef((d, d), ("fsdp", "tp"), "scaled"),
        "w_g": PDef((d, d), ("fsdp", "tp"), "scaled"),
        "w_o": PDef((d, d), ("tp", "fsdp"), "scaled"),
        # read in float32 (_projections, wkv_*, _group_norm)
        "decay_w1": PDef((d, r), (None, None), "scaled", read_f32=True),
        "decay_w2": PDef((r, d), (None, "tp"), "zeros", read_f32=True),
        "decay_bias": PDef((d,), ("tp",), "rwkv_decay", read_f32=True),
        "bonus_u": PDef((H, N), ("tp", None), "zeros", read_f32=True),
        "ln_x": PDef((d,), (None,), "ones", read_f32=True),
    }


def rwkv_channel_param_defs(cfg: ArchConfig) -> dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": PDef((d,), (None,), "ones"),
        "mix_r": PDef((d,), (None,), "ones"),
        "w_k": PDef((d, f), ("fsdp", "tp"), "scaled"),
        "w_v": PDef((f, d), ("tp", "fsdp"), "scaled"),
        "w_r": PDef((d, d), ("fsdp", "tp"), "scaled"),
    }


def _token_shift(x, prev):
    """x [B,S,D], prev [B,1,D] (last token of previous segment)."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _group_norm(x, gain, H, N, eps=64e-5):
    """Per-head groupnorm on [B, S, H*N], in float32."""
    B, S, _ = x.shape
    xf = x.float().reshape(B, S, H, N)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y.reshape(B, S, H * N) * gain.float()).to(x.dtype)


def wkv_chunked(r, k, v, logw, u, S0, *, chunk: int):
    """Chunk-parallel WKV6 through the hand-written kernel.

    r,k,v: [B, S, H, N];  logw: [B, S, H, N] float32 (log decay, <= 0);
    u: [H, N];  S0: [B, H, N, N] float32 carry, or None for zeros.
    Returns (y [B,S,H,N] in r's dtype, S_final float32).  Chunks start at
    multiples of ``min(chunk, S)`` and the last may be shorter, where the
    reference takes one chunk of length S: the same function, summed in
    another order."""
    S = r.shape[1]
    return wkv_fwd(r.contiguous(), k.contiguous(), v.contiguous(),
                   logw.float().contiguous(), u.float().contiguous(),
                   None if S0 is None else S0.float().contiguous(),
                   chunk=min(chunk, S))


def wkv_step(r, k, v, logw, u, S):
    """One-token WKV: r,k,v,logw [B, H, N];  S [B, H, N, N] f32."""
    rf, kf, vf = (x.float() for x in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhn,bhnm->bhm", rf,
                     S + u.float()[None, :, :, None] * kv)
    S_new = torch.exp(logw.float())[..., None] * S + kv
    return y.to(r.dtype), S_new


def _projections(p, x, xprev, cfg: ArchConfig):
    """Token-shifted projections shared by chunked + step paths."""
    H, N = _dims(cfg)
    B, S = x.shape[:2]

    def mix(m):
        mm = p[m].to(x.dtype)
        return x * mm + xprev * (1.0 - mm)

    r = mix("mix_r") @ p["w_r"].to(x.dtype)
    k = mix("mix_k") @ p["w_k"].to(x.dtype)
    v = mix("mix_v") @ p["w_v"].to(x.dtype)
    g = mix("mix_g") @ p["w_g"].to(x.dtype)
    # data-dependent decay (the Finch feature): w = bias + tanh LoRA
    xw = mix("mix_w").float()
    dd = torch.tanh(xw @ p["decay_w1"].float()) @ p["decay_w2"].float()
    logw = -torch.exp(torch.clamp(p["decay_bias"].float() + dd, -10.0, 2.0))
    hd = (B, S, H, N)
    return (r.reshape(hd), k.reshape(hd), v.reshape(hd), g,
            logw.reshape(hd))


def rwkv_time_mix(p, x, cfg: ArchConfig, state=None, *, chunk: int = 64):
    """Full-sequence time-mix.  x [B,S,D] -> (y, state); ``state=None``
    starts from zeros."""
    H, N = _dims(cfg)
    B, S, D = x.shape
    if state is None:
        prev = torch.zeros(B, 1, D, dtype=x.dtype, device=x.device)
        S0 = None
    else:
        prev, S0 = state["x_prev"], state["S"]
    xprev = _token_shift(x, prev)
    r, k, v, g, logw = _projections(p, x, xprev, cfg)
    y, S_f = wkv_chunked(r, k, v, logw, p["bonus_u"], S0, chunk=chunk)
    y = _group_norm(y.reshape(B, S, D), p["ln_x"], H, N)
    y = y * F.silu(g)
    out = y @ p["w_o"].to(x.dtype)
    return out, {"S": S_f, "x_prev": x[:, -1:]}


def rwkv_time_step(p, x, cfg: ArchConfig, state):
    """One-token time-mix.  x [B,1,D] -> (y, new state); ``state`` is not
    modified."""
    H, N = _dims(cfg)
    B, _, D = x.shape
    xprev = state["x_prev"].to(x.dtype)
    r, k, v, g, logw = _projections(p, x, xprev, cfg)
    y, S_f = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p["bonus_u"],
                      state["S"])
    y = _group_norm(y.reshape(B, 1, D), p["ln_x"], H, N)
    y = y * F.silu(g)
    out = y @ p["w_o"].to(x.dtype)
    return out, {"S": S_f, "x_prev": x}


def rwkv_channel_mix(p, x, cfg: ArchConfig, state=None):
    """relu² channel-mix.  x [B,S,D] -> (y, state)."""
    prev = (torch.zeros(x.shape[0], 1, x.shape[2], dtype=x.dtype,
                        device=x.device) if state is None
            else state["x_prev"])
    xprev = _token_shift(x, prev)

    def mix(m):
        mm = p[m].to(x.dtype)
        return x * mm + xprev * (1.0 - mm)

    kx = torch.square(F.relu(mix("mix_k") @ p["w_k"].to(x.dtype)))
    vx = kx @ p["w_v"].to(x.dtype)
    rx = mix("mix_r") @ p["w_r"].to(x.dtype)
    return torch.sigmoid(rx) * vx, {"x_prev": x[:, -1:]}


def init_rwkv_time_state(cfg: ArchConfig, batch: int, dtype, *,
                         device) -> dict:
    """Zero time-mix state: S [B, H, N, N] float32, x_prev [B, 1, D] in
    ``dtype`` (``device="meta"`` gives shapes without memory)."""
    H, N = _dims(cfg)
    return {
        "S": torch.zeros(batch, H, N, N, dtype=torch.float32, device=device),
        "x_prev": torch.zeros(batch, 1, cfg.d_model, dtype=dtype,
                              device=device),
    }
