"""Decoder machinery of the port: the dense, MoE, RWKV (ssm) and hybrid
families' stages and layers.

The counterpart of ``repro/models/transformer.py`` for the ``dense``,
``moe`` (GQA attention, not MLA), ``ssm`` and ``hybrid`` families:

  dense (starcoder2):    [(attn, dense)] x num_layers
  moe (moonshot):        [(attn, dense)] x first_dense, then
                         [(attn, moe)] x (num_layers - first_dense)
  ssm (rwkv6):           [(rwkv, channelmix)] x num_layers
  hybrid (jamba):        [(mamba | attn at attn_every // 2, dense | moe on
                         every moe.every-th)] blocks of attn_every layers

Parameters and caches keep the reference's layout, stacked over the
repeat dimension on axis 0 (``stages[i]["l0"]``), and the stage body runs
as a Python loop over the layers where the reference runs ``lax.scan``.
Two modes share one code path:

  prefill  — full sequence (causal flash attention, the chunked WKV
             kernel, or the selective-scan kernel), returns the caches:
             KV, the RWKV state, or the Mamba state
  decode   — one token against the caches at position ``pos``; the caches
             are updated in place (the reference returns new ones): the
             KV rows at ``pos``, and the whole RWKV state (S, x_prev) or
             Mamba state (h, conv)

The reference's layers also return the MoE router's auxiliary loss, a
training term; these serving paths read no loss, so a MoE layer asks
``moe_ffn`` for none (``with_aux=False``).  Other families (vlm,
encdec) and MLA attention (deepseek-v3) raise ``NotImplementedError``:
their layers are still to port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .config import ArchConfig
from . import mamba as _mamba
from . import moe as _moe
from . import rwkv as _rwkv
from .layers import (PDef, apply_rope, attention_decode, cache_update,
                     dtype_of, flash_attention, rms_norm, stack_defs, swiglu,
                     tree_map)


def require_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg``: the
    dense family, the MoE family with GQA attention, the ssm (RWKV6) or
    the hybrid (jamba) family."""
    if cfg.family == "moe" and cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name} uses MLA attention, still to port (ROADMAP.md "
            f"Queue 1 item 13)")
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"repro_torch runs the dense, moe, ssm and hybrid families; "
            f"{cfg.name} is {cfg.family!r}, still to port (ROADMAP.md "
            f"Queue 1 item 13)")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                 # "attn" | "rwkv" | "mamba" (the port's kinds)
    cross: bool = False       # extra cross-attn sublayer (enc-dec decoder)
    ffn: str = "dense"        # "dense" | "moe" | "channelmix"
    causal: bool = True       # False for encoder self-attention


@dataclasses.dataclass(frozen=True)
class Stage:
    pattern: tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


def decoder_stages(cfg: ArchConfig) -> tuple[Stage, ...]:
    """The stage structure of the decoder."""
    require_ported(cfg)
    if cfg.family == "dense":
        return (Stage((LayerSpec("attn"),), cfg.num_layers),)
    if cfg.family == "ssm":
        return (Stage((LayerSpec("rwkv", ffn="channelmix"),),
                      cfg.num_layers),)
    if cfg.family == "hybrid":
        # attn:mamba 1:7 interleave, attention in the middle of the block;
        # MoE on every `cfg.moe.every`-th layer
        P, every = cfg.attn_every, cfg.moe.every
        if cfg.num_layers % P:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"whole blocks of {P}")
        pat = tuple(LayerSpec("attn" if j == P // 2 else "mamba",
                              ffn="moe" if j % every == every - 1
                              else "dense") for j in range(P))
        return (Stage(pat, cfg.num_layers // P),)
    m = cfg.moe
    stages = []
    if m.first_dense:
        stages.append(Stage((LayerSpec("attn", ffn="dense"),),
                            m.first_dense))
    stages.append(Stage((LayerSpec("attn", ffn="moe"),),
                        cfg.num_layers - m.first_dense))
    return tuple(stages)


# --------------------------------------------------------------------------
# Parameter defs
# --------------------------------------------------------------------------


def gqa_param_defs(cfg: ArchConfig) -> dict[str, Any]:
    d, H, Kh, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": PDef((d, H, Dh), ("fsdp", "heads", None), "scaled"),
        "wk": PDef((d, Kh, Dh), ("fsdp", "kv_heads", None), "scaled"),
        "wv": PDef((d, Kh, Dh), ("fsdp", "kv_heads", None), "scaled"),
        "wo": PDef((H, Dh, d), ("heads", None, "fsdp"), "scaled"),
    }


def dense_ffn_param_defs(cfg: ArchConfig) -> dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": PDef((d, f), ("fsdp", "tp"), "scaled"),
        "w_up": PDef((d, f), ("fsdp", "tp"), "scaled"),
        "w_down": PDef((f, d), ("tp", "fsdp"), "scaled"),
    }


_MIXERS = {"attn": gqa_param_defs, "rwkv": _rwkv.rwkv_time_param_defs,
           "mamba": _mamba.mamba_param_defs}
_FFNS = {"dense": dense_ffn_param_defs, "moe": _moe.moe_param_defs,
         "channelmix": _rwkv.rwkv_channel_param_defs}


def layer_param_defs(cfg: ArchConfig, spec: LayerSpec) -> dict[str, Any]:
    if spec.kind not in _MIXERS or spec.cross or spec.ffn not in _FFNS:
        raise NotImplementedError(f"layer {spec} is not ported (dense, moe, "
                                  f"ssm and hybrid families only)")
    d = cfg.d_model
    # the norm gains are read in float32 (rms_norm)
    return {"norm_attn": PDef((d,), (None,), "ones", read_f32=True),
            "attn": _MIXERS[spec.kind](cfg),
            "norm_ffn": PDef((d,), (None,), "ones", read_f32=True),
            "ffn": _FFNS[spec.ffn](cfg)}


def stage_param_defs(cfg: ArchConfig, stage: Stage) -> dict[str, Any]:
    return {f"l{j}": stack_defs(layer_param_defs(cfg, spec), stage.repeats)
            for j, spec in enumerate(stage.pattern)}


# --------------------------------------------------------------------------
# Apply
# --------------------------------------------------------------------------


def _proj(x, w):
    """einsum("bsd,dhe->bshe", x, w) as one matmul (w cast to x's dtype)."""
    d, h, e = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * e)).view(*x.shape[:-1], h, e)


def gqa_apply(cfg: ArchConfig, p, x, ctx, cache, spec: LayerSpec):
    """Self-attention (GQA + RoPE).  Returns (out, new_cache)."""
    mode = ctx["mode"]
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    sin, cos = ctx["rope"]
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if mode == "decode":
        pos = ctx["pos"]
        ck = cache_update(cache["k"], k, pos)
        cv = cache_update(cache["v"], v, pos)
        o = attention_decode(q, ck, cv, ctx["pos_b"])
        new_cache = {"k": ck, "v": cv}
    else:
        o = flash_attention(q, k, v, causal=spec.causal,
                            chunk_q=cfg.attn_chunk, chunk_k=cfg.attn_chunk)
        dt = dtype_of(cfg.compute_dtype)
        new_cache = ({"k": k.to(dt), "v": v.to(dt)} if mode == "prefill"
                     else None)
    wo = p["wo"].to(x.dtype)
    out = o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])
    return out, new_cache


def _store(cache: dict, new: dict) -> dict:
    """Copy a decode step's new state into ``cache`` in place."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def apply_layer(cfg: ArchConfig, spec: LayerSpec, p, x, ctx, cache):
    """One (attn | mamba, dense | moe) or (rwkv, channelmix) layer.
    Returns (x, new_cache_or_None); decode updates ``cache`` in place."""
    mode = ctx["mode"]
    cache = cache or {}
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if spec.kind == "mamba":
        if mode == "decode":
            o, c = _mamba.mamba_decode(p["attn"], h, cfg, cache["attn"])
            c = _store(cache["attn"], c)
        else:
            o, c = _mamba.mamba_apply(p["attn"], h, cfg,
                                      state=cache.get("attn"))
    elif spec.kind == "rwkv":
        if mode == "decode":
            o, c = _rwkv.rwkv_time_step(p["attn"], h, cfg, cache["attn"])
            c = _store(cache["attn"], c)
        else:
            o, c = _rwkv.rwkv_time_mix(p["attn"], h, cfg,
                                       state=cache.get("attn"))
    else:
        o, c = gqa_apply(cfg, p["attn"], h, ctx, cache.get("attn"), spec)
    x = x + o
    new_cache = {"attn": c}
    h = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    f = p["ffn"]
    if spec.ffn == "moe":
        x = x + _moe.moe_ffn(h, f, cfg, with_aux=False)[0]
    elif spec.ffn == "channelmix":
        y, c = _rwkv.rwkv_channel_mix(f, h, cfg, state=cache.get("ffn"))
        x = x + y
        new_cache["ffn"] = _store(cache["ffn"], c) if mode == "decode" else c
    else:
        x = x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"])
    return x, new_cache


def _stack(trees: list):
    """Stack a list of same-shaped trees leaf by leaf on a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if first is None:
        return None
    return torch.stack(trees)


def run_stage(cfg: ArchConfig, stage: Stage, sparams, x, ctx, scache):
    """The stage body over its repeat dimension, layer by layer.  Prefill
    returns the stacked caches, decode the (updated) ``scache``."""
    mode = ctx["mode"]
    caches = []
    for r in range(stage.repeats):
        p_r = tree_map(lambda a: a[r], sparams)
        c_r = tree_map(lambda a: a[r], scache) if scache is not None else {}
        out_c = {}
        for j, spec in enumerate(stage.pattern):
            key = f"l{j}"
            x, out_c[key] = apply_layer(cfg, spec, p_r[key], x, ctx,
                                        c_r.get(key))
        caches.append(out_c)
    if mode == "decode":
        return x, scache
    return x, _stack(caches) if mode == "prefill" else None


def run_stages(cfg: ArchConfig, stages, params, x, ctx, caches=None):
    """params/caches: tuple (one entry per stage).  Returns (x, caches)."""
    new_caches = []
    for si, stage in enumerate(stages):
        sc = caches[si] if caches is not None else None
        x, nc = run_stage(cfg, stage, params[si], x, ctx, sc)
        new_caches.append(nc)
    return x, tuple(new_caches)


# --------------------------------------------------------------------------
# Caches (mirror run_stage's tree: tuple of stage dicts)
# --------------------------------------------------------------------------


def _layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                 seq: int) -> dict:
    """One layer's cache on the ``meta`` device (shapes and dtypes only):
    KV [batch, seq, Kh, Dh] in the compute dtype, the RWKV state
    (time-mix S float32 [batch, H, N, N] and x_prev, channel-mix x_prev
    [batch, 1, d], in the compute dtype), or the Mamba state (h float32
    [batch, d_in, N], conv [batch, K-1, d_in] in the compute dtype)."""
    dt = dtype_of(cfg.compute_dtype)
    if spec.kind == "mamba":
        return {"attn": _mamba.init_mamba_state(cfg, batch, dt,
                                                device="meta")}
    if spec.kind == "rwkv" and spec.ffn == "channelmix":
        return {"attn": _rwkv.init_rwkv_time_state(cfg, batch, dt,
                                                   device="meta"),
                "ffn": {"x_prev": torch.zeros(batch, 1, cfg.d_model,
                                              dtype=dt, device="meta")}}
    if spec.kind != "attn" or spec.cross:
        raise NotImplementedError(f"cache of layer {spec}")
    shape = (batch, seq, cfg.num_kv_heads, cfg.head_dim)
    return {"attn": {name: torch.zeros(shape, dtype=dt, device="meta")
                     for name in ("k", "v")}}


def cache_template(cfg: ArchConfig, stages, batch: int, seq: int, *,
                   device) -> tuple:
    """Zero caches, each layer's leaves stacked over the stage's repeats
    on axis 0; ``device="meta"`` gives shapes and dtypes without
    memory."""
    return tuple(
        {f"l{j}": tree_map(lambda t: torch.zeros(
            (stage.repeats,) + t.shape, dtype=t.dtype, device=device),
            _layer_cache(cfg, spec, batch, seq))
         for j, spec in enumerate(stage.pattern)}
        for stage in stages)
