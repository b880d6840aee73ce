"""Decoder machinery of the port: every family's stages and layers.

The counterpart of ``repro/models/transformer.py``:

  dense (starcoder2):    [(attn, dense)] x num_layers
  moe (moonshot):        [(attn, dense)] x first_dense, then
                         [(attn, moe)] x (num_layers - first_dense)
  moe + MLA (deepseek):  the same with "mla" attention
  ssm (rwkv6):           [(rwkv, channelmix)] x num_layers
  hybrid (jamba):        [(mamba | attn at attn_every // 2, dense | moe on
                         every moe.every-th)] blocks of attn_every layers
  vlm (llama-3.2-vision): [(attn, dense) x (E - 1), (xattn, dense)] blocks
                         of E = cross_attn_every layers
  encdec (seamless):     decoder [(attn + cross, dense)] x num_layers;
                         encoder [(attn non-causal, dense)] x enc_layers

Parameters and caches keep the reference's layout, stacked over the
repeat dimension on axis 0 (``stages[i]["l0"]``), and the stage body runs
as a Python loop over the layers where the reference runs ``lax.scan``.
Three modes share one code path:

  train    — full sequence, no caches (the encoder runs in this mode);
             the layers are taken out of the stacked leaves with one
             ``unbind`` a leaf, each layer runs under the config's remat
             policy, and the MoE router's auxiliary loss is summed
  prefill  — full sequence (flash attention, the chunked WKV kernel or
             the selective-scan kernel), returns the caches: KV, the
             static cross-attention KV of the source, the MLA latent, the
             RWKV state or the Mamba state
  decode   — one token against the caches at position ``pos``; the caches
             are updated in place (the reference returns new ones): the
             KV / latent rows at ``pos``, and the whole RWKV state (S,
             x_prev) or Mamba state (h, conv); the cross-attention cache
             stays as the prefill left it

Cross-attention decodes against its whole static cache, at position
S_src - 1 of a cache of S_src rows, as the reference does; MLA decodes in
the reference's absorbed form (attention in the latent space) as plain
PyTorch products, since the reference computes it with ``jnp.einsum``
outside any kernel.  The reference's layers also return the MoE router's
auxiliary loss, a training term: in train mode a MoE layer asks
``moe_ffn`` for it and hands it up under its cache's ``"aux"`` key (train
mode keeps no caches), and :func:`run_stages` returns the sum; the
serving paths read no loss, so there a MoE layer asks for none
(``with_aux=False``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .config import ArchConfig
from . import mamba as _mamba
from . import moe as _moe
from . import rwkv as _rwkv
from .layers import (NEG_INF, PDef, apply_rope, attention_decode,
                     cache_update, dtype_of, flash_attention, rms_norm,
                     stack_defs, swiglu, tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                 # "attn" | "mla" | "xattn" | "mamba" | "rwkv"
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


def _blocks(cfg: ArchConfig, P: int) -> int:
    if cfg.num_layers % P:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                         f"whole blocks of {P}")
    return cfg.num_layers // P


def decoder_stages(cfg: ArchConfig) -> tuple[Stage, ...]:
    """The stage structure of the decoder (the decoder side of encdec)."""
    f = cfg.family
    if f == "dense":
        return (Stage((LayerSpec("attn"),), cfg.num_layers),)
    if f == "ssm":
        return (Stage((LayerSpec("rwkv", ffn="channelmix"),),
                      cfg.num_layers),)
    if f == "hybrid":
        # attn:mamba 1:7 interleave, attention in the middle of the block;
        # MoE on every `cfg.moe.every`-th layer
        P, every = cfg.attn_every, cfg.moe.every
        pat = tuple(LayerSpec("attn" if j == P // 2 else "mamba",
                              ffn="moe" if j % every == every - 1
                              else "dense") for j in range(P))
        return (Stage(pat, _blocks(cfg, P)),)
    if f == "vlm":
        E = cfg.cross_attn_every
        pat = (LayerSpec("attn"),) * (E - 1) + (LayerSpec("xattn"),)
        return (Stage(pat, _blocks(cfg, E)),)
    if f == "encdec":
        return (Stage((LayerSpec("attn", cross=True),), cfg.num_layers),)
    if f != "moe":
        raise ValueError(f"unknown family {f!r}")
    m = cfg.moe
    attn = "mla" if cfg.mla is not None else "attn"
    stages = []
    if m.first_dense:
        stages.append(Stage((LayerSpec(attn, ffn="dense"),), m.first_dense))
    stages.append(Stage((LayerSpec(attn, ffn="moe"),),
                        cfg.num_layers - m.first_dense))
    return tuple(stages)


def encoder_stages(cfg: ArchConfig) -> tuple[Stage, ...]:
    """The encoder of the encdec family: non-causal self-attention."""
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name} ({cfg.family}) has no encoder")
    return (Stage((LayerSpec("attn", causal=False),), cfg.enc_layers),)


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


def xattn_param_defs(cfg: ArchConfig) -> dict[str, Any]:
    defs = gqa_param_defs(cfg)
    if cfg.family == "vlm":
        # tanh-gated cross-attention; cast to the activations' dtype at use
        defs["gate"] = PDef((), (), "zeros")
    return defs


def mla_param_defs(cfg: ArchConfig) -> dict[str, Any]:
    m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    qd = m.nope_dim + m.rope_dim
    return {
        "w_dq": PDef((d, m.q_lora_rank), ("fsdp", None), "scaled"),
        # read in float32 (rms_norm)
        "q_norm": PDef((m.q_lora_rank,), (None,), "ones", read_f32=True),
        "w_uq": PDef((m.q_lora_rank, H, qd), (None, "heads", None),
                     "scaled"),
        "w_dkv": PDef((d, m.kv_lora_rank + m.rope_dim), ("fsdp", None),
                      "scaled"),
        "kv_norm": PDef((m.kv_lora_rank,), (None,), "ones", read_f32=True),
        "w_uk": PDef((m.kv_lora_rank, H, m.nope_dim), (None, "heads", None),
                     "scaled"),
        "w_uv": PDef((m.kv_lora_rank, H, m.v_head_dim),
                     (None, "heads", None), "scaled"),
        "wo": PDef((H, m.v_head_dim, d), ("heads", None, "fsdp"), "scaled"),
    }


def dense_ffn_param_defs(cfg: ArchConfig) -> dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": PDef((d, f), ("fsdp", "tp"), "scaled"),
        "w_up": PDef((d, f), ("fsdp", "tp"), "scaled"),
        "w_down": PDef((f, d), ("tp", "fsdp"), "scaled"),
    }


_MIXERS = {"attn": gqa_param_defs, "xattn": xattn_param_defs,
           "mla": mla_param_defs, "rwkv": _rwkv.rwkv_time_param_defs,
           "mamba": _mamba.mamba_param_defs}
_FFNS = {"dense": dense_ffn_param_defs, "moe": _moe.moe_param_defs,
         "channelmix": _rwkv.rwkv_channel_param_defs}


def layer_param_defs(cfg: ArchConfig, spec: LayerSpec) -> dict[str, Any]:
    if spec.kind not in _MIXERS or spec.ffn not in _FFNS:
        raise ValueError(f"unknown layer {spec}")
    d = cfg.d_model
    # the norm gains are read in float32 (rms_norm)
    defs = {"norm_attn": PDef((d,), (None,), "ones", read_f32=True),
            "attn": _MIXERS[spec.kind](cfg)}
    if spec.cross:
        defs["norm_cross"] = PDef((d,), (None,), "ones", read_f32=True)
        defs["cross"] = xattn_param_defs(cfg)
    defs["norm_ffn"] = PDef((d,), (None,), "ones", read_f32=True)
    defs["ffn"] = _FFNS[spec.ffn](cfg)
    return defs


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


def _out(o, wo, dtype):
    """einsum("bshe,hed->bsd", o, wo) as one matmul."""
    wo = wo.to(dtype)
    return o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


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
    return _out(o, p["wo"], x.dtype), new_cache


def xattn_apply(cfg: ArchConfig, p, x, ctx, cache, spec: LayerSpec):
    """Cross-attention to ``ctx["src"]`` (image / encoder tokens), no
    RoPE.  Prefill projects K and V from the source and runs non-causal
    flash attention; decode reads the static cache at position S_src - 1
    (``ctx["src_pos_b"]``).  With a ``gate`` leaf (vlm) the output is
    scaled by tanh(gate).  Returns (out, new_cache)."""
    mode = ctx["mode"]
    q = _proj(x, p["wq"])
    if mode == "decode":
        o = attention_decode(q, cache["k"], cache["v"], ctx["src_pos_b"])
        new_cache = cache                       # static across decode
    else:
        src = ctx["src"].to(x.dtype)
        k, v = _proj(src, p["wk"]), _proj(src, p["wv"])
        o = flash_attention(q, k, v, causal=False, chunk_q=cfg.attn_chunk,
                            chunk_k=cfg.attn_chunk)
        dt = dtype_of(cfg.compute_dtype)
        new_cache = ({"k": k.to(dt), "v": v.to(dt)} if mode == "prefill"
                     else None)
    out = _out(o, p["wo"], x.dtype)
    if "gate" in p:
        out = torch.tanh(p["gate"].to(out.dtype)) * out
    return out, new_cache


def _mla_q(cfg: ArchConfig, p, x, sin, cos):
    m = cfg.mla
    cq = x @ p["w_dq"].to(x.dtype)
    cq = rms_norm(cq, p["q_norm"], cfg.norm_eps)
    q = _proj(cq, p["w_uq"])
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    return q_nope, apply_rope(q_rope, sin, cos)


def mla_apply(cfg: ArchConfig, p, x, ctx, cache, spec: LayerSpec):
    """Multi-head Latent Attention (deepseek-v3).

    Prefill expands the latent to per-head K (nope + rope) and V and runs
    flash attention (head dims nope + rope and v_head_dim).  Decode is
    the reference's absorbed form: q_nope . W_uk gives a query in the
    kv_lora latent space, scored in float32 against the cached latent
    c_kv [B, S, kv_lora] plus q_rope against the cached k_rope [B, S,
    rope], scaled by 1/sqrt(nope + rope), positions > pos masked, softmax,
    P . c_kv in float32, then . W_uv.  The caches are updated in place.
    Returns (out, new_cache)."""
    m = cfg.mla
    mode = ctx["mode"]
    sin, cos = ctx["rope"]
    q_nope, q_rope = _mla_q(cfg, p, x, sin, cos)
    ckv_full = x @ p["w_dkv"].to(x.dtype)
    c_kv = rms_norm(ckv_full[..., :m.kv_lora_rank], p["kv_norm"],
                    cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., None, m.kv_lora_rank:], sin, cos)
    if mode == "decode":
        pos = ctx["pos"]
        c_cache = cache_update(cache["c_kv"], c_kv, pos)
        r_cache = cache_update(cache["k_rope"], k_rope[:, :, 0], pos)
        # absorbed scores:  q_lat = q_nope . W_uk
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope,
                             p["w_uk"].to(x.dtype))
        s = torch.einsum("bshr,bkr->bhsk", q_lat.float(), c_cache.float())
        s = s + torch.einsum("bshr,bkr->bhsk", q_rope.float(),
                             r_cache.float())
        s = s * (1.0 / math.sqrt(m.nope_dim + m.rope_dim))
        valid = torch.arange(c_cache.shape[1], device=x.device) <= pos
        s = torch.where(valid, s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhsk,bkr->bshr", pr, c_cache.float())
        o = torch.einsum("bshr,rhv->bshv", o_lat.to(x.dtype),
                         p["w_uv"].to(x.dtype))
        new_cache = {"c_kv": c_cache, "k_rope": r_cache}
    else:
        k_nope, v = _proj(c_kv, p["w_uk"]), _proj(c_kv, p["w_uv"])
        k_rope_b = k_rope.expand(*k_rope.shape[:2], cfg.num_heads,
                                 m.rope_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope_b], dim=-1)
        o = flash_attention(q, k, v, causal=spec.causal,
                            chunk_q=cfg.attn_chunk, chunk_k=cfg.attn_chunk)
        dt = dtype_of(cfg.compute_dtype)
        new_cache = ({"c_kv": c_kv.to(dt), "k_rope": k_rope[:, :, 0].to(dt)}
                     if mode == "prefill" else None)
    return _out(o, p["wo"], x.dtype), new_cache


_ATTENTION = {"attn": gqa_apply, "xattn": xattn_apply, "mla": mla_apply}


def _store(cache: dict, new: dict) -> dict:
    """Copy a decode step's new state into ``cache`` in place."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def apply_layer(cfg: ArchConfig, spec: LayerSpec, p, x, ctx, cache):
    """One layer: its mixer (attention of any kind, Mamba or RWKV time
    mix), the cross-attention sublayer where ``spec.cross``, and its FFN
    (dense, MoE or RWKV channel mix).  Returns (x, new_cache_or_None);
    decode updates ``cache`` in place.  In train mode a MoE layer's
    cache holds its router's auxiliary loss under ``"aux"``."""
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
        o, c = _ATTENTION[spec.kind](cfg, p["attn"], h, ctx,
                                     cache.get("attn"), spec)
    x = x + o
    new_cache = {"attn": c}
    if spec.cross:
        h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
        o, new_cache["cross"] = xattn_apply(cfg, p["cross"], h, ctx,
                                            cache.get("cross"), spec)
        x = x + o
    h = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    f = p["ffn"]
    if spec.ffn == "moe":
        y, aux = _moe.moe_ffn(h, f, cfg, with_aux=mode == "train")
        x = x + y
        if mode == "train":
            new_cache["aux"] = aux
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


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep matmul outputs, recompute the rest (the
    reference's ``jax.checkpoint_policies.checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ArchConfig):
    """``fn`` under the config's remat policy (the reference's ``_remat``):
    ``"none"`` keeps every activation for the backward; ``"full"`` keeps
    only the layer's inputs (``torch.utils.checkpoint``, the body runs
    again in the backward); ``"dots"`` keeps the matmul outputs too.
    Remat changes what is kept, never a value."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _unstack(sparams, repeats: int) -> list:
    """The stage's layers as ``repeats`` trees, taken out of the stacked
    leaves with one ``unbind`` a leaf: under autograd the backward stacks
    each leaf's gradients once, where indexing ``a[r]`` would add each
    layer's into a zero tensor the size of the whole stack."""
    parts = [a.unbind(0) for a in tree_leaves(sparams)]
    out = []
    for r in range(repeats):
        it = iter(p[r] for p in parts)
        out.append(tree_map(lambda _: next(it), sparams))
    return out


def _train_block(cfg: ArchConfig, stage: Stage, ctx, x, p_r):
    """One repeat of a stage's pattern in train mode: (x, summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, spec in enumerate(stage.pattern):
        x, c = apply_layer(cfg, spec, p_r[f"l{j}"], x, ctx, None)
        if "aux" in c:
            aux = aux + c["aux"]
    return x, aux


def run_stage(cfg: ArchConfig, stage: Stage, sparams, x, ctx, scache):
    """The stage body over its repeat dimension, layer by layer.  Returns
    (x, caches, aux): prefill the stacked caches, decode the (updated)
    ``scache``, train none; aux, the summed router loss, is a float32
    zero outside train mode and for stages without MoE."""
    mode = ctx["mode"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        body = functools.partial(_train_block, cfg, stage, ctx)
        if torch.is_grad_enabled():       # nothing to keep without autograd
            body = _remat(body, cfg)
        for p_r in _unstack(sparams, stage.repeats):
            x, a = body(x, p_r)
            aux = aux + a
        return x, None, aux
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
        return x, scache, aux
    return x, _stack(caches), aux


def run_stages(cfg: ArchConfig, stages, params, x, ctx, caches=None):
    """params/caches: tuple (one entry per stage).  Returns (x, caches,
    aux)."""
    new_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, stage in enumerate(stages):
        sc = caches[si] if caches is not None else None
        x, nc, a = run_stage(cfg, stage, params[si], x, ctx, sc)
        new_caches.append(nc)
        aux = aux + a
    return x, tuple(new_caches), aux


# --------------------------------------------------------------------------
# Caches (mirror run_stage's tree: tuple of stage dicts)
# --------------------------------------------------------------------------


def _layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, seq: int,
                 src_len: int) -> dict:
    """One layer's cache on the ``meta`` device (shapes and dtypes only):
    self-attention KV [batch, seq, Kh, Dh], cross-attention KV [batch,
    src_len, Kh, Dh] (an xattn layer's ``attn``, a cross sublayer's
    ``cross``), the MLA latent c_kv [batch, seq, kv_lora] and k_rope
    [batch, seq, rope], all in the compute dtype; the RWKV state
    (time-mix S float32 [batch, H, N, N] and x_prev, channel-mix x_prev
    [batch, 1, d], in the compute dtype) or the Mamba state (h float32
    [batch, d_in, N], conv [batch, K-1, d_in] in the compute dtype)."""
    dt = dtype_of(cfg.compute_dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device="meta")

    def kv(rows):
        return {name: zeros(batch, rows, cfg.num_kv_heads, cfg.head_dim)
                for name in ("k", "v")}

    out: dict[str, Any] = {}
    if spec.kind == "attn":
        out["attn"] = kv(seq)
    elif spec.kind == "xattn":
        out["attn"] = kv(src_len)
    elif spec.kind == "mla":
        m = cfg.mla
        out["attn"] = {"c_kv": zeros(batch, seq, m.kv_lora_rank),
                       "k_rope": zeros(batch, seq, m.rope_dim)}
    elif spec.kind == "mamba":
        out["attn"] = _mamba.init_mamba_state(cfg, batch, dt, device="meta")
    else:
        out["attn"] = _rwkv.init_rwkv_time_state(cfg, batch, dt,
                                                 device="meta")
    if spec.cross:
        out["cross"] = kv(src_len)
    if spec.ffn == "channelmix":
        out["ffn"] = {"x_prev": zeros(batch, 1, cfg.d_model)}
    return out


def cache_template(cfg: ArchConfig, stages, batch: int, seq: int,
                   src_len: int, *, device) -> tuple:
    """Zero caches, each layer's leaves stacked over the stage's repeats
    on axis 0; ``device="meta"`` gives shapes and dtypes without
    memory."""
    return tuple(
        {f"l{j}": tree_map(lambda t: torch.zeros(
            (stage.repeats,) + t.shape, dtype=t.dtype, device=device),
            _layer_cache(cfg, spec, batch, seq, src_len))
         for j, spec in enumerate(stage.pattern)}
        for stage in stages)
