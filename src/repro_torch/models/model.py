"""Model facade: embeddings, stages, head, loss, prefill/decode entry points.

The counterpart of ``repro/models/model.py`` for every family:

  ``loss_fn(params, {"tokens", "labels", ...})`` -> (loss, metrics)
  ``prefill(params, {"tokens": [B, S], ...})`` -> (last logits, caches)
  ``decode_step(params, caches, tok, pos)``    -> (logits, caches)

The vlm family's prefill also takes ``"image_emb"`` [B, num_image_tokens,
d] and the encdec family's ``"frames"`` [B, S_src, d] (stub frontends, as
in the reference): the image tokens, or the encoder's output over the
frames, are the cross-attention source.  Logits are cut to
``vocab_size`` from the padded head, as in the reference.  ``loss_fn`` is
the reference's training loss: next-token cross-entropy over the padded
head (``layers.chunked_cross_entropy``), plus the MoE router's auxiliary
loss and deepseek's multi-token-prediction loss where the config has
them; the serving entry points compute neither.  Parameters are a tree
of tensors with the reference's names, shapes and layouts
(``convert.params_from_jax`` carries a reference tree across unchanged);
decode updates the caches in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import (PDef, chunked_cross_entropy, dtype_of, init_params,
                     rms_norm, rope_angles, stack_defs, tree_leaves,
                     tree_map)
from . import moe as _moe
from . import transformer as T


def _vocab_padded(cfg: ArchConfig) -> int:
    return (cfg.vocab_size + 255) // 256 * 256


def param_defs(cfg: ArchConfig) -> dict[str, Any]:
    d, Vp = cfg.d_model, _vocab_padded(cfg)
    stages = T.decoder_stages(cfg)
    defs: dict[str, Any] = {
        "embed": PDef((Vp, d), ("vocab", "fsdp"), "normal"),
        "stages": tuple(T.stage_param_defs(cfg, s) for s in stages),
        "final_norm": PDef((d,), (None,), "ones", read_f32=True),
        "head": PDef((d, Vp), ("fsdp", "vocab"), "scaled"),
    }
    if cfg.family == "encdec":
        defs["encoder"] = {
            "stages": tuple(T.stage_param_defs(cfg, s)
                            for s in T.encoder_stages(cfg)),
            "final_norm": PDef((d,), (None,), "ones", read_f32=True),
        }
    if cfg.mtp:
        spec = T.LayerSpec("mla" if cfg.mla else "attn", ffn="moe")
        defs["mtp"] = {
            "proj": PDef((2 * d, d), ("fsdp", None), "scaled"),
            "norm_h": PDef((d,), (None,), "ones", read_f32=True),
            "norm_e": PDef((d,), (None,), "ones", read_f32=True),
            "layer": stack_defs(T.layer_param_defs(cfg, spec), 1),
        }
    return defs


def num_params(cfg: ArchConfig) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(param_defs(cfg)))


def active_param_count(cfg: ArchConfig) -> int:
    """Per-token active params (= total minus inactive routed experts)."""
    total = num_params(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_moe = sum(sum(1 for spec in s.pattern if spec.ffn == "moe") * s.repeats
                for s in T.decoder_stages(cfg))
    n_moe += bool(cfg.mtp)            # the MTP layer is one more MoE layer
    held = _moe.experts_held(m)       # a one-card share holds fewer
    inactive = n_moe * (held - min(m.top_k, held)) * 3 * cfg.d_model * \
        m.d_ff_expert
    return total - inactive


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------


def _rope_dim(cfg: ArchConfig) -> int:
    return cfg.mla.rope_dim if cfg.mla is not None else cfg.head_dim


def _make_ctx(cfg: ArchConfig, mode: str, positions, pos=None, batch=1, *,
              src=None, src_len=None):
    sin, cos = rope_angles(positions, _rope_dim(cfg), cfg.rope_theta)
    ctx = {"mode": mode, "rope": (sin, cos), "src": src, "pos": pos}
    if mode == "decode":
        # the decode kernel's per-sequence positions, made once per step:
        # the token's, and S_src - 1 for cross-attention's static cache
        ctx["pos_b"] = torch.full((batch,), pos, dtype=torch.int32,
                                  device=positions.device)
        if src_len is not None:
            ctx["src_pos_b"] = torch.full((batch,), src_len - 1,
                                          dtype=torch.int32,
                                          device=positions.device)
    return ctx


def _embed(cfg: ArchConfig, params, tokens):
    """The token rows of the embedding, cast to the compute dtype.
    ``F.embedding`` rather than indexing: its backward adds the rows of
    repeated tokens in a fixed order on both devices, where indexing's
    backward on the CPU does not."""
    return F.embedding(tokens, params["embed"]).to(
        dtype_of(cfg.compute_dtype))


def _encode(cfg: ArchConfig, params, frames):
    """The encdec encoder over stub frame embeddings [B, S_src, d]: mode
    "train" (no caches), RoPE over the frames' positions, its own final
    norm."""
    enc = params["encoder"]
    ctx = _make_ctx(cfg, "train", torch.arange(frames.shape[1],
                                                device=frames.device))
    x = frames.to(dtype_of(cfg.compute_dtype))
    x, _, _ = T.run_stages(cfg, T.encoder_stages(cfg), enc["stages"], x,
                           ctx)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


# the prefill input beside the tokens that holds a family's
# cross-attention source
SOURCE_KEY = {"vlm": "image_emb", "encdec": "frames"}


def _source(cfg: ArchConfig, params, batch):
    """Cross-attention source tokens for vlm / encdec, else None."""
    if cfg.family not in SOURCE_KEY:
        return None
    src = batch[SOURCE_KEY[cfg.family]]
    return _encode(cfg, params, src) if cfg.family == "encdec" else src


def _cache_src_len(cfg: ArchConfig, caches):
    """Rows of the static cross-attention cache (the first xattn layer's
    or cross sublayer's), or None where the model has none."""
    for stage, sc in zip(T.decoder_stages(cfg), caches):
        for j, spec in enumerate(stage.pattern):
            if spec.kind == "xattn":
                return sc[f"l{j}"]["attn"]["k"].shape[2]
            if spec.cross:
                return sc[f"l{j}"]["cross"]["k"].shape[2]
    return None


def _backbone(cfg: ArchConfig, params, tokens, mode, *, src=None,
              caches=None, pos=None):
    dev = tokens.device
    src_len = None
    if mode != "decode":
        positions = torch.arange(tokens.shape[1], device=dev)
    else:
        pos = int(pos)
        positions = torch.tensor([pos], device=dev)
        src_len = _cache_src_len(cfg, caches)
    ctx = _make_ctx(cfg, mode, positions, pos, tokens.shape[0], src=src,
                    src_len=src_len)
    x = _embed(cfg, params, tokens)
    x, new_caches, aux = T.run_stages(cfg, T.decoder_stages(cfg),
                                      params["stages"], x, ctx, caches)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_caches, aux


def _logits(cfg: ArchConfig, params, x):
    logits = x[:, -1] @ params["head"].to(x.dtype)
    return logits[:, :cfg.vocab_size]


def loss_fn(cfg: ArchConfig, params, batch):
    """Next-token CE (+ MoE aux, + MTP for deepseek).  Returns (loss,
    metrics): ``nll``, ``tokens`` (an int), ``moe_aux`` and ``mtp_nll``
    where the config has them, and ``loss``, as the reference's."""
    tokens, labels = batch["tokens"], batch["labels"]
    src = _source(cfg, params, batch)
    x, _, aux = _backbone(cfg, params, tokens, "train", src=src)
    nll, n_tok = chunked_cross_entropy(
        x, params["head"], labels, num_chunks=cfg.loss_chunk,
        valid_vocab=cfg.vocab_size)
    loss = nll
    metrics = {"nll": nll, "tokens": n_tok}
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
        metrics["moe_aux"] = aux
    if cfg.mtp:
        mtp_nll = _mtp_loss(cfg, params, x, labels)
        loss = loss + 0.3 * mtp_nll
        metrics["mtp_nll"] = mtp_nll
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(cfg: ArchConfig, params, h, labels):
    """DeepSeek-v3 multi-token prediction: one extra layer predicts t+2
    from the final hidden state and token t+1's embedding; the last
    position has no label and is masked."""
    p = params["mtp"]
    emb_next = _embed(cfg, params, labels)            # token t+1 embeddings
    z = torch.cat([rms_norm(h, p["norm_h"], cfg.norm_eps),
                   rms_norm(emb_next, p["norm_e"], cfg.norm_eps)], dim=-1)
    z = z @ p["proj"].to(z.dtype)
    spec = T.LayerSpec("mla" if cfg.mla else "attn", ffn="moe")
    ctx = _make_ctx(cfg, "train", torch.arange(z.shape[1], device=z.device))
    lp = tree_map(lambda a: a[0], p["layer"])
    z, _ = T.apply_layer(cfg, spec, lp, z, ctx, None)
    mtp_labels = torch.cat([labels[:, 1:], torch.zeros_like(labels[:, :1])],
                           dim=1)
    nll, _ = chunked_cross_entropy(
        z, params["head"], mtp_labels, num_chunks=cfg.loss_chunk,
        valid_vocab=cfg.vocab_size, mask_last=True)
    return nll


def prefill(cfg: ArchConfig, params, batch):
    """Full-sequence forward returning (last-token logits, caches)."""
    src = _source(cfg, params, batch)
    x, caches, _ = _backbone(cfg, params, batch["tokens"], "prefill",
                             src=src)
    return _logits(cfg, params, x), caches


def decode_step(cfg: ArchConfig, params, caches, tokens, pos):
    """One-token step: tokens [B, 1], pos an int.  ``caches`` is updated
    in place and returned."""
    x, caches, _ = _backbone(cfg, params, tokens, "decode", caches=caches,
                             pos=pos)
    return _logits(cfg, params, x), caches


def train_inputs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """A training batch's entries as (shape, dtype): int32 tokens and
    labels [batch, seq], and the vlm's ``image_emb`` / the encdec's
    ``frames`` in the compute dtype (the reference's ``train_inputs``,
    its ``ShapeDtypeStruct`` as a pair)."""
    tok = ((batch, seq), torch.int32)
    out = {"tokens": tok, "labels": tok}
    dt = dtype_of(cfg.compute_dtype)
    if cfg.family == "vlm":
        out["image_emb"] = ((batch, cfg.num_image_tokens, cfg.d_model), dt)
    if cfg.family == "encdec":
        out["frames"] = ((batch, cfg.num_frame_tokens or seq, cfg.d_model),
                         dt)
    return out


def _src_len(cfg: ArchConfig, seq: int) -> int:
    """Rows of the cross-attention cache: the image tokens (vlm), or the
    frames, ``num_frame_tokens or seq`` (encdec; seamless sets 0, so the
    serving cache's length ``seq``), as in the reference."""
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    if cfg.family == "encdec":
        return cfg.num_frame_tokens or seq
    return 0


def init_cache(cfg: ArchConfig, batch: int, seq: int, *, device="cuda"):
    """Zero caches (KV, cross-attention KV, MLA latent, RWKV or Mamba
    state) on ``device`` (the card unless the caller asks for the CPU or
    ``"meta"``)."""
    return T.cache_template(cfg, T.decoder_stages(cfg), batch, seq,
                            _src_len(cfg, seq), device=device)


# --------------------------------------------------------------------------
# Facade
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def param_defs(self):
        return param_defs(self.cfg)

    def init(self, generator: torch.Generator, *, dtype=None):
        """Random params on the generator's device (``dtype`` overrides
        the float32 of the defs, leaf by leaf)."""
        return init_params(self.param_defs(), generator, dtype=dtype)

    def loss(self, params, batch):
        return loss_fn(self.cfg, params, batch)

    def prefill(self, params, batch):
        return prefill(self.cfg, params, batch)

    def decode_step(self, params, caches, tokens, pos):
        return decode_step(self.cfg, params, caches, tokens, pos)

    def num_params(self) -> int:
        return num_params(self.cfg)

    def active_params(self) -> int:
        return active_param_count(self.cfg)
