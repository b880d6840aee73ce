"""Model facade: embeddings, stages, head, prefill/decode entry points.

The counterpart of ``repro/models/model.py`` for the dense, MoE, ssm
(RWKV6) and hybrid (Mamba / attention, jamba) families:

  ``prefill(params, {"tokens": [B, S]})``    -> (last logits, caches)
  ``decode_step(params, caches, tok, pos)``  -> (logits, caches)

Logits are cut to ``vocab_size`` from the padded head, as in the
reference; neither entry point computes the MoE router's auxiliary loss,
which only training reads.  Parameters are a tree of tensors with the
reference's names,
shapes and layouts (``convert.params_from_jax`` carries a reference tree
across unchanged); decode updates the caches in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .config import ArchConfig
from .layers import (PDef, dtype_of, init_params, rms_norm, rope_angles,
                     tree_leaves)
from . import moe as _moe
from . import transformer as T


def _vocab_padded(cfg: ArchConfig) -> int:
    return (cfg.vocab_size + 255) // 256 * 256


def param_defs(cfg: ArchConfig) -> dict[str, Any]:
    d, Vp = cfg.d_model, _vocab_padded(cfg)
    stages = T.decoder_stages(cfg)
    return {
        "embed": PDef((Vp, d), ("vocab", "fsdp"), "normal"),
        "stages": tuple(T.stage_param_defs(cfg, s) for s in stages),
        "final_norm": PDef((d,), (None,), "ones", read_f32=True),
        "head": PDef((d, Vp), ("fsdp", "vocab"), "scaled"),
    }


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
    held = _moe.experts_held(m)       # a one-card share holds fewer
    inactive = n_moe * (held - min(m.top_k, held)) * 3 * cfg.d_model * \
        m.d_ff_expert
    return total - inactive


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------


def _make_ctx(cfg: ArchConfig, mode: str, positions, pos=None, batch=1):
    sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    ctx = {"mode": mode, "rope": (sin, cos), "pos": pos}
    if mode == "decode":
        # the decode kernel's per-sequence position, made once per step
        ctx["pos_b"] = torch.full((batch,), pos, dtype=torch.int32,
                                  device=positions.device)
    return ctx


def _embed(cfg: ArchConfig, params, tokens):
    return params["embed"][tokens].to(dtype_of(cfg.compute_dtype))


def _backbone(cfg: ArchConfig, params, tokens, mode, *, caches=None,
              pos=None):
    dev = tokens.device
    if mode != "decode":
        positions = torch.arange(tokens.shape[1], device=dev)
    else:
        pos = int(pos)
        positions = torch.tensor([pos], device=dev)
    ctx = _make_ctx(cfg, mode, positions, pos, tokens.shape[0])
    x = _embed(cfg, params, tokens)
    x, new_caches = T.run_stages(cfg, T.decoder_stages(cfg),
                                 params["stages"], x, ctx, caches)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_caches


def _logits(cfg: ArchConfig, params, x):
    logits = x[:, -1] @ params["head"].to(x.dtype)
    return logits[:, :cfg.vocab_size]


def prefill(cfg: ArchConfig, params, batch):
    """Full-sequence forward returning (last-token logits, caches)."""
    x, caches = _backbone(cfg, params, batch["tokens"], "prefill")
    return _logits(cfg, params, x), caches


def decode_step(cfg: ArchConfig, params, caches, tokens, pos):
    """One-token step: tokens [B, 1], pos an int.  ``caches`` is updated
    in place and returned."""
    x, caches = _backbone(cfg, params, tokens, "decode", caches=caches,
                          pos=pos)
    return _logits(cfg, params, x), caches


def init_cache(cfg: ArchConfig, batch: int, seq: int, *, device="cuda"):
    """Zero caches (KV, RWKV or Mamba state) on ``device`` (the card unless
    the caller asks for the CPU or ``"meta"``)."""
    return T.cache_template(cfg, T.decoder_stages(cfg), batch, seq,
                            device=device)


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

    def prefill(self, params, batch):
        return prefill(self.cfg, params, batch)

    def decode_step(self, params, caches, tokens, pos):
        return decode_step(self.cfg, params, caches, tokens, pos)

    def num_params(self) -> int:
        return num_params(self.cfg)

    def active_params(self) -> int:
        return active_param_count(self.cfg)
