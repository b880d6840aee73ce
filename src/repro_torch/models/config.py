"""Architecture config schema shared by all 10 assigned architectures.

The port's copy of ``repro/models/config.py``.  A single
:class:`ArchConfig` describes every family the reference supports:

* ``dense``  — decoder-only transformer, GQA + RoPE (starcoder2, stablelm,
  internlm2, yi)
* ``moe``    — decoder-only with routed experts (moonshot top-6;
  deepseek-v3 with MLA attention + shared expert + MTP head)
* ``hybrid`` — Mamba/attention interleave with MoE (jamba)
* ``ssm``    — attention-free RWKV6 (finch)
* ``encdec`` — encoder-decoder backbone (seamless-m4t)
* ``vlm``    — decoder with interleaved cross-attention layers
  (llama-3.2-vision backbone)

The port's model runs every family.  ``MoECfg`` adds
one field to the reference's, ``experts_held``, the share of an
expert-parallel layer that one card holds.  ``reduced()`` returns a tiny
same-family config for CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # deepseek: 1 shared expert
    every: int = 1               # MoE layer cadence (jamba: every 2nd)
    first_dense: int = 0         # deepseek: first 3 layers dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # the port's one-card share of an expert-parallel layer: this card
    # holds ``experts_held`` consecutive experts (0: all of them); routing
    # and capacity still count all ``num_experts`` (models/moe.py)
    experts_held: int = 0


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 -> ceil(d_model/16)
    chunk: int = 128             # scan chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # family extras
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    mamba: MambaCfg | None = None
    attn_every: int = 1          # hybrid: 1 attention layer per this many
    cross_attn_every: int = 0    # vlm: every Nth layer cross-attends
    enc_layers: int = 0          # encdec: encoder depth (num_layers = decoder)
    num_image_tokens: int = 1024 # vlm stub frontend output length
    num_frame_tokens: int = 0    # encdec stub: 0 -> equals seq_len
    mtp: bool = False            # deepseek multi-token-prediction head

    # common knobs
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "full"   # "full" | "dots" | "none" (training only)
    attn_chunk: int = 512        # flash-attention block length
    loss_chunk: int = 8          # cross-entropy computed in this many chunks

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    # -- derived -----------------------------------------------------------

    @property
    def is_decoder_only(self) -> bool:
        return self.family in ("dense", "moe", "hybrid", "ssm", "vlm")

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic families run long_500k; full-attention ones skip."""
        return self.family in ("ssm", "hybrid")

    def num_params(self) -> int:
        """Total parameter count (exact, mirrors the port's param tree)."""
        from .model import num_params
        return num_params(self)

    def active_params(self) -> int:
        """Active (per-token) params — differs for MoE."""
        from .model import active_param_count
        return active_param_count(self)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            num_layers=max(2, min(4, self.num_layers)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads // max(
                1, self.num_heads // 4))),
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            attn_chunk=64,
            loss_chunk=2,
        )
        if self.moe is not None:
            # capacity_factor 4: the smoke configs must be *dropless* so
            # prefill+decode exactly matches the full forward pass
            m = self.moe
            kw["moe"] = dataclasses.replace(
                m, num_experts=8, top_k=2, d_ff_expert=64,
                num_shared=min(1, m.num_shared),
                first_dense=min(1, m.first_dense),
                capacity_factor=4.0,
                # a share keeps its fraction of the experts
                experts_held=(max(1, m.experts_held * 8 // m.num_experts)
                              if m.experts_held else 0))
            kw["num_layers"] = 4
        if self.mla is not None:
            kw["mla"] = MLACfg(q_lora_rank=64, kv_lora_rank=32, rope_dim=16,
                               nope_dim=32, v_head_dim=32)
            kw["head_dim"] = 32
        if self.mamba is not None:
            kw["mamba"] = dataclasses.replace(self.mamba, d_state=8, chunk=16)
            kw["num_layers"] = self.attn_every  # one full interleave block
        if self.cross_attn_every:
            kw["num_layers"] = 2 * self.cross_attn_every
            kw["num_image_tokens"] = 16
        if self.enc_layers:
            kw["enc_layers"] = 2
        return dataclasses.replace(self, **kw)

