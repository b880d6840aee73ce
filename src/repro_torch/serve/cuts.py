"""The served cuts: configs of the models too large for one H100, cut in
depth (and in experts held) so that one card serves them.

Every width of a cut stays as its config publishes it; only the depth is
cut (the layers left out would be further pipeline stages), and for
jamba the experts one card of an expert-parallel deployment holds.  The
configs themselves are unchanged: a cut is a ``dataclasses.replace`` of
one.  ``chip_smoke.py`` serves all three; ``launch/serve.py`` serves
deepseek-v3 as ``mla_cut(cfg, moe_layers=1)`` on the card.
"""

from __future__ import annotations

import dataclasses


def hybrid_cut(cfg):
    """The served cut of jamba-1.5-large (configs/jamba_1_5_large_398b.py:
    72 layers = 9 blocks of 8, 16 experts top-2; 398.6 B params, 797 GB in
    bf16, which no single H100 holds).  Every width stays as published (d
    8192, d_inner 16384, d_state 16, d_conv 4, dt_rank 512, 64 heads / 8
    KV heads of 128, d_ff and d_ff_expert 24576, a router with 16 outputs,
    top-2, capacity factor 1.25, the 65 536 vocabulary); the depth is one
    whole block of 8 layers (repeats 9 -> 1: the other blocks would be
    further pipeline stages), and the card holds experts 0..7 of each MoE
    layer (rank 0 of a 2-way expert-parallel deployment: 9 stages x 2
    cards = 18 H100s), routing and capacity still over all 16."""
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-block0-ep0of2", num_layers=cfg.attn_every,
        moe=dataclasses.replace(cfg.moe,
                                experts_held=cfg.moe.num_experts // 2))


def vlm_cut(cfg):
    """The served cut of llama-3.2-vision-90b (configs/
    llama_3_2_vision_90b.py: 100 layers = 20 blocks of 4 self-attention
    layers and one tanh-gated cross-attention layer; 87.7 B params, 175 GB
    in bf16, which no single H100 holds).  Every width stays as published
    (d 8192, 64 heads / 8 KV heads of 128, d_ff 28672, 1024 image tokens,
    the 128 256 vocabulary); the depth is one whole block of
    ``cross_attn_every`` = 5 layers, 4 self and 1 cross (repeats 20 -> 1:
    the other blocks would be further pipeline stages): 6.4 B params,
    12.8 GB."""
    return dataclasses.replace(cfg, name=f"{cfg.name}-block0",
                               num_layers=cfg.cross_attn_every)


def mla_cut(cfg, moe_layers: int = 2):
    """The served cut of deepseek-v3 (configs/deepseek_v3_671b.py: 61
    layers, 3 dense then 58 MoE of 256 experts top-8 with 1 shared, and a
    multi-token-prediction layer; 682.6 B params).  Every width stays as
    published (d 7168, 128 heads, MLA q_lora 1536, kv_lora 512, rope 64,
    nope 128, v 128; 256 experts top-8 of d_ff 2048, all 256 held, 1
    shared, capacity factor 1.25; dense d_ff 18432; the 129 280
    vocabulary); the depth is the 3 dense layers and ``moe_layers`` MoE
    layers (the others would be further pipeline stages), and ``mtp`` is
    off: the MTP layer is a training head that neither prefill nor decode
    reads.  2 MoE layers (``chip_smoke``'s ``[serve-mla]``): 26.6 B
    params, 53.2 GB in bf16; 1 (the serving driver's ``deepseek-32k``
    class beside starcoder2-7b and yi-9b): 15.1 B params, 30.2 GB."""
    n = cfg.moe.first_dense + moe_layers
    return dataclasses.replace(cfg, name=f"{cfg.name}-{n}layer",
                               num_layers=n, mtp=False)
