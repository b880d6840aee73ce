"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]  72 layers = 9 blocks of 8 (attention at block
position 4, MoE on every 2nd layer).  Sub-quadratic on 7/8 layers ->
long_500k RUNS (KV exists only for the 9 attention layers).
"""
from ..models.config import ArchConfig, MambaCfg, MoECfg

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    attn_every=8,
    moe=MoECfg(num_experts=16, top_k=2, d_ff_expert=24576, every=2),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2, chunk=128),
    rope_theta=10_000.0,
)
