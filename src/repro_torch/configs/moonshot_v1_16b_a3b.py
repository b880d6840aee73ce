"""moonshot-v1-16b-a3b [moe] — 64 experts top-6, expert d_ff=1408.

[hf:moonshotai/Moonlight-16B-A3B; hf]  GQA kv=16 (MHA at 16 heads).
"""
from ..models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    head_dim=128,
    moe=MoECfg(num_experts=64, top_k=6, d_ff_expert=1408),
    rope_theta=50_000.0,
)
