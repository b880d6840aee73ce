"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

[arXiv:2412.19437; hf]  The assigned d_ff=2048 is the routed-expert width;
the 3 leading dense layers use the model's published dense d_ff (18432).
Decode caches the 512+64-dim MLA latent (the KV saving that defines MLA).
"""
from ..models.config import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    head_dim=128,
    moe=MoECfg(num_experts=256, top_k=8, d_ff_expert=2048, num_shared=1,
               first_dense=3),
    mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512, rope_dim=64, nope_dim=128,
               v_head_dim=128),
    mtp=True,
    rope_theta=10_000.0,
)
