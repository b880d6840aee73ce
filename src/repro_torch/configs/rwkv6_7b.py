"""rwkv6-7b "Finch" [ssm] — attention-free, data-dependent decay.

[arXiv:2404.05892; hf]  64 heads of size 64; O(1) recurrent state ->
long_500k RUNS (the state, not a KV cache, is the "cache").
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
)
