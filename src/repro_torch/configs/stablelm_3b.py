"""stablelm-3b [dense] — MHA (kv=32).  [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    head_dim=80,
    rope_theta=10_000.0,
)
