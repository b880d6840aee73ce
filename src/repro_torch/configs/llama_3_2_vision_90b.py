"""llama-3.2-vision-90b [vlm] — 100L total (80 self + 20 cross-attn), GQA kv=8.

[hf:meta-llama/Llama-3.2-11B-Vision scaled per assignment; unverified]
The vision frontend is a STUB: ``input_specs`` feeds precomputed patch
embeddings [B, 1024, d_model]; every 5th layer cross-attends to them
(tanh-gated, Llama-3.2 style).  Full attention -> long_500k skipped.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    cross_attn_every=5,
    num_image_tokens=1024,
    rope_theta=500_000.0,
)
