"""seamless-m4t-large-v2 [audio] — enc-dec backbone.  [arXiv:2308.11596; hf]

The speech frontend is a STUB: ``input_specs`` feeds precomputed frame
embeddings [B, seq, d_model] to a 24-layer non-causal encoder; the 24-layer
decoder self-attends causally and cross-attends to the encoder output.
Full attention -> long_500k skipped.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    enc_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    rope_theta=10_000.0,
)
