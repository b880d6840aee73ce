"""Flash-decoding: the CUDA kernels' wrapper and its plain version."""

from .kernel import decode_attention_fwd, decode_attention_ref

__all__ = ["decode_attention_fwd", "decode_attention_ref"]
