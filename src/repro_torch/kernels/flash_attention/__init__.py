"""Flash-attention forward: the CUDA kernel's wrapper and its plain version."""

from .kernel import flash_attention_fwd, flash_attention_ref

__all__ = ["flash_attention_fwd", "flash_attention_ref"]
