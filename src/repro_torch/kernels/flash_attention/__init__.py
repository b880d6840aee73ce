"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions."""

from .kernel import (flash_attention_bwd, flash_attention_bwd_ref,
                     flash_attention_fwd, flash_attention_ref)

__all__ = ["flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_fwd", "flash_attention_ref"]
