"""Grouped matmul (MoE expert products): the CUDA kernel's wrapper, its
plain version and the static-capacity layout helper."""

from .kernel import gmm, gmm_ref, pad_groups

__all__ = ["gmm", "gmm_ref", "pad_groups"]
