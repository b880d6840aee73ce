"""Chunked RWKV6 WKV recurrence: the CUDA kernel's wrapper and its two
plain versions (the chunked form and the exact sequential recurrence)."""

from .kernel import wkv_chunked_ref, wkv_fwd, wkv_ref

__all__ = ["wkv_chunked_ref", "wkv_fwd", "wkv_ref"]
