"""Mamba-1 selective scan: the CUDA kernel's two entries (the reference
kernel's pre-discretised form and the model's fused form with the state
in and out) and their plain versions."""

from .kernel import (mamba_scan_fused, mamba_scan_fused_ref, mamba_scan_fwd,
                     mamba_scan_ref)

__all__ = ["mamba_scan_fused", "mamba_scan_fused_ref", "mamba_scan_fwd",
           "mamba_scan_ref"]
