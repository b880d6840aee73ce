"""Multiserver-job event-scan kernels: FCFS, ModifiedBS-π, BS-π."""

from .kernel import (bs_scan_fwd, bs_scan_ref, fcfs_scan_fwd, fcfs_scan_ref,
                     launches, modbs_scan_fwd, modbs_scan_ref,
                     reset_launches)

__all__ = ["bs_scan_fwd", "bs_scan_ref", "fcfs_scan_fwd", "fcfs_scan_ref",
           "launches", "modbs_scan_fwd", "modbs_scan_ref", "reset_launches"]
