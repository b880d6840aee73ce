"""Multiserver-job event-scan kernels: FCFS, ModifiedBS-π, BS-π, SF-/FF-SRPT
and the SRPT kernel's stable sort."""

from .kernel import (bs_scan_fwd, bs_scan_ref, fcfs_scan_fwd, fcfs_scan_ref,
                     launches, modbs_scan_fwd, modbs_scan_ref,
                     reset_launches, srpt_scan_fwd, srpt_scan_ref,
                     stable_sort_fwd, stable_sort_ref)

__all__ = ["bs_scan_fwd", "bs_scan_ref", "fcfs_scan_fwd", "fcfs_scan_ref",
           "launches", "modbs_scan_fwd", "modbs_scan_ref", "reset_launches",
           "srpt_scan_fwd", "srpt_scan_ref", "stable_sort_fwd",
           "stable_sort_ref"]
