"""Multiserver-job event-scan kernels: FCFS, ModifiedBS-π and BS-π (each
also in drain mode, over a merged arrival+failure stream, and carried, one
chunk of a stream), SF-/FF-SRPT and the SRPT kernel's stable sort."""

from .kernel import (bs_fail_scan_fwd, bs_fail_scan_ref, bs_scan_fwd,
                     bs_scan_ref, bs_stream_fwd, bs_stream_ref,
                     fcfs_fail_scan_fwd, fcfs_fail_scan_ref, fcfs_scan_fwd,
                     fcfs_scan_ref, fcfs_stream_fwd, fcfs_stream_ref,
                     launches, modbs_fail_scan_fwd, modbs_fail_scan_ref,
                     modbs_scan_fwd, modbs_scan_ref, modbs_stream_fwd,
                     modbs_stream_ref, reset_launches, srpt_scan_fwd,
                     srpt_scan_ref, stable_sort_fwd, stable_sort_ref)

__all__ = ["bs_fail_scan_fwd", "bs_fail_scan_ref", "bs_scan_fwd",
           "bs_scan_ref", "bs_stream_fwd", "bs_stream_ref",
           "fcfs_fail_scan_fwd", "fcfs_fail_scan_ref", "fcfs_scan_fwd",
           "fcfs_scan_ref", "fcfs_stream_fwd", "fcfs_stream_ref",
           "launches", "modbs_fail_scan_fwd", "modbs_fail_scan_ref",
           "modbs_scan_fwd", "modbs_scan_ref", "modbs_stream_fwd",
           "modbs_stream_ref", "reset_launches", "srpt_scan_fwd",
           "srpt_scan_ref", "stable_sort_fwd", "stable_sort_ref"]
