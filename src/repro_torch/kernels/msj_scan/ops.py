"""``engine="torch"`` cores of the port's registry for FCFS, ModBS, BS-π.

Each core builds the trace tensors on the requested device, calls the
kernel wrapper (which runs the CUDA kernel on a CUDA tensor and the plain
PyTorch version on a CPU tensor) and assembles the result on the host with
the helpers of :mod:`repro_torch.core.sim_batch` — so the result is the
same on either device, and the same as the reference's engines.
"""

from __future__ import annotations

import torch

from ...core import engines
from ...core.sim_batch import (_bs_result, _class_inputs, _fcfs_inputs,
                               _fcfs_result, _modbs_result, _partition_args)
from ...core.sim_torch import _bs_args
from .kernel import bs_scan_fwd, fcfs_scan_fwd, modbs_scan_fwd


def _host(*ts):
    return tuple(t.cpu().numpy() for t in ts)


@engines.register("fcfs", "torch")
def _fcfs_torch(batch, *, device, partition=None, wl=None):
    """Multiserver-job FCFS over all replications at once."""
    (starts,) = _host(fcfs_scan_fwd(*_fcfs_inputs(batch, device),
                                    k=batch.k))
    return _fcfs_result(batch, starts)


@engines.register("modbs-fcfs", "torch")
def _modbs_torch(batch, *, device, partition=None, wl=None):
    """ModifiedBS-FCFS (Definition 2) over all replications."""
    slots, s_max, h = _partition_args(batch, partition, wl)
    sl = torch.tensor(slots, dtype=torch.int32, device=device)
    blocked, starts = _host(*modbs_scan_fwd(*_class_inputs(batch, device),
                                            sl, s_max=s_max, h=h))
    return _modbs_result(batch, blocked, starts)


@engines.register("bs-fcfs", "torch")
def _bs_torch(batch, *, device, partition=None, wl=None, queue_cap=None):
    """BS-FCFS (Definition 1) event scan over all replications."""
    slots, s_max, h, q_cap = _bs_args(batch, partition, wl, queue_cap)
    sl = torch.tensor(slots, dtype=torch.int32, device=device)
    tagged, rec_t, ovf = _host(*bs_scan_fwd(*_class_inputs(batch, device),
                                            sl, s_max=s_max, h=h,
                                            q_cap=q_cap))
    return _bs_result(batch, tagged, rec_t, ovf, q_cap)
