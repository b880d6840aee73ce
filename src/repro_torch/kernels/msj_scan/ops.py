"""``engine="torch"`` cores of the port's registry: FCFS, ModBS, BS-π and
the preemptive SF-/FF-SRPT pair.

Each core builds the trace tensors on the requested device, calls the
kernel wrapper (which runs the CUDA kernel on a CUDA tensor and the plain
PyTorch version on a CPU tensor) and assembles the result on the host with
the helpers of :mod:`repro_torch.core.sim_batch` — so the result is the
same on either device, and the same as the reference's engines.

With ``failures=`` (drain mode) FCFS, ModBS and BS-π take the reference's
drain flow: the failure stream is merged with the arrivals on the host
(:mod:`repro_torch.core.failures`), the ``*_fail_scan`` kernel runs it,
and FCFS/ModBS outputs are gathered back to job order by
``MergedStream.job_pos``.
"""

from __future__ import annotations

import torch

from ...core import engines
from ...core import failures as flr
from ...core.sim_batch import (_bs_fail_args, _bs_result, _class_inputs,
                               _fcfs_inputs, _fcfs_result,
                               _merged_class_inputs, _merged_fcfs_inputs,
                               _merged_tensors, _modbs_result,
                               _partition_args, _srpt_no_failures, _srpt_nu,
                               _srpt_result, _unmerge, _with_drain_obs)
from ...core.sim_torch import _bs_args, _srpt_args
from .kernel import (bs_fail_scan_fwd, bs_scan_fwd, fcfs_fail_scan_fwd,
                     fcfs_scan_fwd, modbs_fail_scan_fwd, modbs_scan_fwd,
                     srpt_scan_fwd)


def _host(*ts):
    return tuple(t.cpu().numpy() for t in ts)


@engines.register("fcfs", "torch")
def _fcfs_torch(batch, *, device, partition=None, wl=None, failures=None):
    """Multiserver-job FCFS over all replications at once."""
    if failures is None:
        (starts,) = _host(fcfs_scan_fwd(*_fcfs_inputs(batch, device),
                                        k=batch.k))
        return _fcfs_result(batch, starts)
    flr.require_drain(failures, "torch")
    ms = _merged_fcfs_inputs(batch, failures)
    t, _, n, v, tu, isf = _merged_tensors(ms, device)
    (starts,) = _unmerge(ms, *_host(fcfs_fail_scan_fwd(t, n, v, tu, isf,
                                                       k=batch.k)))
    return _with_drain_obs(_fcfs_result(batch, starts), batch, failures)


@engines.register("modbs-fcfs", "torch")
def _modbs_torch(batch, *, device, partition=None, wl=None, failures=None):
    """ModifiedBS-FCFS (Definition 2) over all replications."""
    slots, s_max, h = _partition_args(batch, partition, wl)
    sl = torch.tensor(slots, dtype=torch.int32, device=device)
    if failures is None:
        blocked, starts = _host(*modbs_scan_fwd(
            *_class_inputs(batch, device), sl, s_max=s_max, h=h))
        return _modbs_result(batch, blocked, starts)
    flr.require_drain(failures, "torch")
    ms = _merged_class_inputs(batch, failures, partition, wl)
    blocked, starts = _unmerge(ms, *_host(*modbs_fail_scan_fwd(
        *_merged_tensors(ms, device), sl, s_max=s_max, h=h)))
    return _with_drain_obs(_modbs_result(batch, blocked, starts), batch,
                           failures)


@engines.register("bs-fcfs", "torch")
def _bs_torch(batch, *, device, partition=None, wl=None, queue_cap=None,
              failures=None):
    """BS-FCFS (Definition 1) event scan over all replications."""
    slots, s_max, h, q_cap = _bs_args(batch, partition, wl, queue_cap)
    sl = torch.tensor(slots, dtype=torch.int32, device=device)
    if failures is None:
        tagged, rec_t, ovf = _host(*bs_scan_fwd(
            *_class_inputs(batch, device), sl, s_max=s_max, h=h,
            q_cap=q_cap))
        return _bs_result(batch, tagged, rec_t, ovf, q_cap)
    flr.require_drain(failures, "torch")
    ft, ftgt, fup, length = _bs_fail_args(batch, failures, partition, wl)
    f64 = dict(dtype=torch.float64, device=device)
    tagged, rec_t, ovf = _host(*bs_fail_scan_fwd(
        *_class_inputs(batch, device), torch.tensor(ft, **f64),
        torch.tensor(ftgt, dtype=torch.int32, device=device),
        torch.tensor(fup, **f64), sl, s_max=s_max, h=h, q_cap=q_cap,
        length=length))
    return _with_drain_obs(_bs_result(batch, tagged, rec_t, ovf, q_cap),
                           batch, failures)


def _srpt_torch(sf: bool, batch, *, device, partition=None, wl=None,
                queue_cap=None, failures=None):
    _srpt_no_failures(failures, "sf-srpt" if sf else "ff-srpt")
    q_cap = _srpt_args(batch, queue_cap)
    NU = _srpt_nu(batch)
    f64 = dict(dtype=torch.float64, device=device)
    out = _host(*srpt_scan_fwd(
        torch.tensor(batch.arrival, **f64), torch.tensor(batch.need, **f64),
        torch.tensor(batch.service, **f64),
        torch.full((batch.reps,), float(batch.k), **f64),
        Q=q_cap, NU=NU, sf=sf))
    job_ev, t_ev, fs_ev, ovf, npre, ne, peak = out
    return _srpt_result(batch, job_ev, t_ev, fs_ev, ovf, npre, ne, q_cap,
                        peak=peak)


@engines.register("sf-srpt", "torch")
def _sf_srpt_torch(batch, **kw):
    """Preemptive ServerFilling-SRPT event scan over all replications
    (rank = remaining work x need, the prefix reaching k packed
    largest-need-first).  ``queue_cap`` bounds the slot table (default
    ``min(J, max(4k, 256))``, rounded up to a power of two); overflow
    raises.  ``failures=`` raises ``NotImplementedError``."""
    return _srpt_torch(True, batch, **kw)


@engines.register("ff-srpt", "torch")
def _ff_srpt_torch(batch, **kw):
    """Preemptive FirstFit-SRPT event scan (rank = remaining work, first
    fit over the rank order); see ``_sf_srpt_torch``."""
    return _srpt_torch(False, batch, **kw)
