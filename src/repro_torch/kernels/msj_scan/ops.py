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

The grid cores (``engines.register_grid``) take a whole grid of cells:
the plans of :mod:`repro_torch.core.sim_batch` stack them to [G, R, ...]
with per-lane sizes, the core flattens (cells, reps) to L = G R lanes,
makes one wrapper call — one kernel launch on the card — and extracts
each cell (the reference's ``_*_grid_jax`` cores).

The stream cores (``engines.register_stream``) run FCFS, ModBS-π and BS-π
over a chunk source through the drivers of :mod:`repro_torch.core.stream`,
one carried kernel launch (``*_stream_fwd``) per chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import engines
from ...core import failures as flr
from ...core.sim_batch import (_bs_fail_args, _bs_fail_grid_plan,
                               _bs_grid_extract, _bs_grid_plan, _bs_result,
                               _class_inputs, _fcfs_fail_grid_extract,
                               _fcfs_fail_grid_plan, _fcfs_grid_extract,
                               _fcfs_grid_plan, _fcfs_inputs, _fcfs_result,
                               _merged_class_inputs, _merged_fcfs_inputs,
                               _merged_tensors, _modbs_fail_grid_extract,
                               _modbs_fail_grid_plan, _modbs_grid_extract,
                               _modbs_grid_plan, _modbs_result,
                               _partition_args, _srpt_grid_extract,
                               _srpt_grid_plan, _srpt_no_failures, _srpt_nu,
                               _srpt_result, _unmerge, _with_drain_obs)
from ...core.sim_torch import _bs_args, _modbs_init, _srpt_args
from ...core.stream import (BS_BACKLOG_CAP, _bs_device_scan,
                            _bs_stream_args, _bs_stream_drive, _scan_stream,
                            _stream_partition)
from .kernel import (bs_fail_scan_fwd, bs_scan_fwd, bs_stream_fwd,
                     fcfs_fail_scan_fwd, fcfs_scan_fwd, fcfs_stream_fwd,
                     modbs_fail_scan_fwd, modbs_scan_fwd, modbs_stream_fwd,
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


# -- grid cores: (cells, reps) flattened to one lane axis, one launch -------


_F64, _I32 = torch.float64, torch.int32


def _upload(plan: dict, L: int, device):
    """``up(key, dtype)``: the plan's [G, R, ...] array ``key`` as an
    [L, ...] tensor on ``device``."""
    def up(key, dtype=_F64):
        x = plan[key]
        return torch.as_tensor(
            np.ascontiguousarray(x.reshape(L, *x.shape[2:])), dtype=dtype,
            device=device)
    return up


def _grid_shape(cells):
    """(G, R, L) of a grid, whose failure cells must all be drain-mode."""
    if cells[0].failures is not None:
        for c in cells:
            flr.require_drain(c.failures, "torch")
    G, R = len(cells), cells[0].batch.reps
    return G, R, G * R


def _merged_lanes(up) -> tuple:
    """(t, cls, need, svc, t_up, is_fail) lanes of a padded ModBS merged
    plan."""
    return (up("t"), up("cls", _I32), up("need", _I32), up("svc"),
            up("t_up"), up("isf", torch.bool))


@engines.register_grid("fcfs", "torch")
def _fcfs_grid_torch(cells, *, device):
    G, R, L = _grid_shape(cells)
    if cells[0].failures is not None:
        p = _fcfs_fail_grid_plan(cells)
        up = _upload(p, L, device)
        (starts,) = _host(fcfs_fail_scan_fwd(
            up("t"), up("need", _I32), up("svc"), up("t_up"),
            up("isf", torch.bool), k=p["k_pad"], k_lane=up("k_lane", _I32)))
        return _fcfs_fail_grid_extract(cells, p["mss"],
                                       starts.reshape(G, R, -1))
    p = _fcfs_grid_plan(cells)
    up = _upload(p, L, device)
    (starts,) = _host(fcfs_scan_fwd(
        up("arrival"), up("need", _I32), up("service"), k=p["k_pad"],
        k_lane=up("k_lane", _I32)))
    return _fcfs_grid_extract(cells, starts.reshape(G, R, -1))


@engines.register_grid("modbs-fcfs", "torch")
def _modbs_grid_torch(cells, *, device):
    G, R, L = _grid_shape(cells)
    if cells[0].failures is not None:
        p = _modbs_fail_grid_plan(cells)
        up = _upload(p, L, device)
        blocked, starts = _host(*modbs_fail_scan_fwd(
            *_merged_lanes(up), up("slots", _I32), s_max=p["s_max_pad"],
            h=p["h_pad"], h_lane=up("h_lane", _I32)))
        return _modbs_fail_grid_extract(cells, p["mss"],
                                        blocked.reshape(G, R, -1),
                                        starts.reshape(G, R, -1))
    p = _modbs_grid_plan(cells)
    up = _upload(p, L, device)
    blocked, starts = _host(*modbs_scan_fwd(
        up("arrival"), up("cls", _I32), up("need", _I32), up("service"),
        up("slots", _I32), s_max=p["s_max_pad"], h=p["h_pad"],
        h_lane=up("h_lane", _I32)))
    return _modbs_grid_extract(cells, blocked.reshape(G, R, -1),
                               starts.reshape(G, R, -1))


@engines.register_grid("bs-fcfs", "torch")
def _bs_grid_torch(cells, *, device):
    G, R, L = _grid_shape(cells)
    drain = cells[0].failures is not None
    p = _bs_fail_grid_plan(cells) if drain else _bs_grid_plan(cells)
    up = _upload(p, L, device)
    trace = (up("arrival"), up("cls", _I32), up("need", _I32),
             up("service"))
    kw = dict(s_max=p["s_max_pad"], h=p["h_pad"], q_cap=p["q_cap_pad"],
              h_lane=up("h_lane", _I32), j_live=up("j_live", _I32))
    if drain:
        out = bs_fail_scan_fwd(*trace, up("ft"), up("ftgt", _I32),
                               up("fup"), up("slots", _I32),
                               length=p["length"], **kw)
    else:
        out = bs_scan_fwd(*trace, up("slots", _I32), **kw)
    tagged, rec_t, ovf = _host(*out)
    return _bs_grid_extract(cells, p, tagged.reshape(G, R, -1),
                            rec_t.reshape(G, R, -1), ovf.reshape(G, R))


def _srpt_grid_torch(sf: bool, cells, *, device):
    _srpt_no_failures(cells[0].failures, "sf-srpt" if sf else "ff-srpt")
    G, R, L = _grid_shape(cells)
    p = _srpt_grid_plan(cells)
    up = _upload(p, L, device)
    out = _host(*srpt_scan_fwd(
        up("arrival"), up("need"), up("service"), up("kk"), Q=p["Q_pad"],
        NU=p["NU"], sf=sf, j_live=up("j_live", _I32)))
    return _srpt_grid_extract(cells, p, *(x.reshape(G, R, *x.shape[1:])
                                          for x in out))


@engines.register_grid("sf-srpt", "torch")
def _sf_srpt_grid_torch(cells, *, device):
    return _srpt_grid_torch(True, cells, device=device)


@engines.register_grid("ff-srpt", "torch")
def _ff_srpt_grid_torch(cells, *, device):
    return _srpt_grid_torch(False, cells, device=device)


# -- stream cores: one carried launch per chunk --------------------------------


def _carry_on(device):
    """``to_device(arrays)``: a restored carry back on ``device``."""
    return lambda arrays: tuple(torch.as_tensor(a, device=device)
                                for a in arrays)


@engines.register_stream("fcfs", "torch")
def _fcfs_stream_torch(source, *, device, chunk_jobs, total_jobs,
                       partition=None, wl=None, policy="fcfs", block=4096,
                       ckpt_dir=None, resume=False):
    """Streaming FCFS: the Kiefer–Wolfowitz carry (W, t_prev) stays on
    the device across chunks."""
    k = int(source.k)

    def init(R):
        return (torch.zeros(R, k, dtype=_F64, device=device),
                torch.zeros(R, dtype=_F64, device=device))

    def chunk(carry, batch):
        starts, W, t_prev = fcfs_stream_fwd(*_fcfs_inputs(batch, device),
                                            *carry)
        (starts,) = _host(starts)
        return ((W, t_prev), starts + batch.service - batch.arrival,
                starts - batch.arrival, None, None)

    return _scan_stream(
        source, policy=policy, chunk_jobs=chunk_jobs, total_jobs=total_jobs,
        n_carry=2, init_fn=init, chunk_fn=chunk, to_device=_carry_on(device),
        has_helper=False, block=block, ckpt_dir=ckpt_dir, resume=resume)


@engines.register_stream("modbs-fcfs", "torch")
def _modbs_stream_torch(source, *, device, chunk_jobs, total_jobs,
                        partition=None, wl=None, policy="modbs-fcfs",
                        block=4096, ckpt_dir=None, resume=False):
    """Streaming ModifiedBS-FCFS: (comp, W, t_prev) stays on the device
    across chunks."""
    part = _stream_partition(partition, wl)
    slots = np.asarray(part.slots, np.int32)
    s_max = int(slots.max())
    h = int(part.helpers)
    sl = torch.tensor(slots, device=device)

    def chunk(carry, batch):
        if h < int(batch.need.max()):
            raise ValueError("helper set smaller than the largest server "
                             "need")
        blocked, starts, *carry = modbs_stream_fwd(
            *_class_inputs(batch, device), *carry)
        blocked, starts = _host(blocked, starts)
        return (tuple(carry), starts + batch.service - batch.arrival,
                starts - batch.arrival, blocked, blocked)

    return _scan_stream(
        source, policy=policy, chunk_jobs=chunk_jobs, total_jobs=total_jobs,
        n_carry=3, init_fn=lambda R: _modbs_init(sl, s_max, h, R),
        chunk_fn=chunk, to_device=_carry_on(device), has_helper=True,
        part=part, block=block, ckpt_dir=ckpt_dir, resume=resume,
        layout_extra={"C": int(slots.shape[0]), "s_max": s_max, "h": h})


@engines.register_stream("bs-fcfs", "torch")
def _bs_stream_torch(source, *, device, chunk_jobs, total_jobs,
                     partition=None, wl=None, policy="bs-fcfs",
                     queue_cap=None, backlog_cap=BS_BACKLOG_CAP, block=4096,
                     ckpt_dir=None, resume=False):
    """Streaming BS-FCFS (Definition 1) through the bounded-backlog driver.

    ``backlog_cap`` bounds how many still-queued jobs may cross a chunk
    boundary (more raises: raise the cap, or the workload is unstable);
    ``queue_cap`` defaults to ``backlog_cap + chunk_jobs``, which the
    queue within a chunk can never exceed.
    """
    part, slots, s_max, h, q_cap, B = _bs_stream_args(
        partition, wl, chunk_jobs, queue_cap, backlog_cap)
    on_device = _bs_device_scan(bs_stream_fwd, device, slots, s_max, h,
                                q_cap)

    def scan(carry, rec, horizon, length):
        out, tagged, rec_t = on_device(carry, rec, horizon, length)
        return list(_host(*out)), *_host(tagged, rec_t)

    return _bs_stream_drive(
        source, policy=policy, chunk_jobs=chunk_jobs, total_jobs=total_jobs,
        part=part, slots=slots, s_max=s_max, h=h, q_cap=q_cap, B=B,
        scan_fn=scan, block=block, ckpt_dir=ckpt_dir, resume=resume)
