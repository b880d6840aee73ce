"""Inputs of the FCFS and ModBS-π scan cases shared by ``chip_smoke.py``,
:mod:`repro_torch.bench.fm_bench` and the tests.

Each case function returns an :class:`FMCase`: the FCFS scan's inputs
(``fcfs``: arrival, need, service [R, J], or for a drain case the merged
stream t, need, svc, t_up, is_fail [R, L]; servers ``k``) and the ModBS-π
scan's (``modbs``: arrival, cls, need, service, or the merged stream with
the failure rows' target block in ``cls``; ``slots`` [C], ``s_max``,
``h``).  :func:`scan` runs the wrapper on a case (the kernel on CUDA
tensors, the plain version on CPU ones), :func:`scan_ref` the plain
version wherever the tensors are.

* :func:`fig1_case`, :func:`table_case`, :func:`drain_case` — the Fig. 1
  path at k (θ = 0.7), the Fig. 3 path (SDSC-SP2, KIT-FH2 bootstraps at
  load 0.85) and Fig. 1 under ``bs_cases.bench_failures``' outages;
* :data:`ADVERSARIAL` — traces built to reach the corners of the
  kernels' run-length state and kept row minima: arrivals and services
  on a grid of :data:`bs_cases.TIE_UNIT` (ties), zero services, jobs
  that need every server, k ∈ {1, 7, 33, 1000}, need-1 jobs whose
  distinct completions make one group a server (also in bursts of 180 at
  k = 200, so the groups outgrow the kernels' registers and come back),
  rows wider than 32 (s_max > 32),
  classes with no slots, a helper of one server, and drain rows whose
  t_up lies below W[0], between W[0] and the last start, and above it,
  with the padding rows (t = +inf, t_up = 0) at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import sim_batch, sim_torch
from ..core.workload import BatchTrace, figure1_workload
from . import bs_cases


@dataclasses.dataclass
class FMCase:
    """One case's FCFS and ModBS-π scan inputs; ``drain`` marks merged
    arrival+failure streams."""

    name: str
    fcfs: tuple             # (t, need, svc[, t_up, is_fail])
    modbs: tuple            # (t, cls, need, svc[, t_up, is_fail])
    k: int
    slots: torch.Tensor     # [C] int32
    s_max: int
    h: int
    drain: bool = False

    @property
    def R(self) -> int:
        return self.fcfs[0].shape[0]

    def steps(self, kind: str) -> int:
        """Scan steps per replication of the ``kind`` ("fcfs", "modbs")
        scan: its rows."""
        return (self.fcfs if kind == "fcfs" else self.modbs)[0].shape[1]

    def to(self, device) -> "FMCase":
        return dataclasses.replace(
            self, fcfs=tuple(t.to(device) for t in self.fcfs),
            modbs=tuple(t.to(device) for t in self.modbs),
            slots=self.slots.to(device))

    def arrays(self) -> dict:
        """Every tensor as numpy, by field, and the scalars (``fm_bench``
        saves a case so that another checkout's package, which may not
        have this module, can load it)."""
        out = {f"fcfs{i}": t.cpu().numpy() for i, t in enumerate(self.fcfs)}
        out.update({f"modbs{i}": t.cpu().numpy()
                    for i, t in enumerate(self.modbs)})
        out.update(slots=self.slots.cpu().numpy(), k=self.k, s_max=self.s_max,
                   h=self.h, drain=self.drain)
        return out


_F64, _I32 = torch.float64, torch.int32


def _tensors(t, cls, need, svc, t_up=None, is_fail=None):
    base = (torch.tensor(np.asarray(t, np.float64), dtype=_F64),
            torch.tensor(np.asarray(cls, np.int32), dtype=_I32),
            torch.tensor(np.asarray(need, np.int32), dtype=_I32),
            torch.tensor(np.asarray(svc, np.float64), dtype=_F64))
    if t_up is None:
        return base
    return base + (torch.tensor(np.asarray(t_up, np.float64), dtype=_F64),
                   torch.tensor(np.asarray(is_fail, bool)))


def _from_batch(name, b, wl, fb=None) -> FMCase:
    slots, s_max, h, _ = sim_torch._bs_args(b, None, wl, None)
    if fb is None:
        m = _tensors(b.arrival, b.cls, b.need, b.service)
        f = m
    else:
        msf = sim_batch._merged_fcfs_inputs(b, fb)
        msc = sim_batch._merged_class_inputs(b, fb, None, wl)
        f = _tensors(msf.t, msf.cls, msf.need, msf.service, msf.t_up,
                     msf.is_fail != 0)
        m = _tensors(msc.t, msc.cls, msc.need, msc.service, msc.t_up,
                     msc.is_fail != 0)
    return FMCase(name, (f[0],) + f[2:], m, b.k,
                  torch.tensor(slots, dtype=_I32), s_max, h, fb is not None)


def fig1_case(k: int, J: int, R: int, seed: int, name="fig1") -> FMCase:
    """``figure1_workload(k).sample_traces(J, R, seed)``."""
    wl = figure1_workload(k)
    return _from_batch(name, wl.sample_traces(J, R, seed=seed), wl)


def table_case(dataset: str, k: int, J: int, R: int, seed: int,
               load: float = 0.85, name=None) -> FMCase:
    """R IID bootstraps of a J-job ``dataset`` ("sdsc" or "kit") trace at
    ``load``, with that workload's partition (``fig3_traces.run``'s)."""
    trace_fn, wl_fn = bs_cases.TABLES[dataset]
    b = BatchTrace.from_trace(trace_fn(J, k=k, load=load, seed=seed), R,
                              seed=seed)
    return _from_batch(name or dataset, b, wl_fn(k=k, load=load))


def drain_case(k: int, J: int, R: int, seed: int, mix: str = "bench",
               name=None) -> FMCase:
    """A Fig. 1 trace under ``mix``'s outages (``bs_cases.FAIL_MIXES``):
    the merged streams of the FCFS and ModBS drain scans."""
    wl = figure1_workload(k)
    b = wl.sample_traces(J, R, seed=seed)
    return _from_batch(name or f"drain_{mix}", b, wl,
                       bs_cases.bench_failures(wl, b, mix, seed=seed))


def _synth(name, J, R, seed, *, k, C, s_max, h, p_full=0.05, p_zero=0.2,
           load=0.9, gap=None, svc_mean=3.0, need1=False, burst=0,
           drain=False) -> FMCase:
    """A trace on the :data:`bs_cases.TIE_UNIT` grid: exponential gaps (of
    mean ``gap``, else the one that puts the FCFS scan at ``load``) and
    services, a share ``p_zero`` of zero services, needs uniform in
    [1, k // 3] with a share ``p_full`` needing all k; classes uniform over
    C with slots drawn in [0, s_max] (class 0 has none, the last s_max).
    ``need1``: need-1 jobs with distinct, unrounded completions;
    ``burst``: they come in bursts of that many, 0.01 apart, 150 (three
    mean services) between bursts.
    ``drain``: 15 % of rows become failure rows (need 1, service 0) whose
    t_up lies far below, just below, at, just above or far above their
    time; failure rows target the helper or a class; 8 padding rows
    end each stream."""
    rng = np.random.default_rng(seed)
    unit = bs_cases.TIE_UNIT
    n_max = max(1, k // 3)
    if gap is None:
        mean_need = (1 - p_full) * (n_max + 1) / 2 + p_full * k
        gap = mean_need * svc_mean * (1 - p_zero) / (load * k)
    if need1:
        if burst:
            gaps = np.full((R, J), 0.01)
            gaps[:, ::burst] = 3 * svc_mean
            a = np.cumsum(gaps, 1)
        else:
            a = np.cumsum(rng.exponential(gap, (R, J)), 1)
        n = np.ones((R, J), np.int64)
        s = rng.exponential(svc_mean, (R, J))
    else:
        a = np.floor(np.cumsum(rng.exponential(gap, (R, J)), 1) / unit) * unit
        n = rng.integers(1, n_max + 1, (R, J))
        n[rng.random((R, J)) < p_full] = k
        s = np.ceil(rng.exponential(svc_mean, (R, J)) / unit) * unit
        s[rng.random((R, J)) < p_zero] = 0.0
    cls = rng.integers(0, C, (R, J))
    slots = rng.integers(0, s_max + 1, C)
    slots[0], slots[-1] = 0, s_max
    if not drain:
        f = _tensors(a, cls, n, s)
        return FMCase(name, (f[0],) + f[2:], f, k,
                      torch.tensor(slots, dtype=_I32), s_max, h)
    fail = rng.random((R, J)) < 0.15
    offs = np.stack([np.full((R, J), -1e9), -rng.exponential(5, (R, J)),
                     np.zeros((R, J)), rng.exponential(3, (R, J)),
                     rng.exponential(40, (R, J))])
    off = np.take_along_axis(offs, rng.integers(0, 5, (1, R, J)), 0)[0]
    t_up = np.where(fail, np.round(np.maximum(a + off, 0.0) / unit) * unit,
                    0.0)
    n = np.where(fail, 1, n)
    s = np.where(fail, 0.0, s)
    cls = np.where(fail, rng.integers(0, C + 1, (R, J)), cls)
    pad = 8
    a = np.concatenate([a, np.full((R, pad), np.inf)], 1)
    n = np.concatenate([n, np.ones((R, pad), np.int64)], 1)
    s = np.concatenate([s, np.zeros((R, pad))], 1)
    t_up = np.concatenate([t_up, np.zeros((R, pad))], 1)
    fail = np.concatenate([fail, np.ones((R, pad), bool)], 1)
    cls = np.concatenate([cls, np.full((R, pad), C)], 1)
    f = _tensors(a, np.zeros_like(cls), n, s, t_up, fail)
    m = _tensors(a, cls, n, s, t_up, fail)
    return FMCase(name, (f[0],) + f[2:], m, k,
                  torch.tensor(slots, dtype=_I32), s_max, h, True)


#: name -> make(J, R, seed) of the adversarial cases
ADVERSARIAL = {
    "k7": lambda J, R, seed: _synth("k7", J, R, seed, k=7, C=4, s_max=3,
                                    h=7),
    "k33": lambda J, R, seed: _synth("k33", J, R, seed, k=33, C=7,
                                     s_max=33, h=33),
    "k1000": lambda J, R, seed: _synth("k1000", J, R, seed, k=1000, C=5,
                                       s_max=40, h=200, p_full=0.02),
    "need1": lambda J, R, seed: _synth("need1", J, R, seed, k=1000, C=3,
                                       s_max=32, h=300, gap=0.01,
                                       svc_mean=50.0, need1=True),
    "bursts": lambda J, R, seed: _synth("bursts", J, R, seed, k=200, C=3,
                                        s_max=24, h=200, svc_mean=50.0,
                                        need1=True, burst=180),
    "h1": lambda J, R, seed: _synth("h1", J, R, seed, k=1, C=4, s_max=3,
                                    h=1),
    "ties": lambda J, R, seed: _from_batch_ties(J, R, seed),
    "kit512": lambda J, R, seed: table_case("kit", 512, J, R, seed,
                                            name="kit512"),
    "drain_k33": lambda J, R, seed: _synth("drain_k33", J, R, seed, k=33,
                                           C=7, s_max=33, h=33, drain=True),
    "drain_k7": lambda J, R, seed: _synth("drain_k7", J, R, seed, k=7, C=4,
                                          s_max=3, h=1, drain=True),
    "drain_heavy": lambda J, R, seed: drain_case(256, J, R, seed,
                                                 mix="heavy"),
}


def _from_batch_ties(J: int, R: int, seed: int) -> FMCase:
    """``bs_cases.ties_case``'s trace (Fig. 1 at k = 256, arrivals floored,
    services rounded up to :data:`bs_cases.TIE_UNIT`)."""
    c = bs_cases.ties_case(256, J, R, seed)
    a, cl, n, s = c.trace
    return FMCase("ties", (a, n, s), c.trace, 256, c.slots, c.s_max, c.h)


def scan(case: FMCase, kind: str, K):
    """``K``'s ``kind`` ("fcfs" or "modbs") wrapper on the case, ``K`` the
    kernel module (this tree's, or another checkout's): a tuple of its
    outputs."""
    if kind == "fcfs":
        fn = K.fcfs_fail_scan_fwd if case.drain else K.fcfs_scan_fwd
        return (fn(*case.fcfs, k=case.k),)
    fn = K.modbs_fail_scan_fwd if case.drain else K.modbs_scan_fwd
    return fn(*case.modbs, case.slots, s_max=case.s_max, h=case.h)


def scan_ref(case: FMCase, kind: str):
    """The plain version on the case, on the tensors' device."""
    from ..kernels.msj_scan import kernel as K

    if kind == "fcfs":
        fn = K.fcfs_fail_scan_ref if case.drain else K.fcfs_scan_ref
        return (fn(*case.fcfs, k=case.k),)
    fn = K.modbs_fail_scan_ref if case.drain else K.modbs_scan_ref
    return fn(*case.modbs, case.slots, s_max=case.s_max, h=case.h)
