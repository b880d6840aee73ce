"""Inputs of the BS-π scan cases shared by ``chip_smoke.py``,
:mod:`repro_torch.bench.bs_bench` and the tests.

Each case function returns a :class:`BSCase`: the [R, J] trace tensors, the
partition's ``slots`` and the scan's ``s_max``, ``h`` and ``q_cap``, plus,
for a drain case, the [R, F] failure records and the scan ``length``.
:func:`scan` runs ``bs_scan_fwd`` / ``bs_fail_scan_fwd`` on a case (the
kernel on CUDA tensors, the plain version on CPU ones), :func:`scan_ref`
the plain version wherever the tensors are.

* :func:`fig1_case` — ``figure1_workload(k)`` (θ = 0.7), the Fig. 1 path;
* :func:`table_case` — R IID bootstraps of a Table-2 (SDSC-SP2, C = 7) or
  Table-3 (KIT-FH2) trace at a load, the Fig. 3 path; KIT-FH2 at k = 512
  has slots (2, 0, 0, 0, 0, 5, 4), so four of its seven classes go wholly
  to the helper and its rings stay long;
* :func:`drain_case` — a Fig. 1 trace under ``bench_sim.bench_failures``'
  outages (``mix="bench"``: mtbf = h/4, mttr = h/400, single servers) or a
  heavier mix (``"heavy"``: mttr = h/40, pods of 4), ring capacity J;
* :func:`ties_case` — a Fig. 1 trace with arrival times floored and
  services rounded up to multiples of 1/4: batches of equal arrival
  times and exactly representable sums, so arrivals, completions and
  helper commits tie across classes;
* :data:`ADVERSARIAL` — the cases every check runs: rings that wrap and
  overflow (Fig. 1's k = 256 with :func:`wrap_q_cap` entries a ring),
  KIT-FH2 at k = 512, the ties, SDSC-SP2 and the heavier drain mix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import sim_batch, sim_torch
from ..core.failures import FailureProcess
from ..core.workload import (BatchTrace, figure1_workload, kit_fh2_workload,
                             sdsc_sp2_workload)
from ..data.swf import kit_fh2_trace, sdsc_sp2_trace

TABLES = {"sdsc": (sdsc_sp2_trace, sdsc_sp2_workload),
          "kit": (kit_fh2_trace, kit_fh2_workload)}
#: outage mixes: horizon divisors of mtbf and mttr, and the pod size
#: ("bench": ``bench_sim.bench_failures``' process)
FAIL_MIXES = {"bench": (4, 400, 1), "heavy": (4, 40, 4)}
#: time unit the ties case rounds to (a power of two: sums stay exact)
TIE_UNIT = 0.25


@dataclasses.dataclass
class BSCase:
    """One BS-π scan's inputs; ``frec`` (ft, ftgt, fup) is None for a
    clean scan."""

    name: str
    trace: tuple            # arrival f64, cls i32, need i32, service f64
    slots: torch.Tensor     # [C] int32
    s_max: int
    h: int
    q_cap: int
    frec: tuple | None = None
    length: int | None = None

    @property
    def R(self) -> int:
        return self.trace[0].shape[0]

    @property
    def J(self) -> int:
        return self.trace[0].shape[1]

    @property
    def steps(self) -> int:
        """Scan steps per replication: 2J, or the drain scan's length."""
        return 2 * self.J if self.frec is None else self.length

    def to(self, device) -> "BSCase":
        def mv(ts):
            return None if ts is None else tuple(t.to(device) for t in ts)
        return dataclasses.replace(self, trace=mv(self.trace),
                                   slots=self.slots.to(device),
                                   frec=mv(self.frec))

    def arrays(self) -> dict:
        """Every tensor as numpy, by field name, and the scalars
        (``bs_bench`` saves a case so that another checkout's package,
        which may not have this module, can load it)."""
        out = dict(zip(("arrival", "cls", "need", "service"),
                       (t.cpu().numpy() for t in self.trace)))
        out["slots"] = self.slots.cpu().numpy()
        if self.frec is not None:
            out.update(zip(("ft", "ftgt", "fup"),
                           (t.cpu().numpy() for t in self.frec)))
        out.update(s_max=self.s_max, h=self.h, q_cap=self.q_cap,
                   length=-1 if self.length is None else self.length)
        return out


def _case(name, batch, wl, queue_cap, device, fb=None) -> BSCase:
    slots, s_max, h, q_cap = sim_torch._bs_args(batch, None, wl, queue_cap)
    f64 = dict(dtype=torch.float64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    trace = (torch.tensor(batch.arrival, **f64),
             torch.tensor(batch.cls, **i32),
             torch.tensor(batch.need, **i32),
             torch.tensor(batch.service, **f64))
    frec, length = None, None
    if fb is not None:
        ft, ftgt, fup, length = sim_batch._bs_fail_args(batch, fb, None, wl)
        frec = (torch.tensor(ft, **f64), torch.tensor(ftgt, **i32),
                torch.tensor(fup, **f64))
    return BSCase(name, trace, torch.tensor(slots, **i32), s_max, h, q_cap,
                  frec, length)


def fig1_case(k: int, J: int, R: int, seed: int, queue_cap=None,
              device="cpu", name="fig1") -> BSCase:
    """``figure1_workload(k).sample_traces(J, R, seed)``; ring capacity
    ``queue_cap`` (default ``min(J, 8192)``, the engines')."""
    wl = figure1_workload(k)
    return _case(name, wl.sample_traces(J, R, seed=seed), wl, queue_cap,
                 device)


def table_case(dataset: str, k: int, J: int, R: int, seed: int,
               load: float = 0.85, device="cpu", name=None) -> BSCase:
    """R IID bootstraps of a J-job ``dataset`` ("sdsc" or "kit") trace at
    ``load``, with that workload's partition, as ``fig3_traces.run``
    builds them."""
    trace_fn, wl_fn = TABLES[dataset]
    b = BatchTrace.from_trace(trace_fn(J, k=k, load=load, seed=seed), R,
                              seed=seed)
    return _case(name or dataset, b, wl_fn(k=k, load=load), None, device)


def bench_failures(wl, batch, mix: str = "bench", seed: int = 0):
    """The outage process of ``mix`` over the batch's arrival horizon h
    (:data:`FAIL_MIXES`), sampled for the batch."""
    h0 = float(batch.arrival.max())
    d_up, d_down, pod = FAIL_MIXES[mix]
    return FailureProcess(mtbf=h0 / d_up, mttr=h0 / d_down,
                          pod_size=pod).sample(wl.k, h0, batch.reps,
                                               seed=seed)


def drain_case(k: int, J: int, R: int, seed: int, mix: str = "bench",
               device="cpu", name=None) -> BSCase:
    """A Fig. 1 trace under ``mix``'s outages; ring capacity J, so no ring
    overflows (chip_smoke's drain comparisons and timing)."""
    wl = figure1_workload(k)
    b = wl.sample_traces(J, R, seed=seed)
    return _case(name or f"drain_{mix}", b, wl, J, device,
                 fb=bench_failures(wl, b, mix, seed=seed))


def ties_case(k: int, J: int, R: int, seed: int, device="cpu",
              name="ties") -> BSCase:
    """A Fig. 1 trace with arrivals floored to whole time units and
    services rounded up to multiples of :data:`TIE_UNIT`."""
    wl = figure1_workload(k)
    b = wl.sample_traces(J, R, seed=seed)
    b = dataclasses.replace(
        b, arrival=np.floor(b.arrival),
        service=np.ceil(b.service / TIE_UNIT) * TIE_UNIT)
    return _case(name, b, wl, J, device)


def wrap_q_cap(J: int) -> int:
    """Ring capacity of the ``wrap`` case: 6 below J = 1000, else 32, so
    that at the J of the checks (240 on the CPU, 2000 on the card) every
    ring wraps and some replications overflow while others do not."""
    return 6 if J < 1000 else 32


#: name -> make(J, R, seed, device) of the adversarial cases
ADVERSARIAL = {
    "wrap": lambda J, R, seed, device="cpu": fig1_case(
        256, J, R, seed, queue_cap=wrap_q_cap(J), device=device,
        name="wrap"),
    "kit512": lambda J, R, seed, device="cpu": table_case(
        "kit", 512, J, R, seed, device=device, name="kit512"),
    "ties": lambda J, R, seed, device="cpu": ties_case(
        256, J, R, seed, device=device),
    "sdsc": lambda J, R, seed, device="cpu": table_case(
        "sdsc", 1024, J, R, seed, device=device),
    "drain_heavy": lambda J, R, seed, device="cpu": drain_case(
        256, J, R, seed, mix="heavy", device=device),
}


def _kw(case: BSCase) -> dict:
    kw = dict(s_max=case.s_max, h=case.h, q_cap=case.q_cap)
    if case.frec is not None:
        kw["length"] = case.length
    return kw


def scan(case: BSCase, K):
    """``K.bs_scan_fwd`` (or ``K.bs_fail_scan_fwd``) on the case, ``K``
    the kernel module (this tree's, or another checkout's)."""
    if case.frec is None:
        return K.bs_scan_fwd(*case.trace, case.slots, **_kw(case))
    return K.bs_fail_scan_fwd(*case.trace, *case.frec, case.slots,
                              **_kw(case))


def scan_ref(case: BSCase):
    """The plain version on the case, on the tensors' device."""
    from ..kernels.msj_scan import kernel as K

    if case.frec is None:
        return K.bs_scan_ref(*case.trace, case.slots, **_kw(case))
    return K.bs_fail_scan_ref(*case.trace, *case.frec, case.slots,
                              **_kw(case))
