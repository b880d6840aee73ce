"""Inputs of the ``srpt_scan`` cases shared by ``chip_smoke.py``,
:mod:`repro_torch.bench.srpt_bench` and the tests.

* :func:`table_case` — R IID bootstraps of a Table-2 (SDSC-SP2) or
  Table-3 (KIT-FH2) trace at a load, the Fig. 3 path's inputs;
* :func:`burst_case` — J jobs arriving in batches of equal times with
  services drawn from four values and needs from the SDSC-SP2 need
  classes: ties on arrival and on rank, and (at k = 512, batches of 100)
  hundreds to over a thousand jobs in the system, the large-n path of the
  kernel.

Each returns ``(arrival, need, service, kk)`` as float64 tensors on
``device`` ([R, J] and [R]) and the ascending need tuple ``NU``.
:func:`jobs_in_system` counts n after every event of a run.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..core import sim_torch
from ..core.workload import KIT_FH2_TABLE, SDSC_SP2_TABLE, BatchTrace
from ..data.swf import kit_fh2_trace, sdsc_sp2_trace

TABLES = {"sdsc": (SDSC_SP2_TABLE, sdsc_sp2_trace),
          "kit": (KIT_FH2_TABLE, kit_fh2_trace)}
#: the burst trace's service values (time units) and need classes
BURST_SERVICES = (1.0, 2.0, 3.0, 5.0)
BURST_NEEDS = tuple(int(row[2]) for row in SDSC_SP2_TABLE)


def _tensors(arrival, need, service, k: int, device):
    f64 = dict(dtype=torch.float64, device=device)
    R = arrival.shape[0]
    return (torch.tensor(arrival, **f64), torch.tensor(need, **f64),
            torch.tensor(service, **f64), torch.full((R,), float(k), **f64))


def table_case(dataset: str, J: int, k: int, R: int, seed: int,
               load: float = 0.85, device="cpu"):
    """R IID bootstraps of a J-job ``dataset`` ("sdsc" or "kit") trace at
    ``load`` -> (inputs, NU); NU is the table's need classes."""
    table, trace_fn = TABLES[dataset]
    b = BatchTrace.from_trace(trace_fn(J, k=k, load=load, seed=seed), R,
                              seed=seed)
    NU = tuple(sorted(int(row[2]) for row in table))
    return _tensors(b.arrival, b.need, b.service, k, device), NU


def burst_case(J: int, k: int, R: int, batch: int, gap: float, seed: int,
               device="cpu"):
    """J jobs in batches of ``batch`` equal arrival times ``gap`` apart
    (the last batch may be short), services drawn from
    :data:`BURST_SERVICES` and needs from :data:`BURST_NEEDS` (capped at
    k), independently per replication -> (inputs, NU)."""
    rng = np.random.default_rng(seed)
    arrival = np.broadcast_to(gap * (np.arange(J) // batch), (R, J)).copy()
    needs = np.array([v for v in BURST_NEEDS if v <= k])
    need = rng.choice(needs, (R, J)).astype(np.float64)
    service = rng.choice(BURST_SERVICES, (R, J))
    NU = tuple(sorted({int(v) for v in np.unique(need)}))
    return _tensors(arrival, need, service, k, device), NU


def slots(J: int, k: int, queue_cap=None) -> int:
    """The slot-table width Q the engines give a J-job, k-server run."""
    return sim_torch._srpt_args(SimpleNamespace(num_jobs=J, k=k), queue_cap)


def jobs_in_system(job_ev) -> np.ndarray:
    """n after each event [R, 2J], read off the departure stream as
    ``chip_smoke.srpt_bound`` does: every event is an arrival or a
    departure (exact when no arrival was dropped)."""
    dep = (np.asarray(job_ev) >= 0).astype(np.int64)
    return np.cumsum(1 - 2 * dep, axis=1)
