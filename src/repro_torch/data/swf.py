"""Figure-3 traces synthesized from the paper's Table-2/3 parameters.

The port's copy of the synthesis half of ``repro.data.swf``: the raw
SDSC-SP2 and KIT-FH2 logs are not redistributable, so the Figure-3 path
samples SWF-like traces from the tables' per-class lognormal fits at a
target load.  A seed gives the reference's trace bit for bit.  The
real-log half (``parse_swf``, ``trace_to_workload``, ``write_swf``) is not
ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np

from ..core.workload import (KIT_FH2_TABLE, SDSC_SP2_TABLE, JobClass,
                             LogNormal, Trace, Workload)


def synthesize_swf(table, num_jobs: int, k: int, load: float,
                   seed: int = 0) -> Trace:
    """Synthesize an SWF-like trace from a Table-2/3 parameter block."""
    alphas = np.array([row[3] for row in table])
    alphas = alphas / alphas.sum()
    classes = tuple(
        JobClass(f"n{n}", int(n), LogNormal(mean, std), float(a))
        for (mean, std, n, _), a in zip(table, alphas))
    wl = Workload(k=k, lam=1.0, classes=classes).with_load(load)
    return wl.sample_trace(num_jobs, seed=seed)


def sdsc_sp2_trace(num_jobs: int, k: int = 512, load: float = 0.8,
                   seed: int = 0) -> Trace:
    """A Table-2 (SDSC SP2) trace of ``num_jobs`` jobs."""
    return synthesize_swf(SDSC_SP2_TABLE, num_jobs, k, load, seed)


def kit_fh2_trace(num_jobs: int, k: int = 512, load: float = 0.8,
                  seed: int = 0) -> Trace:
    """A Table-3 (KIT FH2) trace of ``num_jobs`` jobs."""
    return synthesize_swf(KIT_FH2_TABLE, num_jobs, k, load, seed)
