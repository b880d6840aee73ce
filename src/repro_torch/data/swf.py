"""Standard Workload Format (SWF) — the real-log parser and the Figure-3
traces synthesized from the paper's Table-2/3 parameters.

The port's copy of ``repro.data.swf``.  The paper evaluates on the
SDSC-SP2 and KIT-FH2 logs of the Parallel Workloads Archive, which are not
redistributable here, so the Figure-3 path samples SWF-like traces from
the tables' per-class lognormal fits at a target load (a seed gives the
reference's trace bit for bit), and ``parse_swf`` reads a real log when
one is supplied (``fig3_traces --swf``): the same rows kept, in the same
order, with the same classes, as the reference's parser.
``trace_to_workload`` fits a log's per-class workload for the eq.-2
partition, and ``write_swf`` writes a trace in SWF, byte for byte as the
reference does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.workload import (KIT_FH2_TABLE, SDSC_SP2_TABLE, JobClass,
                             LogNormal, Trace, Workload)


def parse_swf(path: str, *, k: int, max_need: int = 64,
              powers_of_two_only: bool = True, limit: int | None = None,
              statuses: tuple[int, ...] = (1, -1)) -> Trace:
    """Parse an SWF log into a Trace (fields 2=submit, 4=run, 5=procs,
    11=status).

    Only rows whose SWF status field is in ``statuses`` are kept — by
    default completed (1) and unknown (-1) jobs.  Failed (0) and
    cancelled (5) rows report truncated runtimes that pollute the
    per-class service-time fits, and partial-execution records (2-4) are
    fragments of one checkpointed job; all are dropped.  Rows too short
    to carry a status field count as unknown.  So are rows with a run
    time or a processor count <= 0, more than ``max_need`` processors or
    (``powers_of_two_only``) a count that is not a power of two.  At most
    ``limit`` rows are kept; the trace is sorted by submit time (stably)
    and class c holds the jobs of need 2^c.
    """
    arrivals, services, needs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            parts = line.split()
            submit, run, procs = float(parts[1]), float(parts[3]), \
                int(parts[4])
            status = int(parts[10]) if len(parts) > 10 else -1
            if status not in statuses:
                continue
            if run <= 0 or procs <= 0 or procs > max_need:
                continue
            if powers_of_two_only and procs & (procs - 1):
                continue
            arrivals.append(submit)
            services.append(run)
            needs.append(procs)
            if limit and len(arrivals) >= limit:
                break
    arrival = np.asarray(arrivals)
    order = np.argsort(arrival, kind="stable")
    need = np.asarray(needs, dtype=np.int64)[order]
    cls = np.log2(need).astype(np.int64)
    # classes are log2(need) bins up to max_need, independent of which bins
    # this particular log happens to populate
    C = int(math.log2(max_need)) + 1 if powers_of_two_only else None
    return Trace(arrival=arrival[order], cls=cls,
                 service=np.asarray(services)[order], need=need, k=k, C=C)


def trace_to_workload(trace: Trace, k: int, load: float) -> Workload:
    """Fit per-class (mean, alpha) from a trace; rescale λ to ``load``."""
    classes = []
    C = int(trace.cls.max()) + 1
    for c in range(C):
        mask = trace.cls == c
        if not mask.any():
            continue
        mean = float(trace.service[mask].mean())
        std = float(trace.service[mask].std())
        n = int(trace.need[mask][0])
        alpha = float(mask.mean())
        classes.append(JobClass(f"n{n}", n, LogNormal(mean, max(std, 1e-6)),
                                alpha))
    total = sum(c.alpha for c in classes)
    classes = [dataclasses.replace(c, alpha=c.alpha / total) for c in classes]
    return Workload(k=k, lam=1.0, classes=tuple(classes)).with_load(load)


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


def write_swf(trace: Trace, path: str) -> None:
    """Emit a Trace in SWF format (for interop with SWF tooling)."""
    with open(path, "w") as f:
        f.write("; synthesized from paper Table parameters\n")
        for i in range(trace.num_jobs):
            f.write(f"{i + 1} {trace.arrival[i]:.2f} 0 "
                    f"{trace.service[i]:.2f} {int(trace.need[i])} "
                    f"-1 -1 {int(trace.need[i])} -1 -1 1 -1 -1 -1 -1 -1 -1 "
                    f"-1\n")
