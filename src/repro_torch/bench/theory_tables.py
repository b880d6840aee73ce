"""Theorem 1/2 convergence tables on the port: the paper's analytical
claims, evaluated by :mod:`repro_torch.core.theory` and checked by
Monte-Carlo on the ``modbs_scan`` kernel (``estimate_p_helper``).

Rows equal the reference script's (``benchmarks/theory_tables.py``) on
every column, ``mc`` included when both sample the same ``--mc-jobs``::

    PYTHONPATH=src python -m repro_torch.bench.theory_tables          # card
    PYTHONPATH=src python -m repro_torch.bench.theory_tables --device cpu \\
        --mc-jobs 2000

* ``thm1_ph``: P_H^mod (eq. 16) under the subcritical scaling (7) with
  f_k = 1 at k in {64, 256, 1024}; its limit is 0.
* ``thm2_rate``: √(k/f_k) · P_H^mod under the critical scaling (8) at k
  in {512, 4096, 32768}; its limit is eq. (9).

``mc`` is the measured P_H of ModifiedBS-FCFS (scaled like ``value``) on
one replication of ``--mc-jobs`` arrivals, where k is small enough.
"""

from __future__ import annotations

import argparse
import math

from ..core.sim_torch import estimate_p_helper
from ..core.theory import (p_helper_upper_bound, theorem2_limit,
                           theorem2_prelimit)
from ..core.workload import (critical_scaling, default_fk,
                             figure1_base_classes, subcritical_scaling)
from .common import emit

COLS = ["table", "k", "f_k", "value", "reference", "mc"]


def run(mc_jobs=150_000, *, device="cuda"):
    """The two tables' rows; ``mc`` on the card unless ``device="cpu"``."""
    base = figure1_base_classes()
    rows = []
    # Thm 1: subcritical P_H^(k) -> 0  (f_k = 1 variant: exponential decay)
    lam = 0.85 / sum(c.alpha * c.d * c.n for c in base)
    one = lambda k: 1  # noqa: E731
    for k in (64, 256, 1024):
        wl = subcritical_scaling(base, lam, k, fk=one)
        bound = p_helper_upper_bound(wl)
        mc = (estimate_p_helper(wl, num_jobs=mc_jobs, device=device)
              if k <= 1024 else None)
        rows.append({"table": "thm1_ph", "k": k, "f_k": 1, "value": bound,
                     "reference": 0.0, "mc": mc})
    # Thm 2: sqrt(k/f_k) P_H -> theta * sum (alpha_i/theta_i) phi/Phi
    theta = 0.7
    limit = theorem2_limit(base, theta)
    for k in (512, 4096, 32768):
        f = default_fk(k)
        pre = theorem2_prelimit(base, theta, k)
        wl = critical_scaling(base, theta, k)
        mc = (math.sqrt(k / f) * estimate_p_helper(wl, num_jobs=mc_jobs,
                                                   device=device)
              if k <= 4096 else None)
        rows.append({"table": "thm2_rate", "k": k, "f_k": f, "value": pre,
                     "reference": limit, "mc": mc})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mc-jobs", type=int, default=150_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the modbs_scan kernel) or cpu (its plain "
                         "version)")
    args = ap.parse_args(argv)
    emit(run(args.mc_jobs, device=args.device), COLS)


if __name__ == "__main__":
    main()
