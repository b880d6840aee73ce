"""Figure 1 on the port — mean response time in the critical
(Halfin-Whitt) regime.

k sweeps with f_k = floor((k/32)^(2/3)), (1-ρ)√(k/f_k) -> θ = 0.7; small
jobs (f_k, 1) w.p. 0.95; large (2f_k, 40) / (4f_k, 20) / (8f_k, 10) w.p.
0.05/3 each; exponential services, Poisson arrivals (the paper's Fig. 1
setup).  Every row carries the theory columns of :func:`repro_torch.core.
theory.analyze`: ``ph_bound`` (eq. 16) and ``zero_wait_R`` (Thm 1's
limit).  Rows equal the reference script's (``benchmarks/fig1_critical.py``)
on every column but ``sim_s``.

* ``--engine torch`` (default): :func:`run_scan`, the batched sweep of
  FCFS, ModifiedBS-FCFS and BS-FCFS (``--reps`` Philox replications per
  k, mean/CI columns) on the ``fcfs_scan`` / ``modbs_scan`` / ``bs_scan``
  kernels, one grid launch per policy (``--no-grid``: one per cell);
  ``--device cpu`` runs their plain versions.  The reference's
  ``run_jax``.
* ``--engine python``: :func:`run`, the exact event engine over the
  paper's full policy set on one trace per k (slow).

::

    PYTHONPATH=src python -m repro_torch.bench.fig1_critical          # card
    PYTHONPATH=src python -m repro_torch.bench.fig1_critical --device cpu \\
        --ks 128 256 --jobs 2000 --reps 2

``--ckpt-dir D`` checkpoints each (k, policy) cell and ``--resume``
reloads them.  The reference's ``--devices`` (a sharded JAX mesh) and
``--cache-dir`` (an XLA compile cache) have no counterpart.
"""

from __future__ import annotations

import argparse

from ..core.theory import analyze
from ..core.workload import figure1_workload
from .common import (ENGINE_HELP, ENGINES, PAPER_POLICIES, SWEEP_POLICIES,
                     emit, run_policies, run_policies_scan)

COLS = ["k", "policy", "mean_response", "ci95_response", "reps", "mean_wait",
        "p_wait", "ci95_p_wait", "p_helper", "p95_response", "utilization",
        "ph_bound", "zero_wait_R", "sim_s"]


def _theory_cols(k: int, theta: float) -> dict:
    wl = figure1_workload(k, theta=theta)
    rep = analyze(wl)
    return {"ph_bound": rep.p_helper_modified,
            "zero_wait_R": wl.zero_wait_response_time()}


def run(ks=(256, 512, 1024, 2048), num_jobs=30_000, seed=0,
        policies=PAPER_POLICIES, theta=0.7):
    """Event-engine sweep (the paper's full policy set, one trace per k)."""
    rows = []
    for k in ks:
        wl = figure1_workload(k, theta=theta)
        rows += run_policies(
            wl, num_jobs, seed, policies,
            extra_cols={"k": k, **_theory_cols(k, theta)})
    return rows


def run_scan(ks=(256, 512, 1024, 2048), num_jobs=100_000, reps=8, seed=0,
             theta=0.7, policies=SWEEP_POLICIES, engine="torch",
             device="cuda", grid=True, ckpt_dir=None, resume=False):
    """Batched sweep (FCFS + ModifiedBS-FCFS + BS-FCFS, CIs): on the card
    unless ``device="cpu"``.  ``grid=True`` runs the whole k sweep as one
    kernel launch per policy; ``grid=False`` gives the same rows cell by
    cell."""
    return run_policies_scan(
        lambda k: figure1_workload(k, theta=theta), ks, "k",
        num_jobs=num_jobs, reps=reps, seed=seed, policies=policies,
        engine=engine, device=device, grid=grid,
        per_point_cols=[_theory_cols(k, theta) for k in ks],
        ckpt_dir=ckpt_dir, resume=resume)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=ENGINES, default="torch",
                    help=ENGINE_HELP)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--ks", type=int, nargs="+",
                    default=[256, 512, 1024, 2048])
    ap.add_argument("--policies", nargs="+", default=None,
                    help="subset of the engine's policy set")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale 10^6 arrivals")
    ap.add_argument("--no-grid", action="store_true",
                    help="run each (k, policy) cell separately instead of "
                         "one grid launch per policy")
    ap.add_argument("--ckpt-dir", default=None,
                    help="write each (k, policy) cell atomically here "
                         "(crash-resumable; --engine torch only)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already checkpointed in --ckpt-dir")
    args = ap.parse_args(argv)
    if args.engine == "python" and (args.ckpt_dir or args.resume):
        ap.error("--ckpt-dir/--resume need --engine torch")
    default = 30_000 if args.engine == "python" else 100_000
    jobs = args.jobs if args.jobs is not None \
        else (1_000_000 if args.full else default)
    if args.engine != "python":
        rows = run_scan(ks=tuple(args.ks), num_jobs=jobs, reps=args.reps,
                        policies=tuple(args.policies or SWEEP_POLICIES),
                        engine=args.engine, device=args.device,
                        grid=not args.no_grid, ckpt_dir=args.ckpt_dir,
                        resume=args.resume)
    else:
        rows = run(ks=tuple(args.ks), num_jobs=jobs,
                   policies=tuple(args.policies or PAPER_POLICIES))
    emit(rows, COLS)


if __name__ == "__main__":
    main()
