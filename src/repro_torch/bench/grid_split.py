"""Where a grid's wall time goes, beside the same cells run one by one.

For each path chip_smoke runs — the Fig. 1 sweep's cells (k 256, 1024,
2048, J = 100 000, R = 16), Fig. 3's 12 cells (``fig3_traces.run()``
defaults) and the drain sweep's (k 256, 1024 under bench_failures'
outages) — and each of its policies, one ``engines.simulate_grid`` call
is split at synchronised boundaries into the plan (padding and stacking
on the host), upload, kernel (the wrapper call), download and per-cell
extraction; the same cells then run one ``engines.simulate`` each.  The
two alternate (grid, cells, grid, cells) and every result must be equal.
Card only::

    PYTHONPATH=src python -m repro_torch.bench.grid_split [--paths fig1]

The last line of its output is every number as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

PATHS = ("fig1", "fig3", "drain")
#: functions of :mod:`repro_torch.kernels.msj_scan.ops` charged to each
#: part of a grid call (the uploads are the calls of ``_upload``'s closure)
_PARTS = {
    "plan": ("_fcfs_grid_plan", "_fcfs_fail_grid_plan", "_modbs_grid_plan",
             "_modbs_fail_grid_plan", "_bs_grid_plan", "_bs_fail_grid_plan",
             "_srpt_grid_plan"),
    "kernel": ("fcfs_scan_fwd", "fcfs_fail_scan_fwd", "modbs_scan_fwd",
               "modbs_fail_scan_fwd", "bs_scan_fwd", "bs_fail_scan_fwd",
               "srpt_scan_fwd"),
    "download": ("_host",),
    "extract": ("_fcfs_grid_extract", "_fcfs_fail_grid_extract",
                "_modbs_grid_extract", "_modbs_fail_grid_extract",
                "_bs_grid_extract", "_srpt_grid_extract"),
}


def cells_of(path: str) -> tuple[list, tuple]:
    """(GridCells, policies) of one of chip_smoke's simulator paths."""
    from repro_torch.bench import bs_cases, fig3_traces
    from repro_torch.core import engines
    from repro_torch.core.workload import BatchTrace, figure1_workload

    if path == "fig3":
        cells = []
        for _, trace_fn, wl_fn in fig3_traces._DATASETS:
            for k in (512, 1024):
                for load in (0.5, 0.7, 0.85):
                    trace = trace_fn(15_000, k=k, load=load, seed=0)
                    cells.append(engines.GridCell(
                        BatchTrace.from_trace(trace, 4, seed=0),
                        wl=wl_fn(k=k, load=load)))
        return cells, fig3_traces.SCAN_POLICIES
    ks = (256, 1024, 2048) if path == "fig1" else (256, 1024)
    cells = []
    for k in ks:
        wl = figure1_workload(k)
        batch = wl.sample_traces(100_000, 16, seed=0)
        fb = (bs_cases.bench_failures(wl, batch, seed=0)
              if path == "drain" else None)
        cells.append(engines.GridCell(batch, wl=wl, failures=fb))
    return cells, ("fcfs", "modbs-fcfs", "bs-fcfs")


def grid_split(policy: str, cells, device) -> tuple[dict, list]:
    """Wall seconds of one ``simulate_grid`` call by part, and its
    results."""
    import torch

    from repro_torch.core import engines
    from repro_torch.kernels.msj_scan import ops

    parts = {p: 0.0 for p in (*_PARTS, "upload")}

    def timed(part, fn):
        def run(*a, **kw):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize(device)
            parts[part] += time.perf_counter() - t0
            return out
        return run

    saved = {n: getattr(ops, n) for names in _PARTS.values() for n in names}
    saved["_upload"] = ops._upload
    for part, names in _PARTS.items():
        for n in names:
            setattr(ops, n, timed(part, saved[n]))
    ops._upload = lambda *a: timed("upload", saved["_upload"](*a))
    try:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = engines.simulate_grid(policy, cells, device=device)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
    parts["other"] = wall - sum(parts.values())
    return dict(wall=wall, **parts), out


def cells_wall(policy: str, cells, device) -> tuple[float, list]:
    """Wall seconds of one ``simulate`` per cell, and the results."""
    import torch

    from repro_torch.core import engines

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = [engines.simulate(policy, c.batch, wl=c.wl, failures=c.failures,
                            device=device) for c in cells]
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def _same(a, b) -> bool:
    return all(
        (x is None and y is None) or (x is not None and y is not None
                                      and np.array_equal(x, y))
        for x, y in ((getattr(a, f.name), getattr(b, f.name))
                     for f in dataclasses.fields(a)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", nargs="+", choices=PATHS, default=PATHS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("grid_split: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.bench.ab import nvidia_smi

    dev = torch.device("cuda", 0)
    report = {"device": nvidia_smi(), "paths": {}}
    print(report["device"])
    for path in args.paths:
        cells, policies = cells_of(path)
        for pol in policies:
            grid_split(pol, cells, dev)        # warm-up: build, first launch
            runs, walls = [], []
            for _ in range(2):
                split, out = grid_split(pol, cells, dev)
                wall, ref = cells_wall(pol, cells, dev)
                if not all(_same(o, r) for o, r in zip(out, ref)):
                    print(f"grid_split: {path} {pol}: the grid differs from "
                          f"the cells run one by one", file=sys.stderr)
                    return 1
                runs.append(split)
                walls.append(wall)
            report["paths"].setdefault(path, {})[pol] = dict(
                grid=runs, cells_wall=walls)
            print(f"[grid] {path} {pol:>10} ({len(cells)} cells): grid "
                  + " / ".join(f"{r['wall']:.3f}" for r in runs)
                  + " s = " + ", ".join(
                      f"{p} {runs[0][p]:.3f}" for p in runs[0] if p != "wall")
                  + "; cell by cell " + " / ".join(f"{w:.3f}" for w in walls)
                  + " s")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
