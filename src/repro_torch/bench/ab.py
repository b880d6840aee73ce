"""What the two-tree scan benches share (:mod:`.bs_bench`, :mod:`.fm_bench`):
running this checkout beside another one, each in its own process, in the
order parent, this, this, parent, and requiring their outputs equal;
stamping a copy of ``csrc/msj_scan.cu`` with ``clock64`` counters per
phase; splitting one ``engines.simulate`` call on the host; summing a
policy's ``sim_s`` over the paths chip_smoke runs.

A bench script is also run by path as the worker of another tree (that
tree's ``src`` the only package on ``PYTHONPATH``), so this module
imports nothing of the package at import time; it is loaded from the
script's own directory there.  Card only at call time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

if __package__:
    from .timing import device_ms, insert_at
else:
    from timing import device_ms, insert_at

#: replications and phases the stamped copy keeps counters for
MAX_R, MAX_PHASES = 1024, 8


def nvidia_smi() -> str:
    """The card's name and power limit."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def run_trees(script: Path, cases: Path, work: Path, parent: Path | None,
              tree: Path) -> tuple[dict, dict]:
    """Run ``script --worker`` for this tree (and ``parent``: parent, this,
    this, parent), each in its own process with that tree's ``src`` on
    ``PYTHONPATH``.  Returns (tag -> the workers' JSON results, tag -> the
    outputs each saved, as a loaded ``.npz``)."""
    order = [("this", tree)]
    if parent is not None:
        order = [("parent", parent), ("this", tree), ("this", tree),
                 ("parent", parent)]
    times: dict[str, list] = {}
    outs = {}
    for i, (tag, src_tree) in enumerate(order):
        out = work / f"out-{tag}{i}.npz"
        times.setdefault(tag, []).append(
            run_worker(script, src_tree, cases, "--worker", str(out)))
        outs[tag] = np.load(out)
    return times, outs


def run_worker(script: Path, src_tree: Path, cases: Path, *args) -> dict:
    """``script --cases cases *args`` with ``src_tree/src`` on
    ``PYTHONPATH``; its last stdout line, as JSON."""
    env = dict(os.environ, PYTHONPATH=str(src_tree / "src"))
    # the script drives the other tree's package: its own directory is
    # first on sys.path, the tree's src is the only package on it
    cmd = [sys.executable, str(script), "--cases", str(cases), *args]
    p = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"{src_tree} {args} failed:\n{p.stderr[-4000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def first_difference(outs: dict) -> str | None:
    """The first saved output that differs between this tree and the
    parent, or None."""
    for key in outs["this"].files:
        if not np.array_equal(outs["this"][key], outs["parent"][key]):
            return key
    return None


def stamp_version(src: str, stamps: dict) -> str:
    """The ``stamps`` version whose tables' lines all appear in ``src``;
    raises ``RuntimeError`` when none does (a stamped line moved)."""
    for version, tables in stamps.items():
        if all(t["init"] in src and all(line in src
                                        for line, _, _ in t["lines"])
               for t in tables.values()):
            return version
    raise RuntimeError("no STAMPS table matches this csrc/msj_scan.cu: a "
                       "stamped line moved")


def stamped_source(src: str, tables: dict) -> str:
    """``src`` (a ``csrc/msj_scan.cu``) with, in each kernel a table names
    (``kernel`` -> table; a table's ``init`` and lines are searched from
    the kernel's definition on), each replication's SM cycles per phase
    summed in registers and written to ``g_cyc`` [MAX_R, phases] at its
    ``done`` (line, before it?); ``stamps_read`` copies them out."""
    name = "msj_scan.cu"
    n = MAX_PHASES
    assert all(len(t["phases"]) <= n for t in tables.values())
    src = insert_at(src, "namespace {\n",
                    f"__device__ unsigned long long g_cyc[{MAX_R}][{n}];\n",
                    source=name)
    for kernel, table in tables.items():
        k0 = src.find(f" {kernel}(")
        if k0 < 0:
            raise RuntimeError(f"kernel {kernel} not found in {name}")
        src = insert_at(src, table["init"],
                        f"  unsigned long long cyc_[{n}] = {{}};\n"
                        "  long long last_ = clock64();\n", start=k0,
                        source=name)
        start = src.find(table["init"], k0)
        for line, ph, before in table["lines"]:
            src = insert_at(src, line, (
                "    {\n      const long long now_ = clock64();\n"
                f"      cyc_[{ph}] += (unsigned long long)(now_ - last_);\n"
                "      last_ = now_;\n    }\n"), before=before, start=start,
                source=name)
        done, before = table["done"]
        src = insert_at(src, done,
                        "  if (threadIdx.x == 0 && blockIdx.x < "
                        f"{MAX_R})\n    for (int i = 0; i < {n}; ++i) "
                        "g_cyc[blockIdx.x][i] = cyc_[i];\n", before=before,
                        start=start, source=name)
    return insert_at(src, 'extern "C" {\n', (
        "int stamps_read(void* c) {\n"
        "  return (int)cudaMemcpyFromSymbol(c, g_cyc, sizeof(g_cyc));\n}\n"),
        source=name)


def stamped_library(stamps: dict, tag: str):
    """Build this importable tree's stamped ``msj_scan`` library; returns
    (the stamped library, the plain one, the matched version)."""
    import ctypes

    from repro_torch.kernels._build import Library, build_dir
    from repro_torch.kernels.msj_scan import build

    out = build_dir() / tag
    out.mkdir(parents=True, exist_ok=True)
    src = Path(build.SOURCES[0]).read_text()
    version = stamp_version(src, stamps)
    (out / "msj_scan_stamped.cu").write_text(
        stamped_source(src, stamps[version]))
    stamped = Library(f"msj_scan_{tag}_stamped",
                      (out / "msj_scan_stamped.cu", *build.SOURCES[1:]),
                      build.NVCC_FLAGS,
                      {**build.LIBRARY.sigs, "stamps_read": [ctypes.c_void_p]},
                      error_fn="msj_error_string")
    return stamped.load(), build.LIBRARY.load(), version


def stamped_cycles(lib, plain, call, reps: int, R: int, steps: int,
                   phases: tuple) -> dict:
    """Time ``call`` on the plain and the stamped library, and the stamped
    run's SM cycles per step of each phase (mean over R replications)."""
    import torch

    from repro_torch.kernels.msj_scan import build

    ms = device_ms(call, reps)
    build.LIBRARY._lib = lib       # the wrapper launches the copy
    try:
        ms_stamped = device_ms(call, reps)
        call()
        torch.cuda.synchronize()
    finally:
        build.LIBRARY._lib = plain
    cyc = np.zeros((MAX_R, MAX_PHASES), np.uint64)
    rc = lib.stamps_read(cyc.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"stamps_read failed: cudaError {rc}")
    per = (cyc[:R, :len(phases)].astype(np.float64).sum(0)
           / (R * steps)).tolist()
    return dict(cycles_per_step=dict(zip(phases, per)),
                ms_stamped=ms_stamped, ms=ms, steps=steps)


def host_split(policy: str, batch, wl, device, parts_of: dict) -> dict:
    """Wall seconds of one ``engines.simulate(policy, batch)`` call, split
    at synchronised boundaries: ``parts_of`` maps a function of
    :mod:`repro_torch.kernels.msj_scan.ops` to the part its calls are
    charged to (upload, kernel, download, assembly); the rest is
    ``other``."""
    import torch

    from repro_torch.core import engines
    from repro_torch.kernels.msj_scan import ops

    parts = {p: 0.0 for p in parts_of.values()}
    saved = {n: getattr(ops, n) for n in parts_of}

    def timed(part, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[part] += time.perf_counter() - t0
            return out
        return run

    for n, part in parts_of.items():
        setattr(ops, n, timed(part, saved[n]))
    try:
        engines.simulate(policy, batch, wl=wl, device=device)  # warm-up
        torch.cuda.synchronize()
        for p in parts:
            parts[p] = 0.0
        t0 = time.perf_counter()
        engines.simulate(policy, batch, wl=wl, device=device)
        torch.cuda.synchronize()
        parts["total"] = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
    parts["other"] = parts["total"] - sum(parts[p]
                                          for p in set(parts_of.values()))
    return parts


def paths_sim_s(policies: tuple, device) -> dict:
    """Each policy's ``sim_s`` on the Fig. 1 sweep (k 256, 1024, 2048,
    J = 100 000, R = 16), summed over ``fig3_traces.run()`` and on the
    drain sweep (k 256, 1024 under bench_failures' outages), as chip_smoke
    runs them, and the Fig. 1 sweep's wall time: policy -> numbers."""
    import torch

    from repro_torch.bench import fig3_traces
    from repro_torch.core.failures import FailureProcess
    from repro_torch.core.sim_batch import sweep_many_server
    from repro_torch.core.workload import figure1_workload

    def bench_failures(wl, batch, seed=0):
        h0 = float(batch.arrival.max())
        return FailureProcess(mtbf=h0 / 4, mttr=h0 / 400).sample(
            wl.k, h0, batch.reps, seed=seed)

    t0 = time.perf_counter()
    sw = sweep_many_server(figure1_workload, (256, 1024, 2048),
                           num_jobs=100_000, reps=16, policies=policies,
                           device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = fig3_traces.run(policies=policies, device=device)
    swf = sweep_many_server(figure1_workload, (256, 1024), num_jobs=100_000,
                            reps=16, policies=policies, device=device,
                            failures=bench_failures)
    return {pol: dict(
        fig1_wall_s=wall, fig1_sim_s=[float(x) for x in sw.sim_s[i]],
        fig3_sim_s=float(sum(r["sim_s"] for r in rows if r["policy"] == pol)),
        drain_sim_s=[float(x) for x in swf.sim_s[i]])
        for i, pol in enumerate(policies)}
