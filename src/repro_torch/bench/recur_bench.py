"""Time the two recurrence kernels, ``wkv`` (RWKV6) and the fused
``mamba_scan``, on the card beside another checkout's, and say where a
chunk's or a step's time goes.

    PYTHONPATH=src python -m repro_torch.bench.recur_bench \\
        [--parent DIR] [--phases] [--serve] [--out FILE]

Timed shapes (inputs made on the card from ``SEED``, the same in every
process):

* ``wkv`` at rwkv6-7b's prefill: B 1, H 64, N 64, chunk 64, S 512 and
  2048, r / k / v bfloat16 and float32, zero and carried state, log decays
  in the model's init range;
* ``mamba_scan_fused`` at jamba-1.5-large's layer: B 1, d_in 16384, N 16,
  S 512 and 2048, u bfloat16 and float32, carried h0, dt and A from the
  model's init ranges;
* ``mamba_scan_fwd`` (the reference kernel's entry) once, S 2048, a / b
  bfloat16.

Each tree runs in its own process (:mod:`.ab`; parent, this tree, this
tree, parent with ``--parent DIR``): the mean device time of ``REPS``
calls per shape and the largest error over limit of each output against
the plain version (``chip_smoke.py``'s limits).  It prints, per shape,
both trees' ms, parent / this, the bound (``chip_smoke.wkv_bound``,
``mamba_bound``) and its share of each tree's time, and each tree's
largest err/limit; it fails if an output of either tree is off its limit.
It also prints ``ptxas``' registers and spills of each tree's kernels.
``--serve`` also runs each tree's ``chip_smoke.rwkv_path`` and
``hybrid_path`` (rwkv6-7b and the jamba cut served at full width, their
checks included; ~1 min a tree) in the same order and prints each
request's prefill and decode time.  ``--phases`` builds, for each tree, a
copy of its ``wkv.cu`` and
``mamba_scan.cu`` with ``clock64`` stamps (thread 0 of each block) beside
the lines of the ``STAMPS`` table that matches the source (it fails if
none does; the kernels themselves carry no stamps) and prints the SM
cycles per chunk (``wkv``) or per step (``mamba_scan``) of each phase of
each kernel at S 2048.  ``--out`` writes every number as JSON.  Card
only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

if __package__:
    from . import ab
    from .timing import device_ms, insert_at
else:
    # a worker, run by path with another tree's package on PYTHONPATH: the
    # shared pieces are this tree's, from this file's directory
    import ab
    from timing import device_ms, insert_at

TREE = Path(__file__).resolve().parents[3]
SEED, REPS = 0, 20
WKV_H, WKV_N, WKV_CHUNK = 64, 64, 64
MAMBA_D, MAMBA_N = 16384, 16
# name -> (kernel, S, dtype, carried state)
SHAPES = {
    **{f"wkv_S{S}_{dt}_{'carried' if c else 'zero'}": ("wkv", S, dt, c)
       for S in (512, 2048) for dt in ("bfloat16", "float32")
       for c in (False, True)},
    **{f"mamba_fused_S{S}_u_{dt}": ("mamba_fused", S, dt, True)
       for S in (512, 2048) for dt in ("bfloat16", "float32")},
    "mamba_fwd_S2048_ab_bfloat16": ("mamba_fwd", 2048, "bfloat16", False),
}
#: the shapes ``--phases`` stamps
PHASE_SHAPES = ("wkv_S2048_bfloat16_carried", "wkv_S2048_float32_carried",
                "mamba_fused_S2048_u_bfloat16", "mamba_fused_S2048_u_float32")

# Each kernel version's phases and the lines that end them: per source
# file, per kernel, (line, phase that ends there, stamp before the
# line?); ``init`` is where the counters start (after it), ``done`` where
# thread 0 adds them to the totals (line, before it?), ``per`` what the
# blocks' summed counters are divided by: "chunks" (each block walks every
# chunk of its head: blocks x chunks), "tiles" (blocks share the (b, chunk,
# h) tiles: the tile count), "steps" (each block walks every step: blocks
# x S).  "chains" is the kernels that walk the sequence in order inside
# each block (one block per (b, h, 16 columns) walking the chunks; one
# thread per channel and its 16 states); "split" the chunk-parallel wkv
# kernels and the scan with a channel's states split over 4 lanes.
_END_STATE = ("}\n\n// ------------------------------------------------------"
              "---------------------\n// 2. The walk")
_END_OUT = "}\n\n// Blocks of a persistent chunk kernel"
STAMPS = {
    "chains": {
        "wkv.cu": {
            "wkv_kernel": dict(
                per="chunks",
                phases=("stage", "bonus and cumsum", "decay", "scores",
                        "y and state"),
                init="  const int warp = tid / 32, lane = tid % 32;\n",
                done=("  __syncthreads();\n  for (int i = tid; i < NM * MV; "
                      "i += NT) {\n    const int n = i / MV, m = m0 + i % MV;"
                      "\n    if (n < N && m < N) s_T", True),
                lines=(
                    ("    // 2. the bonus term", 0, True),
                    ("    // 3. r e^{c_prev} and k e^{-c}", 1, True),
                    ("    // 4. the scores, transposed", 2, True),
                    ("    // 5. row p of y and of the new state", 3, True),
                    ("      *reinterpret_cast<float4*>(&sm.S[p * MV + 4 * q])"
                     " = s;\n    }\n", 4, False),
                )),
        },
        "mamba_scan.cu": {
            "scan_fused_kernel": dict(
                per="steps",
                phases=("wait and stash", "issue prefetch", "steps"),
                init="  float p_dt[TC], p_u[TC], p_B[PER], p_C[PER];\n",
                done=("  if (live) {\n#pragma unroll\n    for (int n = 0; n < "
                      "NMAX; ++n)\n      if (n < N) h_T", True),
                lines=(
                    ("    stash_tile(s_C, p_C);\n    __syncthreads();\n", 0,
                     False),
                    ("    if (t0 + TC < S) fetch(t0 + TC);   // in flight while "
                     "this chunk runs\n", 1, False),
                    ("      y[x0 + (size_t)(t0 + t) * d_in] = yv;\n    }\n",
                     2, False),
                )),
        },
    },
    "split": {
        "wkv.cu": {
            "wkv_state_kernel": dict(
                per="tiles",
                phases=("stage next and wait", "cumsum", "decay",
                        "increment and store"),
                init="  int tile = blockIdx.x;\n",
                done=(_END_STATE, True),
                lines=(
                    ("    float w[SEG];\n    column_scan(sm.w[buf], n, t0, "
                     "w);\n", 0, True),
                    ("      // kd = k e^{-c} e^{c_T}, after every segment", 1,
                     True),
                    ("    // dS[n][m] = sum_t kd[t][n] v[t][m]", 2, True),
                    ("    __syncthreads();   // buf is free for the tile after"
                     " next", 3, True),
                )),
            "wkv_walk_kernel": dict(
                per="chunks",
                phases=("walk",),
                init="  float st = s0 != nullptr ? s0[e] : 0.f;\n",
                done=("  s_T[e] = st;\n", False),
                lines=(("  s_T[e] = st;\n", 0, True),)),
            "wkv_out_kernel": dict(
                per="tiles",
                phases=("wait for r, k, logw", "cumsum and bonus terms",
                        "decay and bonus", "wait for v, S",
                        "scores and r_dec S", "scores v and store"),
                init="  int tile = blockIdx.x;\n",
                done=(_END_OUT, True),
                lines=(
                    ("    const float un = n < N ? u[tl.h * N + n] : 0.f;\n",
                     0, True),
                    ("      // r e^{c_prev} and k e^{-c}, transposed", 1, True),
                    ("    cp_wait<0>();\n", 2, True),
                    ("    // the first staging buffer is free", 3, True),
                    ("    // the causal scores times v", 4, True),
                    ("    // y of the tile is out", 5, True),
                )),
        },
        "mamba_scan.cu": {
            "scan_fused_kernel": dict(
                per="steps",
                phases=("stage, wait and barrier", "steps", "barrier"),
                init="  int buf = 0;\n",
                done=("  if (live) {\n#pragma unroll\n    for (int j = 0; j < "
                      "NS; ++j)", True),
                lines=(
                    ("    // chunk t0's tiles are in", 0, True),
                    ("    __syncthreads();   // every lane is done with buf",
                     1, True),
                    ("    buf ^= 1;\n", 2, False),
                )),
        },
    },
}
#: where each version's stamped copy sums its counters: in registers for
#: "chains" (shared-memory counters slowed its stamped fused scan 1.7 x),
#: in shared memory for "split" (register counters lowered the persistent
#: output kernel's occupancy)
COUNTERS = {"chains": "registers", "split": "shared"}
MAX_K, MAX_PH = 4, 8


def cs():
    """``chip_smoke.py`` of this tree (its limits and bounds; it imports
    only the standard library at import time)."""
    if str(TREE) not in sys.path:
        sys.path.insert(0, str(TREE))
    import chip_smoke

    return chip_smoke


def make_inputs(name: str, dev):
    """The inputs of shape ``name`` on ``dev``, from ``SEED``."""
    import torch

    kernel, S, dtype, carried = SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(SEED + S)
    dt_ = getattr(torch, dtype)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    if kernel == "wkv":
        H, N = WKV_H, WKV_N
        r, k, v = randn(1, S, H, N), randn(1, S, H, N, scale=0.3), randn(
            1, S, H, N)
        logw = -torch.exp(rand(1, S, H, N) * 4.0 - 8.0)
        u, s0 = randn(H, N, scale=0.1), randn(1, H, N, N, scale=0.5)
        return (r.to(dt_), k.to(dt_), v.to(dt_), logw, u,
                s0 if carried else None)
    d_in, N = MAMBA_D, MAMBA_N
    # dt in [1e-3, 0.1] log-uniform, A = -(1..N): the model's init ranges
    dt = torch.exp(rand(1, S, d_in) * (np.log(0.1) - np.log(1e-3))
                   + np.log(1e-3))
    A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).repeat(
        d_in, 1)
    Bm, C = randn(1, S, N), randn(1, S, N)
    if kernel == "mamba_fused":
        return dt, A, Bm, randn(1, S, d_in).to(dt_), C, randn(
            1, d_in, N, scale=0.5)
    a = torch.exp(dt[..., None] * A)
    b = (dt[..., None] * Bm[:, :, None, :]) * randn(1, S, d_in)[..., None]
    return a.to(dt_), b.to(dt_), C


def calls(name: str, args):
    """(the kernel's call, the plain version's call) of shape ``name``."""
    from repro_torch.kernels.mamba_scan import (mamba_scan_fused,
                                                mamba_scan_fused_ref,
                                                mamba_scan_fwd,
                                                mamba_scan_ref)
    from repro_torch.kernels.rwkv6 import wkv_chunked_ref, wkv_fwd

    kernel = SHAPES[name][0]
    if kernel == "wkv":
        return (lambda: wkv_fwd(*args, chunk=WKV_CHUNK),
                lambda: wkv_chunked_ref(*args, chunk=WKV_CHUNK))
    if kernel == "mamba_fused":
        return (lambda: mamba_scan_fused(*args),
                lambda: mamba_scan_fused_ref(*args))
    return (lambda: (mamba_scan_fwd(*args, chunk=128),),
            lambda: (mamba_scan_ref(*args),))


def err_over_limit(name: str, outs, refs) -> float:
    """The largest |out - ref| / limit over the outputs, with
    ``chip_smoke.py``'s limits (``WKV_TOLS``, ``MAMBA_TOLS`` and two
    bfloat16 units for a bfloat16 y of the reference entry)."""
    import torch

    c = cs()
    kernel, _, dtype, _ = SHAPES[name]
    worst = 0.0
    for i, (o, r) in enumerate(zip(outs, refs)):
        r = r.float()
        if kernel == "wkv":
            a, rt = c.WKV_TOLS[dtype if i == 0 else "float32"]
            limit = a + rt * r.abs()
        else:
            limit = c.MAMBA_TOLS[0] + c.MAMBA_TOLS[1] * r.abs()
            if kernel == "mamba_fwd" and dtype == "bfloat16":
                limit = limit + 2 * torch.exp2(torch.floor(torch.log2(
                    r.abs().clamp_min(1e-30))) - 7)
        if not bool(torch.isfinite(o).all()):
            return float("inf")
        worst = max(worst, ((o.float() - r).abs() / limit).max().item())
    return worst


def ptxas_report() -> list:
    """Registers, stack and spills of this importable tree's ``wkv`` and
    ``mamba_scan`` kernels, from ``-Xptxas -v`` in each library's
    ``build.log``."""
    from repro_torch.kernels.mamba_scan import build as mb
    from repro_torch.kernels.rwkv6 import build as wb

    rows = []
    for lib in (wb.LIBRARY, mb.LIBRARY):
        lib.load()
        log = (lib.path().parent / "build.log").read_text()
        entry, props = None, None
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                entry = dict(kernel=m.group(1))
                rows.append(entry)
            elif m := re.search(r"Function properties for (\S+)", line):
                props = m.group(1)
            elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill"
                                 r" stores, (\d+) bytes spill loads", line)):
                for e in rows:
                    if e["kernel"] == props:
                        e.update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
            elif entry is not None and (m := re.search(
                    r"Used (\d+) registers", line)):
                entry["registers"] = int(m.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r["kernel"] = n
    except (OSError, subprocess.CalledProcessError):
        pass
    return rows


def worker(cases: Path, out: Path) -> dict:
    """Times the importable tree's wrappers on every shape and holds each
    output to its plain version."""
    import torch

    dev = torch.device("cuda", 0)
    res, ratios = {}, {}
    for name in json.loads(cases.read_text())["shapes"]:
        args = make_inputs(name, dev)
        call, plain = calls(name, args)
        outs = call()
        torch.cuda.synchronize()
        q = err_over_limit(name, outs, plain())
        res[name] = dict(ms=device_ms(call, REPS), err_over_limit=q)
        ratios[name] = q
        del args, outs
        torch.cuda.empty_cache()
    res["ptxas"] = ptxas_report()
    np.savez(out, **{k: np.float64(v) for k, v in ratios.items()})
    return res


def serve() -> dict:
    """The importable tree's ``chip_smoke.rwkv_path`` and ``hybrid_path``
    (its own checks included), run as chip_smoke runs them: each request's
    prefill and decode time (host clock, ``Request.prefill_s`` /
    ``decode_s``) per path."""
    import contextlib
    import gc
    import io

    import torch

    import repro_torch

    root = Path(repro_torch.__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke
    from repro_torch.kernels import attention_build
    from repro_torch.kernels.mamba_scan import build as mb
    from repro_torch.kernels.moe_gmm import build as gb
    from repro_torch.kernels.rwkv6 import build as wb

    for lib in (attention_build.LIBRARY, gb.LIBRARY, mb.LIBRARY, wb.LIBRARY):
        lib.load()
    dev = torch.device("cuda", 0)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rwkv = chip_smoke.rwkv_path(dev)["wkv"]["serve_s"]
        gc.collect()
        torch.cuda.empty_cache()
        hybrid = chip_smoke.hybrid_path(dev)[0]["serve_s"]
    return {"rwkv": rwkv, "hybrid": hybrid}


def stamped_source(src: str, tables: dict, kernel_index: dict, name: str,
                   counters: str) -> str:
    """``src`` with, in each kernel a table names, thread 0's SM cycles per
    phase summed in ``counters`` ("registers" or "shared" memory) and
    added at ``done`` to ``g_cyc[kernel]`` (with one count per block in
    ``g_blk``); ``stamps_read`` copies both out and ``stamps_reset``
    clears them."""
    if counters == "shared":
        init = (f"  __shared__ unsigned long long cyc_[{MAX_PH}];\n"
                "  if (threadIdx.x == 0)\n"
                f"    for (int i = 0; i < {MAX_PH}; ++i) cyc_[i] = 0;\n")
        add = "      if (threadIdx.x == 0) cyc_[{ph}] += now_ - last_;\n"
    else:
        init = f"  unsigned long long cyc_[{MAX_PH}] = {{}};\n"
        add = "      cyc_[{ph}] += (unsigned long long)(now_ - last_);\n"
    src = insert_at(src, "namespace {\n", (
        f"__device__ unsigned long long g_cyc[{MAX_K}][{MAX_PH}];\n"
        f"__device__ unsigned long long g_blk[{MAX_K}];\n"), source=name)
    for kernel, t in tables.items():
        ki = kernel_index[kernel]
        k0 = src.find(f" {kernel}(")
        if k0 < 0:
            raise RuntimeError(f"kernel {kernel} not found in {name}")
        src = insert_at(src, t["init"],
                        init + "  long long last_ = clock64();\n", start=k0,
                        source=name)
        start = src.find(t["init"], k0)
        for line, ph, before in t["lines"]:
            src = insert_at(src, line, (
                "    {\n      const long long now_ = clock64();\n"
                + add.format(ph=ph) + "      last_ = now_;\n    }\n"),
                before=before, start=start, source=name)
        done, before = t["done"]
        src = insert_at(src, done, (
            "  if (threadIdx.x == 0) {\n"
            f"    for (int i = 0; i < {MAX_PH}; ++i)\n"
            f"      atomicAdd(&g_cyc[{ki}][i], cyc_[i]);\n"
            f"    atomicAdd(&g_blk[{ki}], 1ull);\n  }}\n"), before=before,
            start=start, source=name)
    return insert_at(src, 'extern "C" {\n', (
        "int stamps_read(void* c, void* b) {\n"
        "  cudaError_t e = cudaMemcpyFromSymbol(c, g_cyc, sizeof(g_cyc));\n"
        "  if (e != cudaSuccess) return (int)e;\n"
        "  return (int)cudaMemcpyFromSymbol(b, g_blk, sizeof(g_blk));\n}\n"
        "int stamps_reset() {\n"
        f"  static unsigned long long z[{MAX_K} * {MAX_PH} + {MAX_K}] = {{}};"
        "\n  cudaError_t e = cudaMemcpyToSymbol(g_cyc, z, sizeof(g_cyc));\n"
        "  if (e != cudaSuccess) return (int)e;\n"
        "  return (int)cudaMemcpyToSymbol(g_blk, z, sizeof(g_blk));\n}\n"),
        source=name)


def stamp_version(sources: dict) -> str:
    """The ``STAMPS`` version whose lines all appear in the sources
    (file name -> text); raises ``RuntimeError`` when none does."""
    for version, files in STAMPS.items():
        if all(t["init"] in sources[f] and t["done"][0] in sources[f]
               and all(line in sources[f] for line, _, _ in t["lines"])
               for f, tables in files.items() for t in tables.values()):
            return version
    raise RuntimeError("no STAMPS table matches this wkv.cu / mamba_scan.cu:"
                       " a stamped line moved")


def phases(cases: Path) -> dict:
    """SM cycles per chunk (wkv) or step (mamba_scan) of each phase of
    each kernel, from stamped copies of the importable tree's sources."""
    import torch

    from repro_torch.kernels._build import Library, build_dir
    from repro_torch.kernels.mamba_scan import build as mb
    from repro_torch.kernels.rwkv6 import build as wb

    builds = {"wkv.cu": wb, "mamba_scan.cu": mb}
    sources = {f: Path(b.SOURCES[0]).read_text() for f, b in builds.items()}
    version = stamp_version(sources)
    out_dir = build_dir() / "recur_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for f, b in builds.items():
        tables = STAMPS[version][f]
        index = {k: i for i, k in enumerate(tables)}
        path = out_dir / f"{Path(f).stem}_stamped.cu"
        path.write_text(stamped_source(sources[f], tables, index, f,
                                       COUNTERS[version]))
        libs[f] = (Library(f"{b.LIBRARY.name}_stamped", (path,),
                           b.NVCC_FLAGS, {**b.LIBRARY.sigs,
                                          "stamps_read": [ctypes.c_void_p,
                                                          ctypes.c_void_p],
                                          "stamps_reset": []},
                           error_fn=b.LIBRARY.error_fn).load(),
                   b.LIBRARY.load(), tables, index)
    dev = torch.device("cuda", 0)
    res = {"version": version}
    for name in PHASE_SHAPES:
        kernel, S, _, _ = SHAPES[name]
        f = "wkv.cu" if kernel == "wkv" else "mamba_scan.cu"
        lib, plain, tables, index = libs[f]
        b = builds[f]
        args = make_inputs(name, dev)
        call, _ = calls(name, args)
        ms = device_ms(call, REPS)
        b.LIBRARY._lib = lib           # the wrapper launches the copy
        try:
            ms_stamped = device_ms(call, REPS)
            torch.cuda.synchronize()
            if lib.stamps_reset() != 0:
                raise RuntimeError("stamps_reset failed")
            call()
            torch.cuda.synchronize()
        finally:
            b.LIBRARY._lib = plain
        cyc = np.zeros((MAX_K, MAX_PH), np.uint64)
        blk = np.zeros(MAX_K, np.uint64)
        if lib.stamps_read(cyc.ctypes.data, blk.ctypes.data) != 0:
            raise RuntimeError("stamps_read failed")
        nc = -(-S // WKV_CHUNK)
        kernels = {}
        for k, t in tables.items():
            i, nb = index[k], float(blk[index[k]])
            units = {"chunks": nb * nc, "tiles": nc * WKV_H,
                     "steps": nb * S}[t["per"]]
            kernels[k] = dict(blocks=nb, per=t["per"], cycles=dict(zip(
                t["phases"], (cyc[i, :len(t["phases"])].astype(np.float64)
                              / max(units, 1.0)).tolist())))
        res[name] = dict(ms=ms, ms_stamped=ms_stamped, kernels=kernels)
        del args
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--cases", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--stamps", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--serve-worker", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker is not None:
        print(json.dumps(worker(a.cases, a.worker)))
        return 0
    if a.stamps:
        print(json.dumps(phases(a.cases)))
        return 0
    if a.serve_worker:
        print(json.dumps(serve()))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("recur_bench: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels._build import build_dir

    here = Path(__file__).resolve()
    work = build_dir() / "recur_bench"
    work.mkdir(parents=True, exist_ok=True)
    cases = work / "cases.json"
    cases.write_text(json.dumps({"shapes": list(SHAPES)}))
    report = {"device": ab.nvidia_smi(), "shapes": {}}
    print(report["device"], flush=True)
    parent = a.parent.resolve() if a.parent is not None else None
    times, _ = ab.run_trees(here, cases, work, parent, TREE)
    c = cs()
    bad = []
    for name, (kernel, S, dtype, carried) in SHAPES.items():
        if kernel == "wkv":
            b_ms, b_by = c.wkv_bound(1, S, WKV_H, WKV_N, WKV_CHUNK, dtype)
        else:
            b_ms, b_by = c.mamba_bound(1, S, MAMBA_D, MAMBA_N,
                                       fused=kernel == "mamba_fused",
                                       dtype=dtype)
        row = dict(bound_ms=b_ms, bound_by=b_by)
        line = f"[bench] {name}: bound {b_ms:.5f} ms ({b_by});"
        for tag, runs in times.items():
            ms = [r[name]["ms"] for r in runs]
            q = max(r[name]["err_over_limit"] for r in runs)
            m = float(np.mean(ms))
            row[tag] = dict(ms=ms, err_over_limit=q)
            line += (f" {tag} {m:.4f} ms (runs "
                     f"{', '.join(f'{x:.4f}' for x in ms)}; "
                     f"{b_ms / m:.3f} of bound; err/limit {q:.3g});")
            if not q <= 1.0:
                bad.append(f"{tag} {name}: err/limit {q}")
        if parent is not None:
            row["speedup"] = (np.mean(row["parent"]["ms"])
                              / np.mean(row["this"]["ms"]))
            line += f" parent / this {row['speedup']:.3f}x"
        report["shapes"][name] = row
        print(line)
    for tag, runs in times.items():
        report[f"ptxas_{tag}"] = runs[0]["ptxas"]
        for r in runs[0]["ptxas"]:
            print(f"[ptxas] {tag} {r['kernel']}: {r.get('registers')} "
                  f"registers, {r.get('stack')} bytes stack, "
                  f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes "
                  f"spill stores / loads")
    if a.phases:
        report["phases"] = {}
        vers = [("this", TREE)]
        if parent is not None:
            vers.insert(0, ("parent", parent))
        for tag, src_tree in vers:
            ph = ab.run_worker(here, src_tree, cases, "--stamps")
            report["phases"][tag] = ph
            for name in PHASE_SHAPES:
                r = ph[name]
                for k, kr in r["kernels"].items():
                    cyc = kr["cycles"]
                    tot = sum(cyc.values())
                    unit = "step" if "mamba" in name else "chunk"
                    print(f"[phases] {tag} ({ph['version']}) {name} {k}: "
                          f"{tot:.0f} SM cycles per {unit} ("
                          + ", ".join(f"{p} {x:.0f} = {100 * x / tot:.1f}%"
                                      for p, x in cyc.items())
                          + f"); {kr['blocks']:.0f} blocks; stamped copy "
                          f"{r['ms_stamped']:.4f} ms, kernel {r['ms']:.4f} "
                          f"ms")
    if a.serve:
        report["serve"] = {}
        order = [("this", TREE)]
        if parent is not None:
            order = [("parent", parent), ("this", TREE), ("this", TREE),
                     ("parent", parent)]
        for tag, src_tree in order:
            r = ab.run_worker(here, src_tree, cases, "--serve-worker")
            report["serve"].setdefault(tag, []).append(r)
            for path, walls in r.items():
                print(f"[serve] {tag} {path}: " + "; ".join(
                    f"{k} prefill {w['prefill'] * 1e3:.1f} ms, decode "
                    f"{w['decode_per_token'] * 1e3:.2f} ms per token"
                    for k, w in walls.items()), flush=True)
    print(report["device"])
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(report, indent=1))
    if bad:
        print("recur_bench: outputs off their limits: " + "; ".join(bad),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
