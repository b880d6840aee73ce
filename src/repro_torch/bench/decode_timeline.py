"""Where a ``decode_attention`` call spends its time on the card.

    PYTHONPATH=src python -m repro_torch.bench.decode_timeline

builds a copy of ``kernels/decode_attention/csrc/decode_attention.cu``
with ``%globaltimer`` stamps (thread 0 of each CTA) at the phase
boundaries of the split kernel (start, split planned, q loaded, K tiles
scored, last V tile started, P.V done, partial written) and of the
combine kernel (start, first partials staged, weights made, sums done),
runs one call at each case (bf16, Sk 8192, the served heads, fixed
positions), and prints each phase's min / median / max over the CTAs
with work, the split kernel's last end and the combine's window, in
microseconds from the first stamp, beside the call's device time
(queued behind a sleep kernel).  The stamps are inserted after or before
lines of the source that this script names; it fails if one is missing.
Card only.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import numpy as np
import torch

from ..kernels import attention_build as ab
from ..kernels._build import Library, build_dir
from ..kernels.decode_attention import kernel as dk
from .timing import device_ms, insert_at

HEADS = {"yi_9b": (32, 4, 128), "stablelm_3b": (32, 32, 80),
         "moonshot_v1_16b_a3b": (16, 16, 128),
         "jamba_1_5_large_398b": (64, 8, 128)}
POS = {1: [5160], 4: [7346, 2957, 1293, 3744]}
SPLIT = ("start", "planned", "q loaded", "K scored", "last V tile",
         "P.V done", "partial written")
COMBINE = ("start", "staged(0)", "weights", "sums done")
# (line of the source, stamp, before the line?)
SPLIT_AT = (
    ("  if (tid == 0) {\n    split_of(p, x, 0, plan);", 0, True),
    ("  const int start = plan[1], end = plan[2], n = end - start;", 1, False),
    ("  for (int e = tid; e < G * D; e += NT) "
     "Qs[e / D * QS + e % D] = to_f32(qb[e]);", 2, False),
    ("    if (t == 0) {               // every score is in: the split's "
     "softmax", 3, False),
    ("    const int rows = min(KT, n - t * KT);       // P.V of V tile t",
     4, True),
    ("  // the split's acc: row groups added in order", 5, True),
    ("}\n\n// One CTA per (query head h", 6, True),
)
COMBINE_AT = (
    ("  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;", 0,
     False),
    ("  stage(0);                     // in flight while the weights are "
     "made", 1, False),
    ("    ML[1] = fmaxf(L, 1e-30f);\n  }", 2, False),
    ("  T* ob = static_cast<T*>(p.o) + ((size_t)b * H + h) * Dv;", 3, True),
)


def _instrumented_source() -> str:
    csrc = Path(ab.SOURCES[2])
    src = csrc.read_text().replace(
        '#include "../../csrc/hopper.cuh"',
        f'#include "{(csrc.parents[2] / "csrc" / "hopper.cuh").resolve()}"')
    src = src.replace("namespace {\n", (
        "namespace {\n__device__ unsigned long long g_split[1 << 16][8];\n"
        "__device__ unsigned long long g_comb[1 << 14][4];\n"
        "__device__ __forceinline__ unsigned long long now() {\n"
        "  unsigned long long t;\n"
        '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
        "  return t;\n}\n"), 1)

    for line, k, before in SPLIT_AT:
        src = insert_at(src, line, (
            f"\n  if (threadIdx.x == 0) g_split[blockIdx.y * gridDim.x + "
            f"blockIdx.x][{k}] = now();\n"), before=before, source=csrc.name)
    at = src.index("decode_combine_kernel(const Params p) {")
    for line, k, before in COMBINE_AT:
        src = insert_at(src, line, (
            f"\n  if (threadIdx.x == 0) g_comb[blockIdx.y * gridDim.x + "
            f"blockIdx.x][{k}] = now();\n"), before=before, start=at,
            source=csrc.name)
    return src.replace('extern "C" {\n', (
        'extern "C" {\n'
        "int stamps_read(void* s, void* c) {\n"
        "  cudaMemcpyFromSymbol(s, g_split, sizeof(g_split));\n"
        "  return (int)cudaMemcpyFromSymbol(c, g_comb, sizeof(g_comb));\n}\n"
        "int stamps_clear() {\n"
        "  static unsigned long long zs[1 << 16][8], zc[1 << 14][4];\n"
        "  cudaMemcpyToSymbol(g_comb, zc, sizeof(zc));\n"
        "  return (int)cudaMemcpyToSymbol(g_split, zs, sizeof(zs));\n}\n"),
        1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=list(HEADS))
    ap.add_argument("--batch", nargs="+", type=int, default=[1, 4])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_timeline: needs a CUDA device")
    out = build_dir() / "decode_timeline"
    out.mkdir(parents=True, exist_ok=True)
    (out / "decode_attention_stamped.cu").write_text(_instrumented_source())
    sigs = {"attn_decode_fwd": ab.LIBRARY.sigs["attn_decode_fwd"],
            "stamps_read": [ctypes.c_void_p, ctypes.c_void_p],
            "stamps_clear": []}
    stamped = Library("attention_stamped",
                      (ab.SOURCES[0], out / "decode_attention_stamped.cu"),
                      ab.NVCC_FLAGS, sigs, error_fn="attn_error_string")
    lib = stamped.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plain = ab.LIBRARY.load()
    for arch in args.arch:
        H, Kh, D = HEADS[arch]
        for B in args.batch:
            q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
            k = torch.randn(B, 8192, Kh, D, generator=gen,
                            device=dev).bfloat16()
            v = torch.randn_like(k)
            pos = torch.tensor(POS[B], device=dev, dtype=torch.int32)
            ab.LIBRARY._lib = plain
            ms = device_ms(lambda: dk.decode_attention_fwd(q, k, v, pos),
                           20)
            ab.LIBRARY._lib = lib
            dk.decode_attention_fwd(q, k, v, pos)
            torch.cuda.synchronize()
            lib.stamps_clear()
            dk.decode_attention_fwd(q, k, v, pos)
            torch.cuda.synchronize()
            ab.LIBRARY._lib = plain
            sp = np.zeros((1 << 16, 8), np.uint64)
            cb = np.zeros((1 << 14, 4), np.uint64)
            lib.stamps_read(sp.ctypes.data, cb.ctypes.data)
            plan = dk.decode_plan(B, Kh, 8192, H // Kh, D, D, 2, n_sm)
            sp = sp[: plan.nx * Kh]
            work = sp[:, 1] > 0
            t0 = int(sp[sp[:, 0] > 0, 0].min())
            s = sp[work].astype(np.int64) - t0
            c = cb[cb[:, 0] > 0].astype(np.int64) - t0
            print(f"== {arch} bf16 B={B} pos={POS[B]}: {ms * 1e3:.1f} us a "
                  f"call (device time), {int(work.sum())} of "
                  f"{plan.nx * Kh} split CTAs with work")
            for i in range(1, len(SPLIT)):
                d = (s[:, i] - s[:, i - 1]) / 1e3
                print(f"   split {SPLIT[i - 1]} -> {SPLIT[i]}: min / median "
                      f"/ max {np.min(d):.2f} / {np.median(d):.2f} / "
                      f"{np.max(d):.2f} us")
            print(f"   split CTAs start within {s[:, 0].max() / 1e3:.2f} us,"
                  f" the last ends at {s[:, 6].max() / 1e3:.2f} us")
            for i, name in enumerate(COMBINE):
                print(f"   combine {name}: {c[:, i].min() / 1e3:.2f} .. "
                      f"{c[:, i].max() / 1e3:.2f} us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
