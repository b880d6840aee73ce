#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which exits non-zero on failure:

1. build the msj_scan CUDA kernels from ``src/repro_torch/kernels/msj_scan/
   csrc`` with nvcc for sm_90a (into ``build/``) and print ptxas' report;
2. run each kernel on the card at the full width of the Figure-1 workload
   (k in {256, 2048}: its C, slots, h, and the ring capacity q_cap = 8192
   of a 100 000-job trace) with R = 16 replications and J = 4000 jobs,
   and require ``torch.equal`` with its plain PyTorch version on the same
   inputs (J is shortened because the plain version is a Python event
   loop); time the kernel and the plain version on the card;
3. drive the main path, ``sweep_many_server(figure1_workload, (256, 1024,
   2048), num_jobs=100_000, reps=16)`` for FCFS, ModBS-π and BS-π on the
   card, with every kernel's launch count set to 0 just before and read
   just after; check the results (finite; BS-π's P[wait > 0] falls as k
   grows and its mean response at k = 2048 is below FCFS's — the paper's
   trend) and a small sweep on the card against the same sweep on the
   CPU, field by field;
4. time each kernel at the main path's largest shape.

Then it prints the card's name and power limit, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository around it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CMP_J, REPS = 4000, 16
MAIN_KS, MAIN_J = (256, 1024, 2048), 100_000
POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F64_OPS_PER_S = 34e12          # H100 SXM float64 outside the tensor cores
KERNELS = {  # name -> (wrapper, TPU kernel it replaces)
    "fcfs_scan": ("fcfs_scan_fwd", "src/repro/kernels/msj_scan/kernel.py:73"),
    "modbs_scan": ("modbs_scan_fwd",
                   "src/repro/kernels/msj_scan/kernel.py:157"),
    "bs_scan": ("bs_scan_fwd", "src/repro/kernels/msj_scan/kernel.py:257"),
}
SOURCE = "src/repro_torch/kernels/msj_scan/csrc/msj_scan.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bound(name: str, R: int, J: int, k: int) -> tuple[float, str]:
    """Least time the card could take for one call: (ms, what bounds it).

    Bytes: every input read once and every output written once.
    Operations: the float64 maxima, additions and compares the function
    needs per event — a start time (2 maxima, 1 add) plus a binary search
    of log2(k) compares for FCFS; ModBS adds the class-row scan; BS
    decides among three candidate events per event.
    """
    log_k = max(1, (k - 1).bit_length())
    if name == "fcfs_scan":
        nbytes, ops = R * J * (8 + 4 + 8 + 8), R * J * (3 + log_k)
    elif name == "modbs_scan":
        nbytes, ops = R * J * (8 + 4 + 4 + 8 + 1 + 8), R * J * (6 + log_k)
    else:
        nbytes = R * J * (8 + 4 + 4 + 8) + R * 2 * J * (4 + 8) + R
        ops = R * 2 * J * (8 + log_k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from repro_torch.core import sim_torch
    from repro_torch.core.sim_batch import sweep_many_server
    from repro_torch.core.workload import figure1_workload
    from repro_torch.kernels.msj_scan import build
    from repro_torch.kernels.msj_scan import kernel as K

    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.time()
    lib_path = build.build_library()
    build.load_library()
    print(f"[build] {lib_path.relative_to(ROOT)} in {time.time() - t0:.1f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")

    def inputs(k: int, J: int, seed: int):
        wl = figure1_workload(k)
        b = wl.sample_traces(J, REPS, seed=seed)
        slots, s_max, h, q_cap = sim_torch._bs_args(
            b, None, wl, min(MAIN_J, 8192))
        t = dict(arrival=torch.tensor(b.arrival, device=dev),
                 cls=torch.tensor(b.cls, dtype=torch.int32, device=dev),
                 need=torch.tensor(b.need, dtype=torch.int32, device=dev),
                 service=torch.tensor(b.service, device=dev),
                 slots=torch.tensor(slots, device=dev))
        return t, dict(k=k, s_max=s_max, h=h, q_cap=q_cap)

    def calls(t, p):
        """name -> (kernel call, plain call) on the same tensors."""
        a, c, n, v, sl = (t["arrival"], t["cls"], t["need"], t["service"],
                          t["slots"])
        kw_m = dict(s_max=p["s_max"], h=p["h"])
        kw_b = dict(kw_m, q_cap=p["q_cap"])
        return {
            "fcfs_scan": (lambda: K.fcfs_scan_fwd(a, n, v, k=p["k"]),
                          lambda x: K.fcfs_scan_ref(*x(a, n, v), k=p["k"])),
            "modbs_scan": (lambda: K.modbs_scan_fwd(a, c, n, v, sl, **kw_m),
                           lambda x: K.modbs_scan_ref(*x(a, c, n, v, sl),
                                                      **kw_m)),
            "bs_scan": (lambda: K.bs_scan_fwd(a, c, n, v, sl, **kw_b),
                        lambda x: K.bs_scan_ref(*x(a, c, n, v, sl), **kw_b)),
        }

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    # -- 2. kernels against their plain versions --------------------------
    report = {}
    for k in (256, 2048):
        t, p = inputs(k, CMP_J, seed=1)
        for name, (kern, plain) in calls(t, p).items():
            out = as_tuple(kern())
            torch.cuda.synchronize()
            ref_cpu = as_tuple(plain(lambda *x: [y.cpu() for y in x]))
            t1 = time.time()
            ref_dev = as_tuple(plain(lambda *x: x))
            torch.cuda.synchronize()
            plain_ms = (time.time() - t1) * 1e3
            for o, r_cpu, r_dev in zip(out, ref_cpu, ref_dev):
                if not (torch.equal(o.cpu(), r_cpu)
                        and torch.equal(o, r_dev)):
                    fail(f"{name} at k={k} J={CMP_J} R={REPS} differs from "
                         f"its plain version")
            err = max((o.double() - r.double().to(dev)).abs().max().item()
                      for o, r in zip(out, ref_cpu))
            ms = cuda_ms(kern, 3)
            b_ms, b_by = bound(name, REPS, CMP_J, k)
            print(f"[kernel] {name} k={k} C={t['slots'].numel()} "
                  f"s_max={p['s_max']} h={p['h']} q_cap={p['q_cap']} "
                  f"R={REPS} J={CMP_J} (J cut: the plain version is a "
                  f"Python event loop): equal at tolerance 0 (torch.equal) "
                  f"to the plain version on CPU and on card, kernel {ms:.3f} ms, plain on card "
                  f"{plain_ms:.1f} ms, bound {b_ms:.5f} ms ({b_by})")
            report[name] = dict(
                name=name, route="cuda", source=SOURCE,
                replaces=KERNELS[name][1], launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"k={k} R={REPS} J={CMP_J}")

    # -- 3. the main path -------------------------------------------------
    K.reset_launches()
    t0 = time.time()
    sw = sweep_many_server(figure1_workload, MAIN_KS, num_jobs=MAIN_J,
                           reps=REPS, policies=POLICIES, device="cuda")
    torch.cuda.synchronize()
    counts = K.launches()
    wall = time.time() - t0
    print(f"[main] sweep_many_server(figure1_workload, {MAIN_KS}, "
          f"num_jobs={MAIN_J}, reps={REPS}) on the card: {wall:.1f} s, "
          f"launches {counts}")
    for j, k in enumerate(MAIN_KS):
        for i, pol in enumerate(POLICIES):
            print(f"[main] k={k} {pol:>10}: mean_response="
                  f"{sw.mean_response[i, j]:.6f} p_wait={sw.p_wait[i, j]:.6f}"
                  f" p_helper={sw.p_helper[i, j]:.6f} "
                  f"sim_s={sw.sim_s[i, j]:.3f}")
    for name, (wrapper, _) in KERNELS.items():
        report[name]["launches"] = counts[wrapper]
        if counts[wrapper] < 1:
            fail(f"the main path never launched {name}")
    for f in ("mean_response", "mean_wait", "p_wait", "p95_response",
              "utilization"):
        if not np.isfinite(getattr(sw, f)).all():
            fail(f"non-finite {f} in the sweep")
    ph = sw.p_helper
    if not (np.isnan(ph[0]).all() and np.isfinite(ph[1:]).all()):
        fail("p_helper must be nan for FCFS only")
    # The paper's claim (Thms 1-2): BS-pi's queueing probability vanishes
    # as k grows in the critical regime, at response times below FCFS's.
    # At these finite k its P[wait>0] is still above FCFS's (the JAX
    # reference gives the same numbers), so the check is the trend.
    bs_pw = sw.p_wait[2]
    if not (np.diff(bs_pw) < 0).all():
        fail(f"BS-pi P[wait>0] does not fall as k grows: {bs_pw}")
    fcfs_r, bs_r = sw.mean_response[0, -1], sw.mean_response[2, -1]
    if not bs_r < fcfs_r:
        fail(f"at k={MAIN_KS[-1]} BS-pi mean response {bs_r} is not below "
             f"FCFS's {fcfs_r}")
    print(f"[main] BS-pi P[wait>0] falls with k: "
          f"{', '.join(f'{x:.6f}' for x in bs_pw)}; at k={MAIN_KS[-1]} its "
          f"mean response {bs_r:.6f} < FCFS {fcfs_r:.6f}")

    small = dict(num_jobs=2000, reps=4, seed=3, policies=POLICIES)
    on_card = sweep_many_server(figure1_workload, (256, 2048), device="cuda",
                                **small)
    on_cpu = sweep_many_server(figure1_workload, (256, 2048), device="cpu",
                               **small)
    for f in ("mean_response", "ci95_response", "mean_wait", "p_wait",
              "ci95_p_wait", "p_helper", "p95_response", "utilization"):
        if not np.array_equal(getattr(on_card, f), getattr(on_cpu, f),
                              equal_nan=True):
            fail(f"small sweep: {f} on the card differs from the CPU")
    print("[main] small sweep (k=256, 2048; J=2000, R=4): card == CPU on "
          "every field")

    # -- 4. kernel times at the main path's largest shape -----------------
    t, p = inputs(MAIN_KS[-1], MAIN_J, seed=0)
    for name, (kern, _) in calls(t, p).items():
        ms = cuda_ms(kern, 2)
        rate = REPS * MAIN_J / (ms / 1e3)
        b_ms, b_by = bound(name, REPS, MAIN_J, MAIN_KS[-1])
        print(f"[time] {name} k={MAIN_KS[-1]} R={REPS} J={MAIN_J}: "
              f"{ms:.3f} ms per launch, {rate:.0f} jobs/s, bound "
              f"{b_ms:.5f} ms ({b_by})")
        report[name].update(main_ms=ms, main_jobs_per_s=rate,
                            main_bound_ms=b_ms,
                            main_shape=f"k={MAIN_KS[-1]} R={REPS} J={MAIN_J}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
