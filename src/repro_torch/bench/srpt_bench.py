"""Time ``srpt_scan`` on the card, beside another checkout's kernel, and
say where an event's time goes.

    PYTHONPATH=src python -m repro_torch.bench.srpt_bench \\
        [--parent DIR] [--phases] [--out FILE]

Cases (:mod:`repro_torch.bench.srpt_cases`): the Fig. 3 path's largest
shape, SDSC-SP2 and KIT-FH2 at k = 1024, Q = 4096, R = 4, J = 15 000,
load 0.85, and the burst, k = 512, Q = 2048, R = 4, J = 1500 in 15
batches of 100 equal arrival times; SF and FF each.  Every line gives the
mean and largest number n of jobs in the system per event.

Each tree is timed in its own process (mean device time of ``REPS``
calls), which also times ``fig3_traces.run()`` on the five scan
policies at its other defaults on the card (wall time, after a warm-up
call that builds the kernels).
``--parent DIR`` times the checkout at DIR (for example ``git archive`` of
the parent commit unpacked there) the same way on the same inputs, in the
order parent, this tree, this tree, parent, and requires both trees' seven
outputs to be equal (``torch.equal``) on every case.  ``--phases`` builds
a copy of ``csrc/srpt_scan.cu`` with ``clock64`` stamps inserted beside
the lines named in ``STAMPS`` (it fails if one moved) and prints the SM
cycles per event of each phase of the event loop (decide, rank, sort,
select, update) and the events whose sort fell back to the full merge
sort, beside the call's time.  ``--out`` writes every number as JSON.
Card only.
"""

from __future__ import annotations

import argparse
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
    # a worker, run by path with another tree's package on PYTHONPATH: the
    # timer is this tree's, from this file's directory (first on sys.path)
    from timing import device_ms, insert_at

CASES = (  # name, kind, k, Q, J
    ("sdsc", "table", 1024, 4096, 15_000),
    ("kit", "table", 1024, 4096, 15_000),
    ("burst", "burst", 512, 2048, 1500),
)
R, SEED, REPS = 4, 0, 3
PHASES = ("decide", "rank", "sort", "select", "update")
# (line of csrc/srpt_scan.cu, phase that ends there, before the line?)
STAMPS = (
    ("    peak = max(peak, n + (is_arr ? 1 : 0) - (is_dep ? 1 : 0));\n"
     "    __syncwarp();\n", 0, False),
    ("    // -- sort 1.", 1, True),
    ("    n = nw + nr;\n", 2, False),
    ("    // -- preempt / start, and the next event's earliest completion",
     3, True),
    ("    if (is_arr) na_cls = nu_index(nu, nnu, (int)na_need);\n"
     "    __syncwarp();\n", 4, False),
)
MAX_R = 1024   # replications the stamped copy keeps counters for


def stamped_source() -> str:
    """``csrc/srpt_scan.cu`` with each replication's SM cycles per phase
    (``STAMPS``) and its count of full merge sorts summed in registers and
    written to ``g_cyc`` [MAX_R, 6] at the end; ``stamps_read`` copies
    them out."""
    from repro_torch.kernels.msj_scan import build

    csrc = Path(build.SOURCES[1])
    src, name = csrc.read_text(), csrc.name
    n = len(PHASES)
    src = insert_at(src, "namespace {\n",
                    f"__device__ unsigned long long g_cyc[{MAX_R}][{n + 1}];\n",
                    source=name)
    src = insert_at(src, "  long long need_sum = 0;  // the needs of the jobs "
                    "in the system\n",
                    f"  unsigned long long cyc_[{n + 1}] = {{}};\n"
                    "  long long last_ = clock64();\n", source=name)
    for line, ph, before in STAMPS:
        src = insert_at(src, line, (
            "    {\n      const long long now_ = clock64();\n"
            f"      cyc_[{ph}] += (unsigned long long)(now_ - last_);\n"
            "      last_ = now_;\n    }\n"), before=before, source=name)
    src = insert_at(src, "      sort_list(T, nr, T.ord, nw, lane);\n",
                    f"      ++cyc_[{n}];\n", source=name)
    src = insert_at(src, "    ovf_out[blockIdx.x] = ovf;\n  }\n",
                    f"  if (lane == 0)\n    for (int i = 0; i <= {n}; ++i)"
                    " g_cyc[blockIdx.x][i] = cyc_[i];\n", source=name)
    return insert_at(src, 'extern "C" {\n', (
        "int stamps_read(void* c) {\n"
        "  return (int)cudaMemcpyFromSymbol(c, g_cyc, sizeof(g_cyc));\n}\n"),
        source=name)


def make_cases(path: Path) -> None:
    """Every case's inputs, made from ``SEED``, in one ``.npz`` at
    ``path``."""
    from repro_torch.bench import srpt_cases as C

    arrays = {}
    for name, kind, k, Q, J in CASES:
        if kind == "table":
            t, NU = C.table_case(name, J, k, R, seed=SEED)
        else:
            t, NU = C.burst_case(J, k, R, batch=100, gap=0.5, seed=SEED)
        for field, x in zip(("arrival", "need", "service", "kk"), t):
            arrays[f"{name}.{field}"] = x.numpy()
        arrays[f"{name}.NU"] = np.array(NU, dtype=np.int64)
        arrays[f"{name}.Q"] = np.array(Q)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def _load(cases: Path, name: str, device):
    import torch

    z = np.load(cases)
    t = tuple(torch.tensor(z[f"{name}.{f}"], device=device)
              for f in ("arrival", "need", "service", "kk"))
    return t, tuple(int(v) for v in z[f"{name}.NU"]), int(z[f"{name}.Q"])


def worker(cases: Path, out: Path) -> dict:
    """Times the importable tree's ``srpt_scan_fwd`` on every case and
    ``fig3_traces.run()`` on the scan policies, saves the outputs to
    ``out``."""
    import torch

    from repro_torch.kernels.msj_scan import kernel as K

    dev = torch.device("cuda", 0)
    res, outs = {}, {}
    for name, _, _, _, _ in CASES:
        t, NU, Q = _load(cases, name, dev)
        for sf in (True, False):
            key = f"{name}.{'sf' if sf else 'ff'}"
            o = K.srpt_scan_fwd(*t, Q=Q, NU=NU, sf=sf)
            torch.cuda.synchronize()
            for i, x in enumerate(o):
                outs[f"{key}.{i}"] = x.cpu().numpy()
            res[key] = device_ms(
                lambda: K.srpt_scan_fwd(*t, Q=Q, NU=NU, sf=sf), REPS)
    np.savez(out, **outs)
    from repro_torch.bench import fig3_traces

    scan = fig3_traces.SCAN_POLICIES       # the kernels' rows only
    fig3_traces.run(num_jobs=500, reps=2, ks=(512,), loads=(0.5,),
                    policies=scan, device="cuda")   # builds every kernel
    torch.cuda.synchronize()
    t0 = time.time()
    fig3_traces.run(policies=scan, device="cuda")
    torch.cuda.synchronize()
    res["fig3_s"] = time.time() - t0
    return res


def phases(cases: Path) -> dict:
    """SM cycles per event of each phase, from the stamped copy."""
    import ctypes

    import torch

    from repro_torch.kernels._build import Library, build_dir
    from repro_torch.kernels.msj_scan import build
    from repro_torch.kernels.msj_scan import kernel as K

    out = build_dir() / "srpt_bench"
    out.mkdir(parents=True, exist_ok=True)
    (out / "srpt_scan_stamped.cu").write_text(stamped_source())
    stamped = Library("msj_scan_stamped",
                      (build.SOURCES[0], out / "srpt_scan_stamped.cu"),
                      build.NVCC_FLAGS,
                      {**build.LIBRARY.sigs, "stamps_read": [ctypes.c_void_p]},
                      error_fn="msj_error_string")
    lib, plain = stamped.load(), build.LIBRARY.load()
    dev = torch.device("cuda", 0)
    res = {}
    for name, _, _, _, _ in CASES:
        t, NU, Q = _load(cases, name, dev)
        for sf in (True, False):
            def call():
                return K.srpt_scan_fwd(*t, Q=Q, NU=NU, sf=sf)

            ms = device_ms(call, REPS)
            build.LIBRARY._lib = lib       # the wrapper launches the copy
            ms_stamped = device_ms(call, REPS)
            o = call()
            torch.cuda.synchronize()
            build.LIBRARY._lib = plain
            cyc = np.zeros((MAX_R, len(PHASES) + 1), np.uint64)
            lib.stamps_read(cyc.ctypes.data)
            cyc = cyc[:R].astype(np.float64)
            events = int(o[5].sum())
            per = (cyc[:, :-1].sum(0) / events).tolist()
            res[f"{name}.{'sf' if sf else 'ff'}"] = dict(
                cycles_per_event=dict(zip(PHASES, per)),
                full_sorts=int(cyc[:, -1].sum()), ms_stamped=ms_stamped,
                ms=ms, events=events)
    return res


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--cases", type=Path, default=None,
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker is not None:
        print(json.dumps(worker(a.cases, a.worker)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("srpt_bench: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.bench import srpt_cases as C
    from repro_torch.kernels._build import build_dir

    here = Path(__file__).resolve()
    tree = here.parents[3]
    work = build_dir() / "srpt_bench"
    cases = work / "cases.npz"
    make_cases(cases)
    report = {"device": nvidia_smi(), "cases": {}}
    print(report["device"])

    def run(src_tree: Path, tag: str) -> dict:
        env = dict(os.environ, PYTHONPATH=str(src_tree / "src"))
        out = work / f"out-{tag}.npz"
        # this file drives the other tree's package: its own directory is
        # first on sys.path, the tree's src is the only package on it
        cmd = [sys.executable, str(here), "--worker", str(out), "--cases",
               str(cases)]
        p = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"{tag} worker failed:\n{p.stderr[-4000:]}")
        return json.loads(p.stdout.strip().splitlines()[-1])

    order = [("this", tree)]
    if a.parent is not None:
        order = [("parent", a.parent.resolve()), ("this", tree),
                 ("this", tree), ("parent", a.parent.resolve())]
    times: dict[str, list] = {}
    for i, (tag, src_tree) in enumerate(order):
        times.setdefault(tag, []).append(run(src_tree, f"{tag}{i}"))
    z = {tag: np.load(work / f"out-{tag}{i}.npz") for i, (tag, _) in
         enumerate(order)}
    if a.parent is not None:
        for key in z["this"].files:
            if not np.array_equal(z["this"][key], z["parent"][key]):
                print(f"srpt_bench: {key} differs between this tree and "
                      f"the parent", file=sys.stderr)
                return 1
        print("[bench] all 7 outputs of every case equal between the two "
              "trees (torch.equal)")
    for name, kind, k, Q, J in CASES:
        for pol in ("sf", "ff"):
            key = f"{name}.{pol}"
            n = C.jobs_in_system(z["this"][f"{key}.0"])
            row = dict(k=k, Q=Q, R=R, J=J, n_mean=float(n.mean()),
                       n_max=int(n.max()))
            line = (f"[bench] {name} {pol} k={k} Q={Q} R={R} J={J} "
                    f"(n per event mean {row['n_mean']:.1f}, max "
                    f"{row['n_max']}):")
            for tag, runs in times.items():
                ms = [r[key] for r in runs]
                row[f"{tag}_ms"] = ms
                m = float(np.mean(ms))
                line += (f" {tag} {m:.3f} ms ({m * 1e3 / (2 * J):.3f} us per "
                         f"event; runs {', '.join(f'{x:.3f}' for x in ms)})")
            if a.parent is not None:
                row["speedup"] = (np.mean(row["parent_ms"])
                                  / np.mean(row["this_ms"]))
                line += f"; parent / this {row['speedup']:.2f}x"
            report["cases"][key] = row
            print(line)
    for tag, runs in times.items():
        report[f"fig3_s_{tag}"] = [r["fig3_s"] for r in runs]
        walls = ", ".join(f"{r['fig3_s']:.2f}" for r in runs)
        print(f"[bench] fig3_traces.run() on the card, {tag}: {walls} s")
    if a.phases:
        ph = phases(cases)
        report["phases"] = ph
        for key, r in ph.items():
            cyc = r["cycles_per_event"]
            tot = sum(cyc.values())
            ns_per_cycle = r["ms_stamped"] * 1e6 * R / max(1, r["events"]) / tot
            print(f"[phases] {key}: {tot:.0f} SM cycles per event ("
                  + ", ".join(f"{p} {c:.0f} = {100 * c / tot:.1f}%"
                              for p, c in cyc.items())
                  + f"); {r['full_sorts']} of {r['events']} events fell "
                  f"back to the full sort; stamped copy "
                  f"{r['ms_stamped']:.3f} ms, kernel "
                  f"{r['ms']:.3f} ms, {ns_per_cycle:.3f} ns per cycle")
    print(report["device"])
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
