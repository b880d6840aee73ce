"""Time the FCFS and ModBS-π scans (``fcfs_scan``, ``modbs_scan`` and their
drain variants) on the card, beside another checkout's kernels, and say
where a step's time goes.

    PYTHONPATH=src python -m repro_torch.bench.fm_bench \\
        [--parent DIR] [--phases] [--out FILE]

Timed cases (:mod:`repro_torch.bench.fm_cases`, inputs made from
``SEED``), each through both scans:

* ``fig1_256``, ``fig1_1024``, ``fig1_2048`` — Fig. 1 at k = 256, 1024,
  2048, R = 16, J = 100 000 (θ = 0.7);
* ``sdsc``, ``kit`` — Fig. 3 SDSC-SP2 and KIT-FH2 at k = 1024, R = 4,
  J = 15 000, load 0.85;
* ``drain`` — the drain shape chip_smoke times: Fig. 1 at k = 2048,
  R = 16, J = 100 000 under bench_failures' outages (the fail kernels);

and the adversarial cases of ``fm_cases.ADVERSARIAL`` at J = 3000, R = 4
(named ``adv_<case>``; their times are printed per step, without the
host split or the phases).

Each tree runs in its own process (:mod:`.ab`): the mean device time of
``REPS`` calls per timed case and scan; the wall time of one Fig. 1
``engines.simulate`` call at k = 2048 for each of fcfs and modbs-fcfs,
split into trace upload, kernel, download, numpy assembly and the rest;
and each policy's summed ``sim_s`` over the Fig. 1 sweep, the Fig. 3
path and the drain sweep, run as chip_smoke runs them.  ``--parent DIR``
runs the checkout at DIR the same way on the same inputs, in the order
parent, this tree, this tree, parent, and requires the two trees' outputs
equal (``torch.equal``) on every case.  ``--phases`` builds, for each
tree, a copy of its ``csrc/msj_scan.cu`` with ``clock64`` stamps beside
the lines of the ``STAMPS`` table that matches it (it fails if none does)
and prints the SM cycles per step of each phase of both kernels beside
the call's time.  ``--out`` writes every number as JSON.  Card only.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

if __package__:
    from . import ab
    from .timing import device_ms
else:
    # a worker, run by path with another tree's package on PYTHONPATH: the
    # shared pieces are this tree's, from this file's directory
    import ab
    from timing import device_ms

TIMED = (  # name, kind, k, J, R
    ("fig1_256", "fig1", 256, 100_000, 16),
    ("fig1_1024", "fig1", 1024, 100_000, 16),
    ("fig1_2048", "fig1", 2048, 100_000, 16),
    ("sdsc", "sdsc", 1024, 15_000, 4),
    ("kit", "kit", 1024, 15_000, 4),
    ("drain", "drain", 2048, 100_000, 16),
)
KINDS = ("fcfs", "modbs")
ADV_J, ADV_R = 3000, 4
SEED, REPS = 0, 3

# Each kernel version's phases of a step and the lines that end them, per
# kernel: (line of csrc/msj_scan.cu, phase that ends there, stamp before
# the line?); ``done`` is where the counters are written (line, before
# it?).  "block" is the kernel of one block per replication (FCFS) and of
# per-step counts (ModBS); "run-length" the one-warp kernels on the
# run-length state and kept row minima.
_END_FCFS = ("}\n\n// -------------------------------------------------------"
             "--------------------\n// ModifiedBS-pi", True)
_END_MODBS = ("}\n\n// ------------------------------------------------------"
              "---------------------\n// BS-pi (Definition 1)", True)
STAMPS = {
    "block": {
        "fcfs_scan_kernel": dict(
            phases=("read and start", "count", "roll", "write and barrier"),
            init="  double t_prev = 0.0;\n  __syncthreads();\n",
            done=_END_FCFS,
            lines=(
                ("    int cnt = 0;\n", 0, True),
                ("    const int p = total - m;\n", 1, False),
                ("    if (tid == 0) out[j] = start;\n", 2, True),
                ("  }\n}\n", 3, True),
            )),
        "modbs_scan_kernel": dict(
            phases=("read and count", "argmin", "row and helper", "write"),
            init="  double t_prev = 0.0;\n  __syncwarp();\n",
            done=_END_MODBS,
            lines=(
                ("    const bool blocked = warp_count_gt(row, s_max, t) >= "
                 "s_max;\n", 0, False),
                ("    const int idx = warp_argmin(row, s_max, &rmin);\n", 1,
                 False),
                ("    if (lane == 0) {\n      blocked_out[off + j]", 2, True),
                ("  }\n}\n", 3, True),
            )),
    },
    "run-length": {
        "fcfs_scan_kernel": dict(
            phases=("read", "W[n-1] and start", "fold and insert", "record"),
            init="  double my_start = 0.0;\n",
            done=_END_FCFS,
            lines=(
                ("    const double svc = __shfl_sync(kFull, cur_s, src);\n",
                 0, False),
                ("    const double start = fmax(fmax(t, s.t_prev), "
                 "rs_nth(s, n - 1, &e_nth));\n", 1, False),
                ("      rs_commit(s, start, __dadd_rn(start, svc), n);\n", 2,
                 False),
                ("  }\n}\n", 3, True),
            )),
        "modbs_scan_kernel": dict(
            phases=("read", "row read and blocked", "helper start",
                    "row step", "helper step", "record"),
            init="  bool my_blocked = false;\n",
            done=_END_MODBS,
            lines=(
                ("    const double svc = __shfl_sync(kFull, cur_s, src);\n",
                 0, False),
                ("    const bool blocked = r0 > t;\n", 1, False),
                ("      start = fmax(fmax(t, s.t_prev), rs_nth(s, n - 1, "
                 "&e_nth));\n    }\n", 2, False),
                ("    if (helper_fail)\n", 3, True),
                ("      rs_commit(s, start, __dadd_rn(start, svc), n);\n", 4,
                 False),
                ("  }\n}\n", 5, True),
            )),
    },
}
_KERNEL = {"fcfs": "fcfs_scan_kernel", "modbs": "modbs_scan_kernel"}
#: ops functions charged to each part of one simulate call, per policy
_PARTS = {
    "fcfs": {"_fcfs_inputs": "upload", "fcfs_scan_fwd": "kernel",
             "_host": "download", "_fcfs_result": "assembly"},
    "modbs-fcfs": {"_class_inputs": "upload", "modbs_scan_fwd": "kernel",
                   "_host": "download", "_modbs_result": "assembly"},
}


def make_cases(path: Path) -> None:
    """Every case's inputs, made from ``SEED``, in one ``.npz`` at
    ``path``."""
    from repro_torch.bench import fm_cases as F

    cases = []
    for name, kind, k, J, R in TIMED:
        if kind == "fig1":
            cases.append(F.fig1_case(k, J, R, SEED, name=name))
        elif kind == "drain":
            cases.append(F.drain_case(k, J, R, SEED, name=name))
        else:
            cases.append(F.table_case(kind, k, J, R, SEED, name=name))
    for name, build in F.ADVERSARIAL.items():
        c = build(ADV_J, ADV_R, SEED)
        c.name = f"adv_{name}"
        cases.append(c)
    arrays = {}
    for c in cases:
        arrays.update({f"{c.name}.{f}": x for f, x in c.arrays().items()})
    arrays["names"] = np.array([c.name for c in cases])
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def _load(cases: Path, device) -> dict:
    """Every case of ``cases`` as plain tensors on ``device``: name ->
    dict(fcfs=tuple, modbs=tuple, slots, k, s_max, h, drain)."""
    import torch

    z = np.load(cases)
    out = {}
    for name in z["names"]:
        def T(f):
            return torch.tensor(z[f"{name}.{f}"], device=device)
        width = 5 if bool(z[f"{name}.drain"]) else 3
        out[str(name)] = dict(
            fcfs=tuple(T(f"fcfs{i}") for i in range(width)),
            modbs=tuple(T(f"modbs{i}") for i in range(width + 1)),
            slots=T("slots"), k=int(z[f"{name}.k"]),
            s_max=int(z[f"{name}.s_max"]), h=int(z[f"{name}.h"]),
            drain=bool(z[f"{name}.drain"]))
    return out


def _caller(K, c: dict, kind: str):
    if kind == "fcfs":
        fn = K.fcfs_fail_scan_fwd if c["drain"] else K.fcfs_scan_fwd
        return lambda: (fn(*c["fcfs"], k=c["k"]),)
    fn = K.modbs_fail_scan_fwd if c["drain"] else K.modbs_scan_fwd
    return lambda: fn(*c["modbs"], c["slots"], s_max=c["s_max"], h=c["h"])


def worker(cases: Path, out: Path) -> dict:
    """Times the importable tree's wrappers on every timed case, splits a
    Fig. 1 call of each policy and sums the paths' ``sim_s``; saves every
    case's outputs to ``out``."""
    import torch

    from repro_torch.core.workload import figure1_workload
    from repro_torch.kernels.msj_scan import kernel as K

    dev = torch.device("cuda", 0)
    res, outs = {}, {}
    for name, c in _load(cases, dev).items():
        for kind in KINDS:
            call = _caller(K, c, kind)
            o = call()
            torch.cuda.synchronize()
            for i, x in enumerate(o):
                outs[f"{name}.{kind}.{i}"] = x.cpu().numpy()
            res[f"{name}.{kind}"] = device_ms(call, REPS)
    np.savez(out, **outs)
    wl = figure1_workload(2048)
    batch = wl.sample_traces(100_000, 16, seed=SEED)
    res["host_split"] = {pol: ab.host_split(pol, batch, wl, dev, parts)
                         for pol, parts in _PARTS.items()}
    res["paths"] = ab.paths_sim_s(tuple(_PARTS), dev)
    return res


def phases(cases: Path) -> dict:
    """SM cycles per step of each phase of both kernels, from a stamped
    copy of the importable tree's source (the ``STAMPS`` version it
    matches)."""
    import torch

    from repro_torch.kernels.msj_scan import kernel as K

    lib, plain, version = ab.stamped_library(STAMPS, "fm_bench")
    dev = torch.device("cuda", 0)
    res = {"version": version}
    data = _load(cases, dev)
    for name, _, _, _, R in TIMED:
        c = data[name]
        for kind in KINDS:
            res[f"{name}.{kind}"] = ab.stamped_cycles(
                lib, plain, _caller(K, c, kind), REPS, R,
                c[kind][0].shape[1],
                STAMPS[version][_KERNEL[kind]]["phases"])
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
    ap.add_argument("--stamps", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker is not None:
        print(json.dumps(worker(a.cases, a.worker)))
        return 0
    if a.stamps:
        print(json.dumps(phases(a.cases)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("fm_bench: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels._build import build_dir

    here = Path(__file__).resolve()
    tree = here.parents[3]
    work = build_dir() / "fm_bench"
    cases = work / "cases.npz"
    make_cases(cases)
    report = {"device": ab.nvidia_smi(), "cases": {}}
    print(report["device"], flush=True)
    parent = a.parent.resolve() if a.parent is not None else None
    times, z = ab.run_trees(here, cases, work, parent, tree)
    if parent is not None:
        key = ab.first_difference(z)
        if key is not None:
            print(f"fm_bench: {key} differs between this tree and the "
                  f"parent", file=sys.stderr)
            return 1
        print(f"[bench] every output of both scans on every case "
              f"({len(z['this'].files)} arrays) equal between the two trees "
              f"(torch.equal)")
    data = _load(cases, "cpu")
    for name, _, k, J, R in TIMED:
        c = data[name]
        for kind in KINDS:
            steps = c[kind][0].shape[1]
            row = dict(k=k, J=J, R=R, steps=steps, C=int(c["slots"].numel()),
                       s_max=c["s_max"], h=c["h"])
            line = (f"[bench] {kind} {name} k={k} R={R} J={J} "
                    f"steps={steps}" + (f" C={row['C']} s_max={c['s_max']} "
                                        f"h={c['h']}" if kind == "modbs"
                                        else "") + ":")
            for tag, runs in times.items():
                ms = [r[f"{name}.{kind}"] for r in runs]
                row[f"{tag}_ms"] = ms
                m = float(np.mean(ms))
                line += (f" {tag} {m:.3f} ms ({m * 1e3 / steps:.4f} us per "
                         f"step; runs {', '.join(f'{x:.3f}' for x in ms)})")
            if parent is not None:
                row["speedup"] = (np.mean(row["parent_ms"])
                                  / np.mean(row["this_ms"]))
                line += f"; parent / this {row['speedup']:.3f}x"
            report["cases"][f"{name}.{kind}"] = row
            print(line)
    for name in (n for n in data if n.startswith("adv_")):
        c = data[name]
        for kind in KINDS:
            steps = c[kind][0].shape[1]
            us = {tag: float(np.mean([r[f"{name}.{kind}"] for r in runs]))
                  * 1e3 / steps for tag, runs in times.items()}
            report["cases"][f"{name}.{kind}"] = dict(steps=steps,
                                                    us_per_step=us)
            print(f"[bench] {kind} {name} k={c['k']} R={c[kind][0].shape[0]}"
                  f" steps={steps}: " + ", ".join(
                      f"{tag} {u:.4f} us per step" for tag, u in us.items()))
    for tag, runs in times.items():
        report[f"paths_{tag}"] = [{f: r[f] for f in ("host_split", "paths")}
                                  for r in runs]
        for r in runs:
            for pol, hs in r["host_split"].items():
                print(f"[host] {tag}: Fig. 1 {pol} simulate k=2048 J=100000 "
                      f"R=16: {hs['total']:.4f} s = upload "
                      f"{hs['upload']:.4f} + kernel {hs['kernel']:.4f} + "
                      f"download {hs['download']:.4f} + numpy assembly "
                      f"{hs['assembly']:.4f} + other {hs['other']:.4f}")
            for pol, p in r["paths"].items():
                print(f"[paths] {tag}: {pol} sim_s Fig. 1 (k 256, 1024, 2048) "
                      f"{', '.join(f'{x:.3f}' for x in p['fig1_sim_s'])} "
                      f"(summed {sum(p['fig1_sim_s']):.3f}; sweep wall "
                      f"{p['fig1_wall_s']:.3f} s); Fig. 3 summed "
                      f"{p['fig3_sim_s']:.3f}; drain (k 256, 1024) "
                      f"{', '.join(f'{x:.3f}' for x in p['drain_sim_s'])}")
    if a.phases:
        report["phases"] = {}
        vers = [("this", tree)]
        if parent is not None:
            vers.insert(0, ("parent", parent))
        for tag, src_tree in vers:
            ph = ab.run_worker(here, src_tree, cases, "--stamps")
            report["phases"][tag] = ph
            for key, r in ph.items():
                if key == "version":
                    continue
                cyc = r["cycles_per_step"]
                tot = sum(cyc.values())
                ns = r["ms_stamped"] * 1e6 / r["steps"] / tot
                print(f"[phases] {tag} ({ph['version']}) {key}: {tot:.0f} SM "
                      f"cycles per step ("
                      + ", ".join(f"{p} {c:.0f} = {100 * c / tot:.1f}%"
                                  for p, c in cyc.items())
                      + f"); stamped copy {r['ms_stamped']:.3f} ms, kernel "
                      f"{r['ms']:.3f} ms, {ns:.3f} ns per cycle")
    print(report["device"])
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
