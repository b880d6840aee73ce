"""Time the BS-π scan (``bs_scan`` and ``bs_fail_scan``) on the card,
beside another checkout's kernel, and say where a step's time goes.

    PYTHONPATH=src python -m repro_torch.bench.bs_bench \\
        [--parent DIR] [--phases] [--out FILE]

Timed cases (:mod:`repro_torch.bench.bs_cases`, inputs made from
``SEED``):

* ``fig1`` — Fig. 1 at k = 2048, R = 16, J = 100 000 (θ = 0.7; C = 4,
  s_max = 24, h = 128, q_cap = 8192);
* ``sdsc``, ``kit`` — Fig. 3 SDSC-SP2 and KIT-FH2 at k = 1024, R = 4,
  J = 15 000, load 0.85 (KIT-FH2: slots (5, 0, 1, 0, 1, 11, 9), h = 71);
* ``drain`` — the drain shape chip_smoke times: Fig. 1 at k = 2048,
  R = 16, J = 100 000 under bench_failures' outages, q_cap = J;

and, for equality only, the adversarial cases of ``bs_cases.ADVERSARIAL``
at J = 3000, R = 4 (named ``adv_<case>``).

Each tree runs in its own process: the mean device time of ``REPS``
calls per timed case, and the wall time of one Fig. 1 bs-fcfs
``engines.simulate`` call at k = 2048 split into trace upload, kernel,
download, numpy assembly and the rest (partition, validation), with the
card synchronised at each boundary; and the summed bs-fcfs ``sim_s`` of
the Fig. 1 sweep, the Fig. 3 path and the drain sweep, run as chip_smoke
runs them.  ``--parent DIR`` runs the checkout at DIR (for example ``git
archive`` of the parent commit unpacked there) the same way on the same
inputs, in the order parent, this tree, this tree, parent, and requires
the two trees' three outputs to be equal (``torch.equal``) on every case.
``--phases`` builds, for each tree, a copy of its ``csrc/msj_scan.cu``
with ``clock64`` stamps inserted beside the lines of the ``STAMPS``
table that matches it (one per kernel version; it fails if none does)
and prints the SM cycles per scan step of each of that version's phases
beside the call's time.  ``--out`` writes every number as JSON.  Card
only.
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
    # shared pieces are this tree's, from this file's directory (first on
    # sys.path)
    import ab
    from timing import device_ms

TIMED = (  # name, kind, k, J, R
    ("fig1", "fig1", 2048, 100_000, 16),
    ("sdsc", "sdsc", 1024, 15_000, 4),
    ("kit", "kit", 1024, 15_000, 4),
    ("drain", "drain", 2048, 100_000, 16),
)
ADV_J, ADV_R = 3000, 4
SEED, REPS = 0, 3

# Each kernel version's phases of a step and the lines that end them:
# (line of csrc/msj_scan.cu, phase that ends there, stamp before the
# line?).  The last stamp closes the step.  "global-reads" is the kernel
# that read the trace and the rings from global memory at each step and
# ran every phase at every step; "branches" the kernel with one branch
# per event type after the decision (a phase is charged only on the steps
# that run it; "drain" also holds the exits from the branches).
STAMPS = {
    "global-reads": {"bs_scan_kernel": dict(
        phases=("decide", "arrival", "comp write", "helper commit",
                "counters, heads and ring", "record write"),
        init="  bool ovf = false;\n  __syncwarp();\n",
        done=("  if (lane == 0) ovf_out[blockIdx.x] = ovf;\n", False),
        lines=(
            ("    if constexpr (kDrain) is_arr = is_arr && ai < J;\n", 0,
             False),
            ("    const int pos = has_slot ? warp_argmax(comp + c_arr * "
             "s_max, s_max) : 0;\n", 1, False),
            ("    // helper commit: the global head starts on H at Th (pi = "
             "FCFS)\n", 2, True),
            ("    // counters, then the per-class head jobs\n", 3, True),
            ("      tagged[e] = is_commit ? jh + 2 * J\n", 4, True),
            ("      rec_t[e] = is_commit ? Th : t_ins;\n    }\n"
             "    __syncwarp();\n", 5, False),
        ))},
    "branches": {"bs_scan_kernel": dict(
        phases=("decide", "arrival", "completion", "helper commit", "drain",
                "record write"),
        init="  bool ovf = false;\n  __syncwarp();\n",
        done=("  if (lane == 0) ovf_out[blockIdx.x] = ovf;\n", False),
        lines=(
            ("    // -- arrival (rule 1): a free A_i slot starts the job, else "
             "it enqueues\n", 0, True),
            ("    // -- A completion: rule 3 pulls the class head into the "
             "freed slot\n", 1, True),
            ("    // -- helper commit: the global head starts on H at Th (pi "
             "= FCFS)\n", 2, True),
            ("    // -- drain mode: the breakdown claims the earliest-free "
             "unit of its\n", 3, True),
            ("    // -- record: lane e % 32 keeps step e's, stored 32 steps at "
             "a time\n", 4, True),
            ("  }\n  if (lane == 0) ovf_out[blockIdx.x] = ovf;\n", 5, True),
        ))},
}
# the kernel with a carried (stream) entry reads ovf from the carry
STAMPS["carried"] = {"bs_scan_kernel": dict(
    STAMPS["branches"]["bs_scan_kernel"],
    init="  bool ovf = kStream ? ovf_out[b] : false;\n  __syncwarp();\n")}


def make_cases(path: Path) -> None:
    """Every case's inputs, made from ``SEED``, in one ``.npz`` at
    ``path``."""
    from repro_torch.bench import bs_cases as B

    cases = []
    for name, kind, k, J, R in TIMED:
        if kind == "fig1":
            cases.append(B.fig1_case(k, J, R, SEED, name=name))
        elif kind == "drain":
            cases.append(B.drain_case(k, J, R, SEED, name=name))
        else:
            cases.append(B.table_case(kind, k, J, R, SEED, name=name))
    for name, build in B.ADVERSARIAL.items():
        c = build(ADV_J, ADV_R, SEED)
        c.name = f"adv_{name}"
        cases.append(c)
    arrays = {}
    for c in cases:
        arrays.update({f"{c.name}.{f}": x for f, x in c.arrays().items()})
    arrays["names"] = np.array([c.name for c in cases])
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def _load(cases: Path, device):
    """Every case of ``cases``, rebuilt as plain tensors on ``device``:
    name -> (trace, frec, slots, kw)."""
    import torch

    z = np.load(cases)
    out = {}
    for name in z["names"]:
        def T(f):
            return torch.tensor(z[f"{name}.{f}"], device=device)
        kw = dict(s_max=int(z[f"{name}.s_max"]), h=int(z[f"{name}.h"]),
                  q_cap=int(z[f"{name}.q_cap"]))
        frec = None
        if f"{name}.ft" in z.files:
            frec = tuple(T(f) for f in ("ft", "ftgt", "fup"))
            kw["length"] = int(z[f"{name}.length"])
        out[str(name)] = (tuple(T(f) for f in ("arrival", "cls", "need",
                                               "service")),
                          frec, T("slots"), kw)
    return out


def _caller(K, trace, frec, slots, kw):
    if frec is None:
        return lambda: K.bs_scan_fwd(*trace, slots, **kw)
    return lambda: K.bs_fail_scan_fwd(*trace, *frec, slots, **kw)


def host_split(device) -> dict:
    """Wall seconds of one Fig. 1 bs-fcfs ``engines.simulate`` call at
    k = 2048, J = 100 000, R = 16, split at synchronised boundaries into
    trace upload, kernel, download and numpy assembly (the rest: the
    partition and validation)."""
    from repro_torch.core.workload import figure1_workload

    wl = figure1_workload(2048)
    batch = wl.sample_traces(100_000, 16, seed=SEED)
    return ab.host_split("bs-fcfs", batch, wl, device, {
        "_class_inputs": "upload", "bs_scan_fwd": "kernel",
        "_host": "download", "_bs_result": "assembly"})


def worker(cases: Path, out: Path) -> dict:
    """Times the importable tree's BS wrappers on every timed case, splits
    a Fig. 1 call and sums the paths' ``sim_s``; saves every case's
    outputs to ``out``."""
    import torch

    from repro_torch.kernels.msj_scan import kernel as K

    dev = torch.device("cuda", 0)
    res, outs = {}, {}
    timed = {name for name, *_ in TIMED}
    for name, (trace, frec, slots, kw) in _load(cases, dev).items():
        call = _caller(K, trace, frec, slots, kw)
        o = call()
        torch.cuda.synchronize()
        for i, x in enumerate(o):
            outs[f"{name}.{i}"] = x.cpu().numpy()
        if name in timed:
            res[name] = device_ms(call, REPS)
    np.savez(out, **outs)
    res["host_split"] = host_split(dev)
    res.update(ab.paths_sim_s(("bs-fcfs",), dev)["bs-fcfs"])
    return res


def phases(cases: Path) -> dict:
    """SM cycles per step of each phase, from a stamped copy of the
    importable tree's kernel (the ``STAMPS`` table its source matches)."""
    import torch

    from repro_torch.kernels.msj_scan import kernel as K

    lib, plain, version = ab.stamped_library(STAMPS, "bs_bench")
    dev = torch.device("cuda", 0)
    res = {}
    data = _load(cases, dev)
    for name, _, _, _, R in TIMED:
        trace, frec, slots, kw = data[name]
        res[name] = ab.stamped_cycles(
            lib, plain, _caller(K, trace, frec, slots, kw), REPS, R,
            kw.get("length", 2 * trace[0].shape[1]),
            STAMPS[version]["bs_scan_kernel"]["phases"])
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
        print("bs_bench: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels._build import build_dir

    here = Path(__file__).resolve()
    tree = here.parents[3]
    work = build_dir() / "bs_bench"
    cases = work / "cases.npz"
    make_cases(cases)
    report = {"device": ab.nvidia_smi(), "cases": {}}
    print(report["device"])
    parent = a.parent.resolve() if a.parent is not None else None
    times, z = ab.run_trees(here, cases, work, parent, tree)
    if parent is not None:
        key = ab.first_difference(z)
        if key is not None:
            print(f"bs_bench: {key} differs between this tree and the "
                  f"parent", file=sys.stderr)
            return 1
        n_cases = len(z["this"].files) // 3
        print(f"[bench] all 3 outputs of every case ({n_cases} cases) equal "
              f"between the two trees (torch.equal)")
    data = _load(cases, "cpu")
    for name, _, k, J, R in TIMED:
        trace, frec, slots, kw = data[name]
        steps = kw.get("length", 2 * J)
        row = dict(k=k, J=J, R=R, steps=steps, C=int(slots.numel()),
                   s_max=kw["s_max"], h=kw["h"], q_cap=kw["q_cap"])
        line = (f"[bench] {name} k={k} R={R} J={J} C={row['C']} "
                f"s_max={kw['s_max']} h={kw['h']} q_cap={kw['q_cap']} "
                f"steps={steps}:")
        for tag, runs in times.items():
            ms = [r[name] for r in runs]
            row[f"{tag}_ms"] = ms
            m = float(np.mean(ms))
            line += (f" {tag} {m:.3f} ms ({m * 1e3 / steps:.4f} us per step;"
                     f" runs {', '.join(f'{x:.3f}' for x in ms)})")
        if a.parent is not None:
            row["speedup"] = (np.mean(row["parent_ms"])
                              / np.mean(row["this_ms"]))
            line += f"; parent / this {row['speedup']:.3f}x"
        report["cases"][name] = row
        print(line)
    for tag, runs in times.items():
        report[f"paths_{tag}"] = [
            {f: r[f] for f in ("host_split", "fig1_wall_s", "fig1_sim_s",
                               "fig3_sim_s", "drain_sim_s")} for r in runs]
        for r in runs:
            hs = r["host_split"]
            print(f"[host] {tag}: Fig. 1 bs-fcfs simulate k=2048 J=100000 "
                  f"R=16: {hs['total']:.4f} s = upload {hs['upload']:.4f} + "
                  f"kernel {hs['kernel']:.4f} + download "
                  f"{hs['download']:.4f} + numpy assembly "
                  f"{hs['assembly']:.4f} + other {hs['other']:.4f}")
            print(f"[paths] {tag}: bs-fcfs sim_s Fig. 1 (k 256, 1024, 2048) "
                  f"{', '.join(f'{x:.3f}' for x in r['fig1_sim_s'])} "
                  f"(sweep wall {r['fig1_wall_s']:.3f} s); Fig. 3 summed "
                  f"{r['fig3_sim_s']:.2f}; drain (k 256, 1024) "
                  f"{', '.join(f'{x:.3f}' for x in r['drain_sim_s'])}")
    if a.phases:
        report["phases"] = {}
        vers = [("this", tree)]
        if a.parent is not None:
            vers.insert(0, ("parent", a.parent.resolve()))
        for tag, src_tree in vers:
            ph = ab.run_worker(here, src_tree, cases, "--stamps")
            report["phases"][tag] = ph
            for name, r in ph.items():
                cyc = r["cycles_per_step"]
                tot = sum(cyc.values())
                ns = r["ms_stamped"] * 1e6 / r["steps"] / tot
                print(f"[phases] {tag} {name}: {tot:.0f} SM cycles per step ("
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
