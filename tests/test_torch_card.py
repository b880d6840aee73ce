"""Card only: every hand-written CUDA kernel of the port against its plain
PyTorch version on the card.

This file imports neither ``jax`` nor the reference package (``repro``),
so it runs on a machine with a card and no JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_card.py

Its inputs come from the port (``repro_torch.core.workload``,
``bench.srpt_cases``, ``bench.bs_cases``, ``bench.stream_cases``) and
numpy, at the shapes and limits of the parity files
(``tests/test_torch_{msj_scan, failures, srpt, stream, attention, moe,
mamba, rwkv}.py``), which hold the plain versions to the reference on the
CPU.  The scan kernels are also held to the port's event engine
(``engine="python"``), which shares no code with them or their plain
versions.  Without a card every test here but the import pin skips.
"""

import dataclasses
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bench import (bs_cases, fm_cases, loss_cases, srpt_cases,
                               stream_cases)
from repro_torch.core import failures as flr
from repro_torch.core import (engines, partition, sim_batch, sim_torch,
                              stream, theory, workload)
from repro_torch.core.sim_torch import _bs_args
from repro_torch.kernels import msj_scan
from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_ref)
from repro_torch.kernels.mamba_scan import (mamba_scan_fused,
                                            mamba_scan_fused_ref,
                                            mamba_scan_fwd, mamba_scan_ref)
from repro_torch.kernels.moe_gmm import gmm, gmm_ref
from repro_torch.kernels.moe_gmm.kernel import _gmm_route
from repro_torch.kernels.msj_scan import kernel as K
from repro_torch.kernels.rwkv6 import wkv_chunked_ref, wkv_fwd

ROOT = Path(__file__).resolve().parents[1]
J, R = 300, 2


def _dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _equal(out, ref, what):
    assert len(out) == len(ref), what
    for o, r in zip(out, ref):
        assert torch.equal(o.cpu(), r), what


# -- the imports -------------------------------------------------------------


_PURITY = """
import sys
sys.path.insert(0, {tests!r})
import test_torch_card  # noqa: F401
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""


def test_card_file_imports_nothing_of_jax_or_the_reference():
    """Importing this file loads no ``jax`` and no ``repro`` module, and
    no import line of it names either: the card's machine has no JAX."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PURITY.format(tests=str(ROOT / "tests"))],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    for line in Path(__file__).read_text().splitlines():
        s = line.strip()
        assert not s.startswith(("import jax", "from jax")), s
        if s.startswith(("import repro", "from repro")):
            mod = s.split()[1]
            assert mod == "repro_torch" or mod.startswith("repro_torch."), s


# -- msj_scan (tests/test_torch_msj_scan.py's shapes) ------------------------


def _msj_case(k, seed=21):
    wl = workload.figure1_workload(k)
    b = wl.sample_traces(J, R, seed=seed)
    slots, s_max, h, q_cap = _bs_args(b, None, wl, None)
    targs = (torch.tensor(b.arrival), torch.tensor(b.cls, dtype=torch.int32),
             torch.tensor(b.need, dtype=torch.int32), torch.tensor(b.service),
             torch.tensor(slots, dtype=torch.int32))
    return targs, s_max, h, q_cap


def _msj_port(name, targs, k, s_max, h, q_cap):
    a, c, n, v, sl = targs
    if name == "fcfs":
        return (msj_scan.fcfs_scan_fwd(a, n, v, k=k),)
    if name == "modbs":
        return msj_scan.modbs_scan_fwd(a, c, n, v, sl, s_max=s_max, h=h)
    return msj_scan.bs_scan_fwd(a, c, n, v, sl, s_max=s_max, h=h,
                                q_cap=q_cap)


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions_on_the_card():
    """Each msj_scan CUDA kernel against its plain version, rtol=0."""
    dev = _dev()
    for k in (32, 256):
        targs, s_max, h, q_cap = _msj_case(k)
        gargs = tuple(t.to(dev) for t in targs)
        for name in ("fcfs", "modbs", "bs"):
            out = _msj_port(name, gargs, k, s_max, h, q_cap)
            ref = _msj_port(name, targs, k, s_max, h, q_cap)
            _equal(out, ref, (name, k))


# -- the BS-pi scan on the adversarial cases (bench/bs_cases.py) -------------


BS_J, BS_R = 2000, 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(bs_cases.ADVERSARIAL))
def test_cuda_bs_scan_equals_plain_version_on_adversarial_cases(name):
    """``bs_scan`` / ``bs_fail_scan`` against the plain version on every
    raw output, rtol=0: wrapping and overflowing rings, KIT-FH2's long
    helper queues, tied events, SDSC-SP2's seven classes, heavy drains."""
    dev = _dev()
    case = bs_cases.ADVERSARIAL[name](BS_J, BS_R, 5)
    ref = bs_cases.scan_ref(case)
    before = K.launches()
    out = bs_cases.scan(case.to(dev), K)
    wrapper = "bs_scan_fwd" if case.frec is None else "bs_fail_scan_fwd"
    assert K.launches()[wrapper] == before[wrapper] + 1
    _equal(out, ref, name)
    if name == "wrap":
        assert ref[2].any() and not ref[2].all()


@pytest.mark.cuda
@pytest.mark.parametrize("q_cap", [1, 2, 3])
def test_cuda_bs_scan_equals_plain_version_on_tiny_rings(q_cap):
    """Rings of one to three entries: every enqueue past the head writes
    the entry a pop reads next, and most overflow."""
    dev = _dev()
    case = bs_cases.fig1_case(64, 1000, BS_R, 3, queue_cap=q_cap)
    _equal(bs_cases.scan(case.to(dev), K), bs_cases.scan_ref(case), q_cap)


@pytest.mark.cuda
def test_cuda_bs_scan_equals_plain_version_with_many_classes():
    """C = 40 > 32 classes (the kernel's other path for the ring entry
    after a pop), with empty classes, and the drain scan at C = 40."""
    dev = _dev()
    rng = np.random.default_rng(0)
    Rr, Jj, C = 3, 800, 40
    sl = torch.tensor(rng.integers(0, 3, C), dtype=torch.int32)
    trace = (torch.tensor(np.cumsum(rng.exponential(0.05, (Rr, Jj)), 1)),
             torch.tensor(rng.integers(0, C, (Rr, Jj)), dtype=torch.int32),
             torch.tensor(rng.integers(1, 5, (Rr, Jj)), dtype=torch.int32),
             torch.tensor(np.ceil(rng.exponential(1.0, (Rr, Jj)) * 4) / 4))
    case = bs_cases.BSCase("c40", trace, sl, int(sl.max()), 8, 64)
    _equal(bs_cases.scan(case.to(dev), K), bs_cases.scan_ref(case), "clean")
    F = 30
    ft = np.sort(rng.uniform(0, float(trace[0].max()), (Rr, F)), 1)
    frec = (torch.tensor(ft), torch.tensor(rng.integers(0, C + 1, (Rr, F)),
                                           dtype=torch.int32),
            torch.tensor(ft + rng.exponential(2.0, (Rr, F))))
    case = bs_cases.BSCase("c40 drain", trace, sl, int(sl.max()), 8, Jj,
                           frec, 2 * Jj + 2 * F)
    _equal(bs_cases.scan(case.to(dev), K), bs_cases.scan_ref(case), "drain")


# -- FCFS and ModBS-pi on the adversarial cases (bench/fm_cases.py) ---------


FM_J, FM_R = 2000, 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(fm_cases.ADVERSARIAL))
def test_cuda_fcfs_and_modbs_equal_plain_versions_on_adversarial_cases(name):
    """``fcfs_scan`` / ``modbs_scan`` (or their drain variants) against the
    plain versions on every raw output, rtol=0: ties, zero services, jobs
    needing every server, k in {1, 7, 33, 1000}, a group per server, rows
    wider than 32, classes with no slots, a helper of one server, drains
    below, between and above the last start, padding rows."""
    dev = _dev()
    case = fm_cases.ADVERSARIAL[name](FM_J, FM_R, 5)
    gcase = case.to(dev)
    for kind in ("fcfs", "modbs"):
        ref = fm_cases.scan_ref(case, kind)
        wrapper = f"{kind}_{'fail_' if case.drain else ''}scan_fwd"
        before = K.launches()
        out = fm_cases.scan(gcase, kind, K)
        assert K.launches()[wrapper] == before[wrapper] + 1
        _equal(out, ref, (name, kind))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [14_526, K.FCFS_K_MAX])
def test_cuda_fcfs_at_the_largest_k(k):
    """FCFS at the largest k the block-per-replication kernel took
    (14 526) and at ``FCFS_K_MAX``, clean and drain; one server more is
    refused before launch."""
    dev = _dev()
    rng = np.random.default_rng(k)
    Rr, Jj = 2, 400
    a = torch.tensor(np.floor(np.cumsum(rng.exponential(0.02, (Rr, Jj)), 1)
                              * 4) / 4)
    n = torch.tensor(rng.integers(1, k + 1, (Rr, Jj)), dtype=torch.int32)
    v = torch.tensor(np.ceil(rng.exponential(3.0, (Rr, Jj)) * 4) / 4)
    tu = torch.where(torch.rand(Rr, Jj, generator=torch.Generator()
                                .manual_seed(k)) < 0.2, a + 2.0, 0.0)
    isf = tu > 0
    args = (a, n, v)
    _equal((K.fcfs_scan_fwd(*(x.to(dev) for x in args), k=k),),
           (K.fcfs_scan_ref(*args, k=k),), k)
    fargs = (a, n, v, tu, isf)
    _equal((K.fcfs_fail_scan_fwd(*(x.to(dev) for x in fargs), k=k),),
           (K.fcfs_fail_scan_ref(*fargs, k=k),), (k, "drain"))
    with pytest.raises(ValueError, match="exceeds"):
        K.fcfs_scan_fwd(*(x.to(dev) for x in args), k=K.FCFS_K_MAX + 1)


# -- carried (stream) kernels (tests/test_torch_stream.py's shapes) ----------


STREAM_J, STREAM_CHUNK = 600, 250      # chunks of 250, 250 and a ragged 100
FM_STREAMABLE = sorted(n for n, make in fm_cases.ADVERSARIAL.items()
                       if not make(8, 1, 0).drain)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FM_STREAMABLE)
def test_cuda_fcfs_and_modbs_streams_equal_plain_versions(name):
    """The carried FCFS and ModBS-pi kernels, chunk after chunk, give the
    plain versions' outputs and canonical carries exactly; ``bursts``
    carries more than 128 run-length groups across a boundary (the shared
    spill)."""
    dev = _dev()
    case = fm_cases.ADVERSARIAL[name](STREAM_J, 2, 1)
    g = case.to(dev)
    cuts = stream_cases.bounds(STREAM_J, STREAM_CHUNK)
    kern = stream_cases.fcfs_chunks(K.fcfs_stream_fwd, *g.fcfs, case.k,
                                    cuts)
    plain = stream_cases.fcfs_chunks(K.fcfs_stream_ref, *case.fcfs, case.k,
                                     cuts)
    stream_cases.equal_chunks(kern, plain, f"fcfs_stream_scan {name}")
    if name == "bursts":
        assert max(stream_cases.groups_above(W, tp)
                   for _, W, tp in plain) > 128
    kern = stream_cases.modbs_chunks(K.modbs_stream_fwd, *g.modbs, g.slots,
                                     case.s_max, case.h, cuts)
    plain = stream_cases.modbs_chunks(K.modbs_stream_ref, *case.modbs,
                                      case.slots, case.s_max, case.h, cuts)
    stream_cases.equal_chunks(kern, plain, f"modbs_stream_scan {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fig1"] + sorted(
    stream_cases.BS_STREAMABLE))
def test_cuda_bs_stream_equals_plain_version(name):
    """The carried BS-pi kernel, chunk after chunk, gives the plain
    version's event streams, carry and canonical state exactly; on the
    Fig. 1 trace a backlog crosses a chunk boundary."""
    dev = _dev()
    if name == "fig1":
        wl = workload.figure1_workload(32)
        b = wl.sample_traces(STREAM_J, 2, seed=3)
    else:
        b, wl = stream_cases.bs_case_batch(name, STREAM_J, 2, 5)
    _, slots, s_max, h, q_cap, B = stream._bs_stream_args(
        None, wl, STREAM_CHUNK, None, 256)
    cuts = stream_cases.bounds(STREAM_J, STREAM_CHUNK)
    kern = stream_cases.bs_chunks(K.bs_stream_fwd, b, slots, s_max, h,
                                  q_cap, B, cuts, dev)
    plain = stream_cases.bs_chunks(K.bs_stream_ref, b, slots, s_max, h,
                                   q_cap, B, cuts, "cpu")
    stream_cases.equal_chunks(kern, plain, f"bs_stream_scan {name}")
    if name == "fig1":
        assert max(int(c[-1]["pend_n"].max()) for c in plain[:-1]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pol", ["fcfs", "modbs-fcfs", "bs-fcfs"])
def test_cuda_stream_equals_folded_batch_and_resumes_a_cpu_checkpoint(
        pol, tmp_path):
    """``simulate_stream`` on the card launches its kernel once a chunk,
    equals ``stream_fold(simulate(...))`` on the card bit for bit, and
    resumes a stream checkpointed on the CPU to the same bytes."""
    _dev()
    wl = workload.figure1_workload(32)
    b = wl.sample_traces(STREAM_J, 2, seed=3)
    kw = dict(chunk_jobs=170, wl=wl,
              **({"backlog_cap": 48} if pol == "bs-fcfs" else {}))
    fold = stream.stream_fold(engines.simulate(pol, b, wl=wl))
    msj_scan.reset_launches()
    got = engines.simulate_stream(pol, b, **kw)
    name = {"fcfs": "fcfs", "modbs-fcfs": "modbs",
            "bs-fcfs": "bs"}[pol] + "_stream_fwd"
    assert msj_scan.launches()[name] == 4
    d = str(tmp_path / "ckpt")
    engines.simulate_stream(pol, b, device="cpu", ckpt_dir=d, **kw)
    last = sorted(e for e in os.listdir(d) if e.startswith("step_"))[-1]
    shutil.rmtree(os.path.join(d, last))
    res = engines.simulate_stream(pol, b, ckpt_dir=d, resume=True, **kw)
    for f in ("mean_response", "var_response", "mean_wait", "var_wait",
              "p_wait", "p_helper", "p_routed"):
        x, y, z = (getattr(r, f) for r in (got, fold, res))
        assert (x is None) == (y is None) == (z is None), f
        if x is not None:
            assert x.tobytes() == y.tobytes() == z.tobytes(), f


# -- drain-mode kernels (tests/test_torch_failures.py's shapes) --------------


def _small_workload(k=32, load=0.8):
    """``tests/test_failures.py``'s three-class workload."""
    classes = (workload.JobClass("s", 1, workload.Exp(1.0), 0.7),
               workload.JobClass("m", 4, workload.Exp(4.0), 0.2),
               workload.JobClass("l", 8, workload.Exp(8.0), 0.1))
    return workload.Workload(k=k, lam=1.0, classes=classes).with_load(load)


def _fail_case(k, seed=11):
    """test_torch_failures' ``_kernel_case`` on the port's side."""
    wl = _small_workload(k)
    b = wl.sample_traces(300, 2, seed=seed)
    fb = flr.FailureProcess(30.0, 5.0, 2, "drain").sample(
        k, float(b.arrival.max()), 2, seed=seed)
    slots, s_max, h, q_cap = _bs_args(b, None, wl, None)
    msf = sim_batch._merged_fcfs_inputs(b, fb)
    msc = sim_batch._merged_class_inputs(b, fb, None, wl)
    frec = sim_batch._bs_fail_args(b, fb, None, wl)
    return b, slots, s_max, h, q_cap, msf, msc, frec


_DT = (np.float64, np.int32, np.int32, np.float64, np.float64, np.bool_)


def _merged(ms):
    return (ms.t, ms.cls, ms.need, ms.service, ms.t_up, ms.is_fail != 0)


def _port_fail(name, case, device="cpu"):
    b, slots, s_max, h, q_cap, msf, msc, (ft, ftgt, fup, length) = case

    def T(x, dtype=None):
        return torch.tensor(np.asarray(x, dtype), device=device)
    sl = T(slots, np.int32)
    if name == "fcfs":
        t, _, n, v, tu, isf = (T(x, d) for x, d in zip(_merged(msf), _DT))
        return (K.fcfs_fail_scan_fwd(t, n, v, tu, isf, k=b.k),)
    if name == "modbs":
        m = (T(x, d) for x, d in zip(_merged(msc), _DT))
        return K.modbs_fail_scan_fwd(*m, sl, s_max=s_max, h=h)
    return K.bs_fail_scan_fwd(
        T(b.arrival), T(b.cls, np.int32), T(b.need, np.int32),
        T(b.service), T(ft), T(ftgt, np.int32), T(fup), sl, s_max=s_max,
        h=h, q_cap=q_cap, length=length)


@pytest.mark.cuda
def test_cuda_fail_kernels_equal_plain_versions_on_the_card():
    """Each drain-mode CUDA kernel against its plain version on every raw
    output, rtol=0."""
    dev = _dev()
    for k in (32, 256):
        case = _fail_case(k)
        for name in ("fcfs", "modbs", "bs"):
            ref = _port_fail(name, case)
            K.reset_launches()
            out = _port_fail(name, case, dev)
            assert K.launches()[f"{name}_fail_scan_fwd"] == 1
            _equal(out, ref, (name, k))


# -- the grid path (tests/test_torch_grid.py's cells) ------------------------


GRID_CASES = ([(p, False) for p in ("fcfs", "modbs-fcfs", "bs-fcfs",
                                    "sf-srpt", "ff-srpt")]
              + [(p, True) for p in ("fcfs", "modbs-fcfs", "bs-fcfs")])
_GRID_WRAPPER = {"fcfs": "fcfs_scan_fwd", "modbs-fcfs": "modbs_scan_fwd",
                 "bs-fcfs": "bs_scan_fwd", "sf-srpt": "srpt_scan_fwd",
                 "ff-srpt": "srpt_scan_fwd"}


def _grid_cells(drain):
    """(k, J) = (32, 200) and (256, 120), R = 3: both paddings."""
    cells = []
    for g, (k, J) in enumerate(((32, 200), (256, 120))):
        wl = _small_workload(k)
        b = wl.sample_traces(J, 3, seed=g)
        fb = None
        if drain:
            h = float(b.arrival.max())
            fb = flr.FailureProcess(mtbf=h / 2, mttr=h / 40,
                                    mode="drain").sample(k, h, 3, seed=g)
        cells.append(engines.GridCell(b, wl=wl, failures=fb))
    return cells


def _assert_results_equal(out, ref, what):
    for f in dataclasses.fields(ref):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), (what, f.name)
        if a is not None:
            assert np.array_equal(a, b), (what, f.name)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,drain", GRID_CASES)
def test_cuda_grid_equals_per_cell_on_the_card(policy, drain):
    """The stacked grid on the card is one launch of its policy's kernel,
    and each cell equals per-cell ``simulate`` on the card."""
    dev = _dev()
    cells = _grid_cells(drain)
    K.reset_launches()
    out = engines.simulate_grid(policy, cells, device=dev)
    want = _GRID_WRAPPER[policy]
    if drain:
        want = want.replace("_scan", "_fail_scan")
    assert {w: n for w, n in K.launches().items() if n} == {want: 1}
    for g, (cell, o) in enumerate(zip(cells, out)):
        _assert_results_equal(o, engines.simulate(
            policy, cell.batch, wl=cell.wl, failures=cell.failures,
            device=dev), (policy, drain, g))


@pytest.mark.cuda
@pytest.mark.parametrize("policy,drain", GRID_CASES)
def test_cuda_kernels_equal_the_event_engine(policy, drain):
    """Each scan kernel on the card against the port's event engine
    (``engine="python"``, which shares no code with the kernels or their
    plain versions) on every ``BatchSimResult`` field, rtol=0: Fig. 1 at
    k = 256, J = 500, R = 2, clean and under bench outages."""
    dev = _dev()
    wl = workload.figure1_workload(256)
    b = wl.sample_traces(500, 2, seed=21)
    fb = bs_cases.bench_failures(wl, b, seed=21) if drain else None
    K.reset_launches()
    out = engines.simulate(policy, b, wl=wl, failures=fb, device=dev)
    want = _GRID_WRAPPER[policy]
    if drain:
        want = want.replace("_scan", "_fail_scan")
    assert {w: n for w, n in K.launches().items() if n} == {want: 1}
    _assert_results_equal(out, engines.simulate(
        policy, b, engine="python", wl=wl, failures=fb), (policy, drain))


def _grid_raw(policy, drain, cells, device):
    """The raw outputs of the wrapper call a grid core makes, on
    ``device`` (its plan's per-lane sizes, lanes flattened)."""
    from repro_torch.kernels.msj_scan import ops

    L = len(cells) * cells[0].batch.reps
    if policy in ("sf-srpt", "ff-srpt"):
        p = sim_batch._srpt_grid_plan(cells)
        up = ops._upload(p, L, device)
        return K.srpt_scan_fwd(up("arrival"), up("need"), up("service"),
                               up("kk"), Q=p["Q_pad"], NU=p["NU"],
                               sf=policy == "sf-srpt",
                               j_live=up("j_live", torch.int32))
    plan = {("fcfs", False): sim_batch._fcfs_grid_plan,
            ("fcfs", True): sim_batch._fcfs_fail_grid_plan,
            ("modbs-fcfs", False): sim_batch._modbs_grid_plan,
            ("modbs-fcfs", True): sim_batch._modbs_fail_grid_plan,
            ("bs-fcfs", False): sim_batch._bs_grid_plan,
            ("bs-fcfs", True): sim_batch._bs_fail_grid_plan}[policy, drain]
    p = plan(cells)
    up = ops._upload(p, L, device)
    i32 = torch.int32
    if policy == "fcfs" and drain:
        return (K.fcfs_fail_scan_fwd(up("t"), up("need", i32), up("svc"),
                                     up("t_up"), up("isf", torch.bool),
                                     k=p["k_pad"], k_lane=up("k_lane", i32)),)
    if policy == "fcfs":
        return (K.fcfs_scan_fwd(up("arrival"), up("need", i32),
                                up("service"), k=p["k_pad"],
                                k_lane=up("k_lane", i32)),)
    sizes = dict(s_max=p["s_max_pad"], h=p["h_pad"],
                 h_lane=up("h_lane", i32))
    if policy == "modbs-fcfs" and drain:
        return K.modbs_fail_scan_fwd(*ops._merged_lanes(up),
                                     up("slots", i32), **sizes)
    trace = (up("arrival"), up("cls", i32), up("need", i32), up("service"))
    if policy == "modbs-fcfs":
        return K.modbs_scan_fwd(*trace, up("slots", i32), **sizes)
    sizes.update(q_cap=p["q_cap_pad"], j_live=up("j_live", i32))
    if drain:
        return K.bs_fail_scan_fwd(*trace, up("ft"), up("ftgt", i32),
                                  up("fup"), up("slots", i32),
                                  length=p["length"], **sizes)
    return K.bs_scan_fwd(*trace, up("slots", i32), **sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,drain", GRID_CASES)
def test_cuda_per_lane_sizes_equal_plain_versions(policy, drain):
    """Each kernel with per-lane sizes (dead servers, padded slots and
    classes, sentinel jobs past ``j_live`` and the records past a lane's
    events) equals its plain version on every raw output."""
    dev = _dev()
    cells = _grid_cells(drain)
    _equal(_grid_raw(policy, drain, cells, dev),
           _grid_raw(policy, drain, cells, "cpu"), (policy, drain))


def _wide_cell(k, needs, a, lam, seed, J=400, reps=2):
    """A cell of a hand-built partition (classes uniform, Exp(1)
    services, Poisson arrivals at rate ``lam``)."""
    part = partition.BalancedPartition(k=k, needs=tuple(needs), a=tuple(a),
                                       psi=0.0)
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, len(needs), (reps, J))
    b = workload.BatchTrace.from_arrays(
        np.cumsum(rng.exponential(1.0 / lam, (reps, J)), axis=1), cls,
        rng.exponential(1.0, (reps, J)), np.asarray(needs)[cls], k,
        len(needs))
    return engines.GridCell(b, partition=part)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["modbs-fcfs", "bs-fcfs"])
def test_cuda_grid_wider_than_every_cell(policy):
    """24 classes of 2 slots beside 2 classes of 40: the grid's rows are
    C_pad x s_max_pad = 24 x 40, above either cell's (48, 80), and still
    fit; each cell equals its per-cell run on the card and the grid's
    plain version on the CPU."""
    dev = _dev()
    cells = [_wide_cell(64, [1] * 24, [2] * 24, 30.0, 1),
             _wide_cell(128, [1, 2], [40, 80], 60.0, 2)]
    K.reset_launches()
    out = engines.simulate_grid(policy, cells, device=dev)
    assert sum(K.launches().values()) == 1
    cpu = engines.simulate_grid(policy, cells, device="cpu")
    for g, (cell, o, c) in enumerate(zip(cells, out, cpu)):
        assert 0 < o.p_helper.mean() < 1, g
        _assert_results_equal(o, c, (policy, g, "cpu"))
        _assert_results_equal(o, engines.simulate(
            policy, cell.batch, partition=cell.partition, device=dev),
            (policy, g))



# -- srpt_scan and stable_sort (tests/test_torch_srpt.py's shapes) -----------


def _srpt_batch(k, load=0.85, seed=3):
    from repro_torch.data.swf import sdsc_sp2_trace

    trace = sdsc_sp2_trace(J, k=k, load=load, seed=seed)
    return workload.BatchTrace.from_trace(trace, R, seed=seed)


def _srpt_args(b):
    return (torch.tensor(b.arrival), torch.tensor(b.need, dtype=torch.float64),
            torch.tensor(b.service),
            torch.full((b.reps,), float(b.k), dtype=torch.float64))


def _burst():
    """J = 200 jobs in 10 batches of 20 equal arrival times, 8 time units
    apart, k = 64: up to 58 jobs in the system."""
    return srpt_cases.burst_case(200, 64, R, batch=20, gap=8.0, seed=0)


@pytest.mark.cuda
def test_cuda_srpt_and_sort_equal_plain_versions_on_the_card():
    """The CUDA kernels against their plain versions, rtol=0, on SDSC-SP2
    and KIT-FH2 bootstraps, the burst trace with and without overflow,
    and Q = 4."""
    dev = _dev()
    cases = []
    for k in (64, 128):
        b = _srpt_batch(k)
        cases.append((_srpt_args(b), sim_batch._srpt_nu(b),
                      sim_torch._srpt_args(b, None)))
        cases.append(srpt_cases.table_case("kit", J, k, R, seed=3)
                     + (srpt_cases.slots(J, k),))
    t, NU = _burst()
    cases += [(t, NU, 64), (t, NU, 16), (t, NU, 4)]
    for targs, NU, Q in cases:
        for sf in (True, False):
            out = msj_scan.srpt_scan_fwd(*(t.to(dev) for t in targs), Q=Q,
                                         NU=NU, sf=sf)
            ref = msj_scan.srpt_scan_fwd(*targs, Q=Q, NU=NU, sf=sf)
            _equal(out, ref, (Q, NU, sf))
    rng = np.random.default_rng(5)
    for W in (24, 3000, 4096):
        keys = [torch.tensor(rng.choice([-np.inf, np.inf, 0.0, 1.5], (3, W))),
                torch.tensor(rng.choice([0.0, 1.0], (3, W)))]
        pay = torch.arange(3 * W, dtype=torch.int32).reshape(3, W)
        for nk in (1, 2):
            ops = keys[:nk] + [pay]
            out = msj_scan.stable_sort_fwd(*(t.to(dev) for t in ops),
                                           num_keys=nk)
            ref = msj_scan.stable_sort_fwd(*ops, num_keys=nk)
            _equal(out, ref, (W, nk))


@pytest.mark.cuda
def test_cuda_srpt_scan_beyond_4096_slots():
    """Q = 8192: the slot table no longer fits shared memory and lives in
    global scratch.  One batch of 4200 equal arrivals at k = 4200 puts
    4200 jobs in the system at once; SF and FF equal the plain version."""
    dev = _dev()
    t, NU = srpt_cases.burst_case(4200, 4200, 1, batch=4200, gap=1.0,
                                  seed=0)
    for sf in (True, False):
        out = msj_scan.srpt_scan_fwd(*(x.to(dev) for x in t), Q=8192, NU=NU,
                                     sf=sf)
        ref = msj_scan.srpt_scan_fwd(*t, Q=8192, NU=NU, sf=sf)
        _equal(out, ref, sf)
        assert int(out[6].max()) > 4096 and not out[3].any()


# -- attention (tests/test_torch_attention.py's shapes) ----------------------


# CUDA kernel against its plain version, as (atol, rtol): in bfloat16 two
# units in the last place
PLAIN_TOLS = {"float32": (2e-5, 2e-5), "bfloat16": (1e-5, 2.0 ** -6)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, 64, True),
    (1, 128, 256, 4, 4, 128, 128, False),
    (2, 256, 256, 6, 3, 64, 32, True),
    (1, 512, 512, 8, 1, 64, 64, True),     # MQA
    (1, 128, 128, 4, 2, 80, 80, True),     # stablelm-3b's head dim
]
TC_FLASH_SHAPES = [
    (1, 200, 200, 8, 1, 128, 128, True),
    (2, 333, 333, 4, 4, 80, 80, True),
    (1, 100, 250, 8, 1, 64, 64, False),
    (1, 300, 130, 4, 4, 128, 128, False),
    (1, 77, 77, 2, 2, 80, 80, True),
    (1, 130, 130, 16, 2, 128, 64, False),
    (2, 300, 130, 4, 2, 128, 128, True),       # causal, Sq > Sk
]
DECODE_SHAPES = [
    (2, 1024, 8, 2, 64, 64),
    (3, 512, 4, 4, 128, 64),
    (1, 256, 16, 2, 64, 128),
    (2, 512, 8, 8, 80, 80),                # stablelm-3b's head dim, MHA
]
DECODE_CARD_SHAPES = [
    (4, 2048, 32, 4, 128, 128),
    (4, 2048, 32, 32, 80, 80),
    (2, 1000, 64, 8, 128, 128),
    (3, 777, 16, 2, 80, 80),
    (1, 300, 16, 16, 128, 128),
]


def _normal(rng, shape, dtype):
    """test_torch_attention's ``_both`` sample, the torch side."""
    x = rng.normal(size=shape).astype(np.float32)
    return torch.tensor(x).to(TDT[dtype])


def _close_plain(out, ref, dtype):
    atol, rtol = PLAIN_TOLS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_cuda_attention_kernels_match_plain_versions_on_the_card(rng):
    """Each attention CUDA kernel against its plain version on the card, at
    ``PLAIN_TOLS``; every bf16 flash call takes the tensor-core kernel."""
    dev = _dev()
    for dtype in ("float32", "bfloat16"):
        for B, Sq, Sk, H, Kh, D, Dv, causal in FLASH_SHAPES + TC_FLASH_SHAPES:
            q, k, v = (_normal(rng, s, dtype).to(dev) for s in (
                (B, Sq, H, D), (B, Sk, Kh, D), (B, Sk, Kh, Dv)))
            _close_plain(flash_attention_fwd(q, k, v, causal=causal).cpu(),
                         flash_attention_ref(q, k, v, causal=causal).cpu(),
                         dtype)
            assert flash_attention_fwd.last_route == (
                "wgmma" if dtype == "bfloat16" else "simt")
        for B, Sk, H, Kh, D, Dv in DECODE_SHAPES + DECODE_CARD_SHAPES:
            q, k, v = (_normal(rng, s, dtype).to(dev) for s in (
                (B, H, D), (B, Sk, Kh, D), (B, Sk, Kh, Dv)))
            pos = torch.tensor(rng.integers(-1, Sk + 2, size=B),
                               dtype=torch.int32, device=dev)
            _close_plain(decode_attention_fwd(q, k, v, pos).cpu(),
                         decode_attention_ref(q, k, v, pos).cpu(), dtype)


# -- gmm (tests/test_torch_moe.py's shapes) ----------------------------------


@pytest.mark.cuda
def test_cuda_gmm_matches_plain_version_on_the_card(rng):
    """The gmm CUDA kernels against their plain version on the card, ragged
    shapes and every row tile, junk rows and nvalid == 0 blocks: float32
    2e-5 + 2e-5 |ref|; bfloat16 1e-5 + 2^-6 |ref|; skipped blocks exactly
    zero; each call on the route ``_gmm_route`` gives."""
    dev = _dev()
    tols = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-5, 2.0 ** -6)}
    for E, Kd, N, bm in ((8, 64, 128, 16), (8, 200, 70, 32), (4, 96, 136, 64),
                         (5, 2048, 1408, 128), (3, 33, 7, 48),
                         (6, 200, 136, 64), (5, 200, 136, 128),
                         (8, 2048, 1408, 16), (4, 1408, 2048, 32),
                         (2, 8192, 520, 16), (3, 200, 136, 32),
                         (2, 24, 8, 16)):
        nb = 3 * E
        be = torch.tensor(rng.integers(0, E, nb), dtype=torch.int32)
        nv = torch.tensor(rng.integers(0, bm + 1, nb) * (
            rng.random(nb) < 0.7), dtype=torch.int32)
        nv[0] = 0                                  # one empty block at least
        for dt in (torch.float32, torch.bfloat16):
            x = torch.tensor(rng.normal(size=(nb * bm, Kd)), dtype=dt)
            w = torch.tensor(rng.normal(size=(E, Kd, N)) / np.sqrt(Kd),
                             dtype=dt)
            args = [t.to(dev) for t in (x, w, be, nv)]
            out = gmm(*args, block_m=bm)
            ref = gmm_ref(*args, block_m=bm)
            torch.cuda.synchronize()
            atol, rtol = tols[dt]
            d = (out.float() - ref.float()).abs()
            assert (d <= atol + rtol * ref.float().abs()).all(), (
                E, Kd, N, bm, dt, d.max().item())
            skipped = (nv == 0).to(dev).repeat_interleave(bm)
            assert (out[skipped] == 0).all()
            assert gmm.last_route == _gmm_route(dt, bm, Kd, N)


# -- mamba_scan (tests/test_torch_mamba.py's shapes) -------------------------


SCAN_SHAPES = [(2, 128, 64, 16, 32, 32), (1, 64, 128, 8, 64, 64)]


def _scan_inputs(rng, B, S, d_in, N):
    """tests/test_kernels.py's inputs: a in [0.5, 0.99], b ~ 0.2 N(0, 1),
    c ~ N(0, 1), float32."""
    a = rng.uniform(0.5, 0.99, (B, S, d_in, N)).astype(np.float32)
    b = (rng.normal(size=(B, S, d_in, N)) * 0.2).astype(np.float32)
    c = rng.normal(size=(B, S, N)).astype(np.float32)
    return a, b, c


def _fused_inputs(rng, B, S, d_in, N):
    """dt from the model's init range, A = -(1..N), Bm / C / u ~ N(0, 1),
    and a carried state."""
    dt = np.exp(rng.uniform(math.log(1e-3), math.log(0.5), (B, S, d_in)))
    A = -np.tile(np.arange(1, N + 1), (d_in, 1))
    out = [dt, A, rng.normal(size=(B, S, N)), rng.normal(size=(B, S, d_in)),
           rng.normal(size=(B, S, N)), rng.normal(size=(B, d_in, N)) * 0.5]
    return [x.astype(np.float32) for x in out]


def _close(port, ref, *, tol, bf16=False):
    """|port - ref| <= tol + tol |ref| (+ two bfloat16 units)."""
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    limit = tol + tol * np.abs(r)
    if bf16:   # two bfloat16 units in the last place of |ref|
        limit = limit + 2 * np.exp2(np.floor(np.log2(
            np.maximum(np.abs(r), 1e-30))) - 7)
    assert (np.abs(p - r) <= limit).all(), float(np.abs(p - r).max())


@pytest.mark.cuda
def test_cuda_mamba_scan_kernels_match_plain_versions_on_the_card(rng):
    """Both mamba_scan entries against their plain versions on the card,
    float32 and bfloat16, zero and carried state, ragged lengths and an N
    below 16, within 1e-4 + 1e-4 |ref|.  The edge shapes of the fused
    kernel's tiling: S = 1, N not a multiple of its 4 states a lane, d_in
    not a multiple of its 32 channels a block (with d_in a multiple of 8
    and N of 4: the 16-byte copies; else the 4-byte ones), B = 2."""
    dev = _dev()
    for B, S, d_in, N, chunk, bd in SCAN_SHAPES + [
            (2, 77, 300, 5, 16, 16), (2, 1, 64, 16, 8, 8),
            (1, 45, 200, 7, 16, 16), (1, 45, 200, 12, 16, 16),
            (2, 33, 97, 13, 16, 16)]:
        a, b, c = (torch.tensor(x, device=dev) for x in
                   _scan_inputs(rng, B, S, d_in, N))
        for dt_ in (torch.float32, torch.bfloat16):
            before = mamba_scan_fwd.launches
            y = mamba_scan_fwd(a.to(dt_), b.to(dt_), c, chunk=chunk,
                               block_d=bd)
            assert mamba_scan_fwd.launches == before + 1
            ref = mamba_scan_ref(a.to(dt_), b.to(dt_), c)
            _close(y.cpu(), ref.cpu().float().numpy(), tol=1e-4,
                   bf16=dt_ == torch.bfloat16)
        dt, A, Bm, u, C, h0 = (torch.tensor(x, device=dev) for x in
                               _fused_inputs(rng, B, S, d_in, N))
        for uu in (u, u.to(torch.bfloat16)):
            for h in (None, h0):
                before = mamba_scan_fused.launches
                y, h_T = mamba_scan_fused(dt, A, Bm, uu, C, h)
                assert mamba_scan_fused.launches == before + 1
                ry, rh = mamba_scan_fused_ref(dt, A, Bm, uu, C, h)
                _close(y.cpu(), ry.cpu().numpy(), tol=1e-4)
                _close(h_T.cpu(), rh.cpu().numpy(), tol=1e-4)


# -- wkv (tests/test_torch_rwkv.py's shapes) ---------------------------------


WKV_SHAPES = [(2, 128, 2, 32, 32), (1, 96, 4, 16, 32), (2, 64, 2, 64, 64)]
WKV_ATOL, WKV_RTOL = 5e-4, 1e-3


def _wkv_inputs(rng, B, S, H, N):
    """test_kernels.py's inputs as numpy float32, plus a carried state."""
    r = rng.normal(size=(B, S, H, N))
    k = rng.normal(size=(B, S, H, N)) * 0.3
    v = rng.normal(size=(B, S, H, N))
    logw = -rng.uniform(0.01, 1.0, (B, S, H, N))
    u = rng.normal(size=(H, N)) * 0.1
    out = [a.astype(np.float32) for a in (r, k, v, logw, u)]
    out.append((rng.normal(size=(B, H, N, N)) * 0.5).astype(np.float32))
    return out


def _wkv_close(port, ref, *, bf16=False):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    limit = WKV_ATOL + WKV_RTOL * np.abs(r)
    if bf16:   # two bfloat16 units in the last place of |ref|
        limit = limit + 2 * np.exp2(np.floor(np.log2(
            np.maximum(np.abs(r), 1e-30))) - 7)
    assert (np.abs(p - r) <= limit).all(), float(np.abs(p - r).max())


@pytest.mark.cuda
def test_cuda_wkv_kernel_matches_plain_version_on_the_card(rng):
    """The wkv CUDA kernels against their plain version on the card, zero
    and carried state, a ragged S, float32 and bfloat16 r / k / v.  The
    edge shapes of the chunk-parallel split: S = 1, S below the chunk, N
    of 48 and 5 (not a multiple of the 4 x 4 tiles), chunks of 16 and 8,
    B = 2."""
    dev = _dev()
    for B, S, H, N, chunk in WKV_SHAPES + [
            (1, 100, 2, 64, 64), (1, 1, 2, 64, 64), (2, 40, 3, 48, 64),
            (2, 70, 2, 48, 16), (1, 33, 1, 5, 8)]:
        r, k, v, logw, u, s0 = (torch.tensor(a, device=dev) for a in
                                _wkv_inputs(rng, B, S, H, N))
        for dt in (torch.float32, torch.bfloat16):
            rr, kk, vv = (a.to(dt) for a in (r, k, v))
            for s in (None, s0):
                before = wkv_fwd.launches
                y, s_T = wkv_fwd(rr, kk, vv, logw, u, s, chunk=chunk)
                assert wkv_fwd.launches == before + 1
                ry, rs = wkv_chunked_ref(rr, kk, vv, logw, u, s,
                                         chunk=chunk)
                _wkv_close(y.cpu(), ry.cpu().float().numpy(),
                           bf16=dt == torch.bfloat16)
                _wkv_close(s_T.cpu(), rs.cpu().numpy())


# -- the loss queue (loss_scan) and Property 1 ------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 6, 24, 196, K.LOSS_S_MAX])
def test_cuda_loss_scan_equals_plain_version_and_oracle(s):
    """``loss_scan`` at R = 4, J = 2000 against its plain version on the
    card (``torch.equal``) and the heapq oracle, at an offered load of
    1.1 s (blocking) and on equal arrival times; an ``s`` above the
    kernel's shared memory raises."""
    dev = _dev()
    for arrival, service in (loss_cases.mmss_case(4, 2000, 1.1 * s,
                                                  seed=s),
                             loss_cases.ties_case(4, 2000)):
        a, v = (torch.tensor(x, device=dev) for x in (arrival, service))
        before = K.loss_scan_fwd.launches
        out = K.loss_scan_fwd(a, v, s=s)
        assert K.loss_scan_fwd.launches == before + 1
        assert torch.equal(out, K.loss_scan_ref(a, v, s=s))
        for r in range(4):
            assert np.array_equal(out[r].cpu().numpy(), loss_cases.loss_oracle(
                arrival[r], service[r], s)), (s, r)
    with pytest.raises(ValueError, match="shared memory"):
        K.loss_scan_fwd(a, v, s=K.LOSS_S_MAX + 1)


@pytest.mark.cuda
def test_cuda_property1_loss_scan_equals_modbs_scan():
    """Property 1 on the card: ``modbs_scan``'s blocked mask of each class
    equals ``loss_scan`` with slots[c] on that class's substream (Fig. 1,
    k = 512, J = 20 000, R = 4)."""
    dev = _dev()
    wl = workload.figure1_workload(512)
    b = wl.sample_traces(20_000, 4, seed=8)
    blocked = sim_batch.modified_bs_sim_batch(b, wl=wl, device=dev).blocked
    slots = partition.balanced_partition(wl).slots
    assert loss_cases.property1_mismatches(
        b, blocked, slots, lambda a, v, s: sim_batch.loss_queue_sim_batch(
            a, v, s, device=dev).blocked) == []


@pytest.mark.cuda
def test_cuda_eq16_matches_monte_carlo():
    """Eq. (16) against ``estimate_p_helper`` (``modbs_scan``) at 200 000
    jobs on Fig. 1, k = 512, within 0.01 (``tests/test_theory.py``'s
    check)."""
    _dev()
    wl = workload.figure1_workload(512)
    mc = sim_torch.estimate_p_helper(wl, 200_000, seed=5)
    assert mc == pytest.approx(theory.p_helper_upper_bound(wl), abs=0.01)

