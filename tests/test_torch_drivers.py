"""The port's Fig. 1 / Fig. 2 / Thm 1-2 drivers and the real-log SWF path
against the reference scripts.

On the CPU (the kernels' plain versions) every driver must give the
reference script's rows on every column but the wall time ``sim_s``, at
tolerance 0: ``fig1_critical.run_scan`` / ``run`` (the reference's
``run_jax`` / ``run``, with the theory columns), ``fig2_regimes.
run_heavy_scan`` / ``run_subcritical_scan`` / ``run_heavy``,
``theory_tables.run`` (its Monte-Carlo column on ``modbs_scan``'s plain
version) and ``fig3_traces.run_swf``; each ``main`` prints the
reference's CSV.  ``parse_swf`` / ``trace_to_workload`` / ``write_swf``
equal the reference's on a log this file writes.  k >= 128: at k = 64
the Fig. 1 partition gives a class no slot and the reference's scan
cannot run ModBS.
"""

import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_jaxref import ref_engines  # the reference's x64 alias

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import fig1_critical as ref_fig1  # noqa: E402
from benchmarks import fig2_regimes as ref_fig2  # noqa: E402
from benchmarks import fig3_traces as ref_fig3  # noqa: E402
from benchmarks import theory_tables as ref_tables  # noqa: E402
from repro.data import swf as ref_swf  # noqa: E402

from repro_torch.bench import (common, fig1_critical, fig2_regimes,  # noqa: E402
                               fig3_traces, theory_tables)
from repro_torch.data import swf  # noqa: E402

CPU = "cpu"


def rows_equal(out, ref, skip=("sim_s",)):
    assert len(out) == len(ref) > 0
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        for col in set(o) - set(skip):
            same = o[col] == r[col] or (o[col] != o[col] and r[col] != r[col])
            assert same, (col, o[col], r[col])


def csv_of(main, argv):
    """A script's CSV lines, each without its last column (``sim_s``)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = buf.getvalue().splitlines()
    return [lines[0]] + [ln.rsplit(",", 1)[0] for ln in lines[1:]]


@pytest.mark.parametrize("grid", [True, False])
def test_fig1_run_scan_equals_reference(grid):
    kw = dict(ks=(128, 256), num_jobs=500, reps=2)
    out = fig1_critical.run_scan(**kw, device=CPU, grid=grid)
    rows_equal(out, ref_fig1.run_jax(**kw))
    assert all(r["ph_bound"] > 0 and r["zero_wait_R"] > 0 for r in out)


def test_fig1_event_engine_run_equals_reference():
    kw = dict(ks=(128,), num_jobs=300)
    rows_equal(fig1_critical.run(**kw), ref_fig1.run(**kw))


def test_fig2_scans_equal_reference():
    kw = dict(num_jobs=400, reps=2)
    rows_equal(fig2_regimes.run_heavy_scan(loads=(0.5, 0.9), **kw,
                                           device=CPU),
               ref_fig2.run_heavy_jax(loads=(0.5, 0.9), **kw))
    rows_equal(fig2_regimes.run_subcritical_scan(ks=(256, 512), **kw,
                                                 device=CPU),
               ref_fig2.run_subcritical_jax(ks=(256, 512), **kw))


def test_fig2_event_engine_runs_equal_reference():
    kw = dict(num_jobs=250, policies=("bs", "fcfs", "msf"))
    rows_equal(fig2_regimes.run_heavy(loads=(0.7,), **kw),
               ref_fig2.run_heavy(loads=(0.7,), **kw))
    rows_equal(fig2_regimes.run_subcritical(ks=(256,), **kw),
               ref_fig2.run_subcritical(ks=(256,), **kw))


def test_theory_tables_equal_reference():
    out = theory_tables.run(mc_jobs=300, device=CPU)
    rows_equal(out, ref_tables.run(mc_jobs=300), skip=())
    assert [r["table"] for r in out] == ["thm1_ph"] * 3 + ["thm2_rate"] * 3
    assert [r["mc"] is None for r in out] == [False] * 5 + [True]


def test_mains_print_the_reference_csv():
    assert csv_of(fig1_critical.main, ["--device", CPU, "--ks", "128",
                                       "--jobs", "300", "--reps", "2"]) == \
        csv_of(ref_fig1.main, ["--ks", "128", "--jobs", "300", "--reps",
                               "2"])
    assert csv_of(theory_tables.main, ["--device", CPU, "--mc-jobs",
                                       "200"]) == \
        csv_of(ref_tables.main, ["--mc-jobs", "200"])
    fig2 = csv_of(fig2_regimes.main, ["--device", CPU, "--jobs", "200",
                                      "--reps", "2", "--policies", "fcfs"])
    assert fig2 == csv_of(ref_fig2.main, ["--jobs", "200", "--reps", "2",
                                          "--policies", "fcfs"])
    assert len(fig2) == 1 + 5 + 4


def test_mains_refuse_what_they_cannot_do():
    for main in (fig1_critical.main, fig2_regimes.main):
        with pytest.raises(SystemExit):
            main(["--engine", "python", "--ckpt-dir", "x"])
    with pytest.raises(SystemExit):
        fig3_traces.main(["--swf", "x.swf", "--resume"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fig1_critical.main(["--ks", "128", "--jobs", "50"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            theory_tables.run(mc_jobs=50)


def test_policy_sets_and_csv_writer_are_the_reference_scripts():
    from benchmarks import common as ref_common

    assert common.PAPER_POLICIES == ref_common.PAPER_POLICIES
    assert common.SWEEP_POLICIES == ref_common.JAX_POLICIES
    assert fig3_traces.PAPER_POLICIES is common.PAPER_POLICIES
    assert fig3_traces.emit is common.emit
    for v in (None, 1.0 / 3, float("inf"), np.float64(2.5), 7, "x"):
        assert common._fmt(v) == ref_common._fmt(v)


# -- SWF ---------------------------------------------------------------------

LOG = """\
; SWF header comment
;   Version: 2.2

1 10.0 0 100.0 4 -1 -1 4 -1 -1 1 -1 -1 -1 -1 -1 -1 -1
2 5.0 0 50.0 1 -1 -1 1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
3 5.0 0 60.0 2 -1 -1 2 -1 -1 1 -1 -1 -1 -1 -1 -1 -1
4 7.0 0 70.0 3 -1 -1 3 -1 -1 1 -1 -1 -1 -1 -1 -1 -1
5 8.0 0 80.0 128 -1 -1 128 -1 -1 1 -1 -1 -1 -1 -1 -1 -1
6 9.0 0 0 8 -1 -1 8 -1 -1 1 -1 -1 -1 -1 -1 -1 -1
7 9.5 0 90.0 0 -1 -1 0 -1 -1 1 -1 -1 -1 -1 -1 -1 -1
8 11.0 0 110.0 8 -1 -1 8 -1 -1 0 -1 -1 -1 -1 -1 -1 -1
9 12.0 0 120.0 8 -1 -1 8 -1 -1 5 -1 -1 -1 -1 -1 -1 -1
10 13.0 0 130.0 8 -1 -1 8 -1 -1 2 -1 -1 -1 -1 -1 -1 -1
11 14.0 0 140.0 8 -1 -1 8 -1 -1 3 -1 -1 -1 -1 -1 -1 -1
12 15.0 0 150.0 8 -1 -1 8 -1 -1 4 -1 -1 -1 -1 -1 -1 -1
13 3.0 0 30.5 64 -1 -1 64
14 2.0 0 20.25 8 -1 -1 8 -1 -1 1 -1 -1 -1 -1 -1 -1 -1
15 5.0 0 55.0 16 -1 -1 16 -1 -1 1 -1 -1 -1 -1 -1 -1 -1
16 1.0 0 12.0 32 -1 -1 32 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
17 20.0 0 15.0 6 -1 -1 6 -1 -1 1 -1 -1 -1 -1 -1 -1 -1
18 21.0 0 16.0 2 -1 -1 2 -1 -1 1 -1 -1 -1 -1 -1 -1 -1
"""


def _traces_equal(a, b):
    for f in ("arrival", "cls", "service", "need"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.k, a.C) == (b.k, b.C)


@pytest.mark.parametrize("kw", [
    {}, {"limit": 4}, {"max_need": 16}, {"powers_of_two_only": False},
    {"statuses": (0, 1, 2, 3, 4, 5, -1)}])
def test_parse_swf_equals_reference(tmp_path, kw):
    path = tmp_path / "log.swf"
    path.write_text(LOG)
    out = swf.parse_swf(str(path), k=64, **kw)
    _traces_equal(out, ref_swf.parse_swf(str(path), k=64, **kw))
    if not kw:   # completed / unknown, power-of-two, 1..64 processors
        assert out.num_jobs == 8 and out.C == 7
        assert out.arrival.tolist() == sorted(out.arrival.tolist())


def test_write_swf_bytes_and_workload_fit_equal_reference(tmp_path):
    trace = swf.sdsc_sp2_trace(500, k=128, load=0.7, seed=3)
    rtrace = ref_swf.sdsc_sp2_trace(500, k=128, load=0.7, seed=3)
    _traces_equal(trace, rtrace)
    swf.write_swf(trace, str(tmp_path / "port.swf"))
    ref_swf.write_swf(rtrace, str(tmp_path / "ref.swf"))
    assert (tmp_path / "port.swf").read_bytes() == \
        (tmp_path / "ref.swf").read_bytes()
    back = swf.parse_swf(str(tmp_path / "port.swf"), k=128)
    _traces_equal(back, ref_swf.parse_swf(str(tmp_path / "ref.swf"), k=128))
    for load in (0.5, 0.85):
        assert dataclasses.asdict(swf.trace_to_workload(back, 128, load)) == \
            dataclasses.asdict(ref_swf.trace_to_workload(
                ref_swf.parse_swf(str(tmp_path / "ref.swf"), k=128), 128,
                load))


def test_run_swf_equals_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_engines, "_WARNED_FALLBACKS", set())
    path = str(tmp_path / "sdsc.swf")
    swf.write_swf(swf.sdsc_sp2_trace(400, k=128, load=0.7, seed=1), path)
    kw = dict(k=128, load=0.85, reps=2)
    out = fig3_traces.run_swf(path, **kw, device=CPU,
                              policies=fig3_traces.SCAN_POLICIES)
    ref = ref_fig3.run_swf(path, **kw, engine="jax",
                           policies=fig3_traces.SCAN_POLICIES)
    rows_equal(out, ref, skip=("sim_s", "engine"))
    assert [r["engine"] for r in out] == ["torch"] * 5
    assert all(r["dataset"] == "swf" and np.isfinite(r["mean_response"])
               for r in out)
    iid = fig3_traces.run_swf(path, **kw, device=CPU, bootstrap="iid",
                              policies=("fcfs",), jobs=300)
    rows_equal(iid, ref_fig3.run_swf(path, **kw, engine="jax",
                                     bootstrap="iid", policies=("fcfs",),
                                     jobs=300), skip=("sim_s", "engine"))
    lines = csv_of(fig3_traces.main, ["--swf", path, "--k", "128",
                                      "--device", CPU, "--reps", "2",
                                      "--policies", "fcfs", "bs"])
    assert lines[0] == ",".join(fig3_traces.COLS) and len(lines) == 3
    assert lines[1].startswith("swf,128,0.85,torch,fcfs,400,2,")
