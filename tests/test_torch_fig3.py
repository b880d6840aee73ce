"""The port's Figure-3 script against the reference script's rows.

``repro_torch.bench.fig3_traces.run`` on the CPU (the kernels' plain
versions) must give the rows of ``benchmarks/fig3_traces.py:run`` with
``engine="jax"``: on the five scan policies every column but ``engine``
and ``sim_s`` (wall time) equal, at tolerance 0; on the paper's six
policies (the default) every column but ``sim_s``, the ``engine`` column
naming the core that ran (the reference's ``jax`` is the port's
``torch``; ``serverfilling`` and ``msf`` run on ``python`` on both
sides).  k = 128 is the smallest k at which the Table-2 partition gives
every ModBS/BS class row a slot; at k = 64 all slots are 0 and the
reference's ``jax`` engine cannot run ModBS (an empty argmin).
"""

import inspect
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_jaxref import ref_engines  # the reference's x64 alias

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import fig3_traces as ref_fig3  # noqa: E402

from repro_torch.bench import fig3_traces  # noqa: E402

KW = dict(num_jobs=400, reps=2, ks=(128,), loads=(0.7,))


def test_rows_equal_reference_script():
    out = fig3_traces.run(**KW, policies=fig3_traces.SCAN_POLICIES,
                          device="cpu")
    ref = ref_fig3.run(**KW, policies=fig3_traces.SCAN_POLICIES,
                       engine="jax", grid=False)
    assert len(out) == len(ref) == 10
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        for col in set(o) - {"engine", "sim_s"}:
            assert o[col] == r[col], (o["dataset"], o["policy"], col)
        assert o["engine"] == "torch"
        assert np.isfinite(o["mean_response"])
    buf = io.StringIO()
    fig3_traces.emit(out, fig3_traces.COLS, file=buf)
    lines = buf.getvalue().splitlines()
    assert lines[0] == ",".join(fig3_traces.COLS) and len(lines) == 11


def test_unported_policies_and_missing_card_raise(monkeypatch):
    """Since the event engine is ported, the paper's six policies run: the
    default policy set gives the reference script's rows, ``engine``
    column included, with one fallback warning for each event-engine
    policy; an unknown policy and a missing card still raise."""
    from repro_torch.core import engines

    monkeypatch.setattr(engines, "_WARNED_FALLBACKS", set())
    monkeypatch.setattr(ref_engines, "_WARNED_FALLBACKS", set())
    with pytest.warns(RuntimeWarning) as caught:
        out = fig3_traces.run(**KW, device="cpu")
    with pytest.warns(RuntimeWarning):
        ref = ref_fig3.run(**KW, policies=fig3_traces.PAPER_POLICIES,
                           engine="jax")
    assert inspect.signature(fig3_traces.run).parameters[
        "policies"].default == fig3_traces.PAPER_POLICIES
    assert len(out) == len(ref) == 12
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        for col in set(o) - {"engine", "sim_s"}:
            assert o[col] == r[col], (o["dataset"], o["policy"], col)
        assert o["engine"] == {"jax": "torch"}.get(r["engine"], r["engine"])
        assert o["engine"] == ("python" if o["policy"] in
                               ("serverfilling", "msf") else "torch")
        assert np.isfinite(o["mean_response"])
    fell = sorted(str(w.message).split("'")[1] for w in caught
                  if "falling back" in str(w.message))
    assert fell == ["msf", "serverfilling"]
    py = fig3_traces.run(**KW, policies=fig3_traces.PAPER_POLICIES,
                         engine="python")
    for o, r in zip(out, py):
        assert r["engine"] == "python"
        assert ({c: v for c, v in o.items() if c not in ("engine", "sim_s")}
                == {c: v for c, v in r.items()
                    if c not in ("engine", "sim_s")})
    with pytest.raises(KeyError, match="no simulation core"):
        fig3_traces.run(**KW, policies=("fcfs", "srpt"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fig3_traces.run(**KW)


def test_overflowing_cell_gives_the_reference_row(monkeypatch):
    """An overflowing slot table becomes the reference's row of infinite
    response times, with the overflow message in ``note``."""
    from repro_torch.core import engines, workload

    batch = workload.BatchTrace.from_trace(
        fig3_traces.sdsc_sp2_trace(300, k=128, load=0.85), 2)
    wl = workload.sdsc_sp2_workload(k=128, load=0.85)
    real = engines.simulate
    monkeypatch.setattr(engines, "simulate",
                        lambda *a, **kw: real(*a, **kw, queue_cap=2))
    row, = fig3_traces.run_policies_batch(batch, wl, ("sf-srpt",),
                                          device=torch.device("cpu"))
    assert row["mean_response"] == float("inf") and row["p_wait"] == 1.0
    assert row["note"].startswith("SRPT slot table overflow (queue_cap=2)")
