"""The port's Figure-3 script against the reference script's rows.

``repro_torch.bench.fig3_traces.run`` on the CPU (the kernels' plain
versions) must give the rows of ``benchmarks/fig3_traces.py:run`` with
``engine="jax"`` and per-cell dispatch, on the five scan policies: every
column but ``engine`` and ``sim_s`` (wall time) equal, at tolerance 0.
k = 128 is the smallest k at which the Table-2 partition gives every
ModBS/BS class row a slot; at k = 64 all slots are 0 and the reference's
``jax`` engine cannot run ModBS (an empty argmin).
"""

import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_jaxref  # noqa: F401  (the reference's x64 alias)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import fig3_traces as ref_fig3  # noqa: E402

from repro_torch.bench import fig3_traces  # noqa: E402

KW = dict(num_jobs=400, reps=2, ks=(128,), loads=(0.7,))


def test_rows_equal_reference_script():
    out = fig3_traces.run(**KW, device="cpu")
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


def test_unported_policies_and_missing_card_raise():
    with pytest.raises(KeyError, match="Queue 1 item 15"):
        fig3_traces.run(**KW, policies=("fcfs", "serverfilling"),
                        device="cpu")
    with pytest.raises(KeyError, match="msf"):
        fig3_traces.run(**KW, policies=("msf",), device="cpu")
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
