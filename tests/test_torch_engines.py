"""The port's entry points against the JAX reference's engines, rtol=0.

``simulate``, ``simulate_grid`` and ``sweep_many_server`` of
``repro_torch`` (on the CPU: the plain PyTorch versions of the kernels)
must give the reference's results field by field on the same batch, for
every engine the reference has for FCFS, ModBS-π and BS-π: ``jax``, the
Pallas kernels in interpret mode (``pallas``) and the event-driven
``python`` oracle.  Also: the port runs on the card by default and says
so when there is none, it imports nothing of JAX or of the reference, and
it keeps its own registry.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_jaxref import port_batch, ref_engines, ref_workload
from repro.core import sim_batch as ref_sim_batch

from repro_torch.core import engines, sim_batch, workload
from repro_torch.core.failures import FailureProcess

POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs")
FIELDS = ("response", "wait", "start", "blocked", "p_helper", "p_routed")
ROOT = Path(__file__).resolve().parents[1]


def _assert_same_result(out, ref):
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            assert np.array_equal(a, b), f
    for f in ("kills", "requeues", "availability", "preemptions"):
        assert getattr(ref, f, None) is None


@functools.lru_cache(maxsize=None)
def _port_result(policy, k):
    wl = workload.figure1_workload(k)
    batch = wl.sample_traces(300, 2, seed=17)
    return engines.simulate(policy, batch, wl=wl, device="cpu")


@pytest.mark.parametrize("engine", ["jax", "pallas", "python"])
@pytest.mark.parametrize("k", [32, 256])
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_bit_equal_to_reference_engines(policy, k, engine):
    wl = ref_workload.figure1_workload(k)
    ref = ref_engines.simulate(policy, wl.sample_traces(300, 2, seed=17),
                               engine=engine, wl=wl)
    _assert_same_result(_port_result(policy, k), ref)


@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_grid_cells_equal_per_cell_simulate(policy):
    specs = ((32, 200, 5), (256, 120, 6))
    ref_cells, cells = [], []
    for k, J, seed in specs:
        rwl = ref_workload.figure1_workload(k)
        rb = rwl.sample_traces(J, 2, seed=seed)
        ref_cells.append(ref_engines.GridCell(batch=rb, wl=rwl))
        cells.append(engines.GridCell(batch=port_batch(rb),
                                      wl=workload.figure1_workload(k)))
    out = engines.simulate_grid(policy, cells, device="cpu")
    ref = ref_engines.simulate_grid(policy, ref_cells, engine="jax")
    assert len(out) == len(specs)
    for cell, o, r in zip(cells, out, ref):
        _assert_same_result(o, r)
        _assert_same_result(
            o, engines.simulate(policy, cell.batch, wl=cell.wl,
                                device="cpu"))


@pytest.mark.parametrize("grid", [True, False])
def test_sweep_many_server_equals_reference(grid):
    kw = dict(num_jobs=300, reps=3, seed=2,
              policies=("bs-fcfs", "fcfs", "modbs-fcfs"), grid=grid)
    out = sim_batch.sweep_many_server(workload.figure1_workload, (32, 64),
                                      device="cpu", **kw)
    ref = ref_sim_batch.sweep_many_server(ref_workload.figure1_workload,
                                          (32, 64), engine="jax", **kw)
    assert (out.points, out.policies, out.num_jobs, out.reps) == \
        (ref.points, ref.policies, ref.num_jobs, ref.reps)
    for f in ("mean_response", "ci95_response", "mean_wait", "p_wait",
              "ci95_p_wait", "p_helper", "p95_response", "utilization"):
        assert np.array_equal(getattr(out, f), getattr(ref, f),
                              equal_nan=True), f
    strip = lambda rows: [{c: v for c, v in r.items() if c != "sim_s"}
                          for r in rows]
    assert strip(out.rows("k")) == strip(ref.rows("k"))


def test_bs_queue_cap_overflow_raises():
    wl = workload.figure1_workload(64)
    batch = wl.sample_traces(300, 2, seed=7)
    with pytest.raises(RuntimeError, match="overflow"):
        engines.simulate("bs-fcfs", batch, wl=wl, device="cpu", queue_cap=4)


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wl = workload.figure1_workload(32)
    batch = wl.sample_traces(20, 1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engines.simulate("fcfs", batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engines.simulate_grid("bs-fcfs", [engines.GridCell(batch, wl=wl)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_batch.sweep_many_server(workload.figure1_workload, (32,),
                                    num_jobs=20, reps=1)


def test_loud_errors():
    wl = workload.figure1_workload(32)
    batch = wl.sample_traces(20, 1, seed=0)
    with pytest.raises(KeyError, match="no simulation core"):
        engines.simulate("srpt", batch, device="cpu")
    with pytest.raises(ValueError, match="unknown engine 'torch' for "
                                         "policy 'msf'"):
        engines.simulate("msf", batch, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        engines.simulate("fcfs", batch, engine="jax", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        engines.simulate("fcfs", batch, device="meta")
    kill = FailureProcess(mtbf=5.0, mttr=1.0, mode="kill")
    with pytest.raises(NotImplementedError, match="python engine"):
        engines.simulate("fcfs", batch, device="cpu",
                         failures=kill.sample(32, 20.0, 1))
    with pytest.raises(NotImplementedError, match="python engine"):
        sim_batch.sweep_many_server(workload.figure1_workload, (32,),
                                    device="cpu", failures=kill)
    with pytest.raises(ValueError, match="resume=True needs a ckpt_dir"):
        sim_batch.sweep_many_server(workload.figure1_workload, (32,),
                                    device="cpu", resume=True)
    with pytest.raises(KeyError, match="no 'torch' simulator"):
        sim_batch.sweep_many_server(workload.figure1_workload, (32,),
                                    device="cpu", policies=("msf",))
    bad = workload.BatchTrace.from_arrays(
        batch.arrival, batch.cls, batch.service,
        np.full_like(batch.need, 33), k=32, C=4)
    with pytest.raises(ValueError, match="<= k=32"):
        engines.simulate("fcfs", bad, device="cpu")
    bad = workload.BatchTrace.from_arrays(
        batch.arrival, np.full_like(batch.cls, 4), batch.service,
        batch.need, k=32, C=4)
    with pytest.raises(ValueError, match="class ids"):
        engines.simulate("bs-fcfs", bad, wl=wl, device="cpu")
    with pytest.raises(ValueError, match="class ids"):
        engines.simulate("modbs-fcfs", bad, wl=wl, device="cpu")


def test_registries_are_separate():
    scan = POLICIES + ("sf-srpt", "ff-srpt")
    python = scan + ("serverfilling", "sf-gittins", "msf", "lsf",
                     "backfill", "maxweight")
    assert engines.registered() == tuple(sorted(
        [(p, "torch") for p in scan] + [(p, "python") for p in python]))
    assert engines.grid_registered() == tuple(
        (p, "torch") for p in sorted(scan))
    assert engines.available_engines() == ("python", "torch")
    assert "torch" not in ref_engines.available_engines()
    assert engines.canonical("bs") == "bs-fcfs"


_PURITY = """
import sys
import numpy as np
import repro_torch
from repro_torch.core import (engines, failures, partition, policies,
                              sim_batch, sim_torch, simulator, workload)
from repro_torch.kernels.msj_scan import build, kernel, ops
from repro_torch.bench import decode_vs_forward, fig3_traces
from repro_torch.data import swf
from repro_torch import configs
from repro_torch.kernels import _build, attention_build
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.moe_gmm import build as gmm_build
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.models import (config, convert, layers, model, moe,
                                transformer)
from repro_torch.sched import cluster, gang
from repro_torch.serve import engine, kv_cache
from repro_torch import checkpoint
from repro_torch.checkpoint import ckpt
from repro_torch.core import stream
from repro_torch.bench import stream_cases
from repro_torch.core import erlang, theory
from repro_torch.bench import common, fig1_critical, fig2_regimes, theory_tables
rng = np.random.default_rng(0)
arr = np.cumsum(rng.exponential(0.25, (2, 200)), axis=1)
res = sim_batch.loss_queue_sim_batch(arr, rng.exponential(1.0, (2, 200)), 3,
                                     device="cpu")
assert res.blocked.shape == (2, 200) and res.blocked.any()
rep = theory.analyze(workload.figure1_workload(256))
assert 0 < rep.p_helper_modified < 1
assert erlang.erlang_b_torch(3, 2.0, device="cpu").item() == erlang.erlang_b(3, 2.0)
wl = workload.figure1_workload(32)
src = workload.PoissonSource(wl, reps=2, seed=1)
for pol in ("fcfs", "modbs-fcfs", "bs-fcfs"):
    kw = {"backlog_cap": 32} if pol == "bs-fcfs" else {}
    sr = engines.simulate_stream(pol, src, device="cpu", chunk_jobs=20,
                                 total_jobs=50, wl=wl, **kw)
    assert np.isfinite(sr.mean_response).all()
res = sim_batch.sweep_many_server(workload.figure1_workload, (32,),
                                  num_jobs=50, reps=2, device="cpu")
assert np.isfinite(res.mean_response).all()
res = sim_batch.sweep_many_server(
    workload.figure1_workload, (32,), num_jobs=50, reps=2, device="cpu",
    failures=failures.FailureProcess(mtbf=20.0, mttr=2.0))
assert np.isfinite(res.mean_response).all() and (res.availability < 1).all()
rows = fig3_traces.run(num_jobs=60, reps=2, ks=(128,), loads=(0.7,),
                       device="cpu")
assert len(rows) == 12 and all(np.isfinite(r["mean_response"]) for r in rows)
batch = wl.sample_traces(60, 2, seed=1)
kill = failures.FailureProcess(mtbf=20.0, mttr=2.0, mode="kill").sample(
    32, float(batch.arrival.max()), 2)
for pol in engines.policies_for("python"):
    res = engines.simulate(pol, batch, engine="python", wl=wl, failures=kill)
    assert np.isfinite(res.response).all()
res = simulator.simulate(wl, policies.make_policy("msf"), num_jobs=60)
assert res.num_jobs == 60
eng = engine.ServingEngine([engine.RequestClass(
    "s", configs.get_config("yi_9b"), 8192, 2, 1.0, 1.0)], 8, device="cpu")
eng.submit(engine.Request(0, "s", np.arange(1, 9), max_new_tokens=3))
assert len(eng.run_request(0).output) == 3
eng = engine.ServingEngine([engine.RequestClass(
    "m", configs.get_config("moonshot_v1_16b_a3b"), 8192, 8, 1.0, 1.0)], 8,
    device="cpu")
eng.submit(engine.Request(0, "m", np.arange(1, 9), max_new_tokens=3))
assert len(eng.run_request(0).output) == 3
assert kv_cache.chips_needed(configs.get_config("stablelm_3b"), 1, 8192) >= 1
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""


def test_port_imports_nothing_of_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PURITY], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    sources = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 10
    for path in sources:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (path, s)
            if s.startswith(("import repro", "from repro")):
                mod = s.split()[1]
                assert mod == "repro_torch" or mod.startswith(
                    "repro_torch."), (path, s)
