"""The port's checkpoint module and the crash-resumable paths built on it,
on the CPU.

* ``repro_torch.checkpoint`` — save / restore round trip of numpy and
  torch leaves, a ``.tmp`` left by a crash ignored, malformed ``step_*``
  entries skipped with a warning, keep-last-N, background writes,
  ``require_layout`` naming the stale key, a dtype numpy cannot store
  refused, a bfloat16 leaf stored as bits as the reference stores it —
  and a manifest that reads the same as the reference's;
* streams — a stream resumed mid-way (its last checkpoint deleted) is
  byte-identical for all three policies; a SIGKILLed subprocess stream
  and a SIGKILLed ``sweep_many_server`` resume byte-identical; Fig. 3's
  ``run(ckpt_dir=, resume=True)`` gives the same rows;
* loud failures with the reference's messages — ``resume=True`` without
  ``ckpt_dir``, an exhausted source, a backlog over ``backlog_cap``, a
  changed layout, and an engine or policy that does not stream.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt

from repro_torch import checkpoint
from repro_torch.bench import fig3_traces
from repro_torch.core import engines, workload
from repro_torch.core.sim_batch import sweep_many_server

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs")
FIELDS = ("mean_response", "var_response", "mean_wait", "var_wait",
          "p_wait", "p_helper", "p_routed")


def _tree():
    return {"w": np.arange(6, dtype=np.float64).reshape(2, 3),
            "n": {"b": torch.tensor([1, 2, 3], dtype=torch.int32),
                  "a": [np.ones(2, bool), np.int64(7)]},
            "t": (np.zeros((0,), np.float32),)}


def _like():
    return {"w": 0, "n": {"b": 0, "a": [0, 0]}, "t": (0,)}


def _assert_tree_equal(a, b):
    assert np.array_equal(np.asarray(a["w"]), np.asarray(b["w"]))
    assert np.array_equal(np.asarray(a["n"]["b"]), np.asarray(b["n"]["b"]))
    assert np.array_equal(a["n"]["a"][0], b["n"]["a"][0])
    assert int(a["n"]["a"][1]) == int(b["n"]["a"][1])
    assert a["t"][0].shape == (0,)


def test_save_restore_round_trip(tmp_path):
    d = str(tmp_path)
    path = checkpoint.save_checkpoint(d, 3, _tree(), extra={"k": 32})
    assert os.path.basename(path) == "step_00000003"
    tree, step, extra = checkpoint.restore_checkpoint(d, _like())
    assert step == 3 and extra == {"k": 32}
    _assert_tree_equal(_tree(), tree)
    assert tree["n"]["b"].dtype == np.int32 and isinstance(tree["t"], tuple)
    assert checkpoint.latest_step(d) == 3
    assert checkpoint.completed_steps(d) == [3]


def test_manifest_paths_read_as_the_reference_writes_them(tmp_path):
    """The leaves' paths, files and dtypes in the manifest are the ones
    the reference's JAX tree flatten writes, so its restore reads a
    checkpoint of the port (and the other way round)."""
    tree = {"sim": {"carry": [np.zeros(3), np.ones(2)],
                    "fed": np.asarray(5, np.int64)},
            "acc": {"mean": np.full((2, 2), 0.5)}}
    checkpoint.save_checkpoint(str(tmp_path / "port"), 1, tree)
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1, tree)
    mans = [json.loads((tmp_path / s / "step_00000001" /
                        "manifest.json").read_text()) for s in ("port", "ref")]
    assert mans[0] == mans[1]
    got, _, _ = ref_ckpt.restore_checkpoint(str(tmp_path / "port"), tree)
    assert np.array_equal(got["sim"]["carry"][1], np.ones(2))


def test_tmp_left_by_a_crash_is_ignored(tmp_path):
    d = str(tmp_path)
    checkpoint.save_checkpoint(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    os.makedirs(os.path.join(d, "step_00000003"))       # no manifest yet
    assert checkpoint.latest_step(d) == 1
    assert checkpoint.completed_steps(d) == [1]
    _, step, _ = checkpoint.restore_checkpoint(d, _like())
    assert step == 1


def test_malformed_entries_are_skipped_with_a_warning(tmp_path):
    d = str(tmp_path)
    checkpoint.save_checkpoint(d, 4, _tree())
    os.makedirs(os.path.join(d, "step_final"))
    with pytest.warns(RuntimeWarning, match="step_final"):
        assert checkpoint.latest_step(d) == 4
    mgr = checkpoint.CheckpointManager(d, keep=1)
    with pytest.warns(RuntimeWarning):
        mgr.save(5, _tree())
    assert sorted(os.listdir(d)) == ["step_00000005", "step_final"]


def test_manager_keeps_the_last_n_and_writes_in_the_background(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in range(1, 5):
        mgr.save_async(s, tree)
        tree["w"] += 1                 # the snapshot was taken at the call
    mgr.wait()
    assert checkpoint.completed_steps(str(tmp_path)) == [3, 4]
    got, step, _ = mgr.restore(_like())
    assert step == 4 and np.array_equal(got["w"], _tree()["w"] + 3)
    assert mgr.latest_step() == 4


def test_require_layout_names_the_stale_key():
    checkpoint.require_layout({"k": 32, "reps": 2}, {"k": 32, "reps": 2})
    with pytest.raises(ValueError, match="reps=2.*reps=4.*stale ckpt_dir"):
        checkpoint.require_layout({"k": 32, "reps": 2},
                                  {"k": 32, "reps": 4}, context="of x")


@pytest.mark.parametrize("leaf", [
    np.array([object()]), np.zeros(2, np.complex128)])
def test_dtypes_numpy_cannot_store_are_refused(tmp_path, leaf):
    with pytest.raises(TypeError, match="cannot checkpoint"):
        checkpoint.save_checkpoint(str(tmp_path), 1, {"x": leaf})
    assert checkpoint.latest_step(str(tmp_path)) is None


def test_bfloat16_leaves_round_trip_as_the_reference_stores_them(tmp_path):
    """A bfloat16 tensor is stored as the reference's ``_encode`` stores
    an ml_dtypes bfloat16 array (its bits as uint16, "bfloat16" in the
    manifest): the port restores its own and the reference's checkpoint
    to the same bits, the two manifests and files agree, and the
    reference restores the port's."""
    import jax.numpy as jnp

    bits = np.random.default_rng(0).integers(0, 2 ** 16, 64, dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80       # no inf / nan patterns
    port_leaf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    ref_leaf = jnp.asarray(bits.view(jnp.bfloat16))
    checkpoint.save_checkpoint(str(tmp_path / "port"), 1,
                               {"w": port_leaf, "s": np.float32(2.0)})
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1,
                             {"w": ref_leaf, "s": np.float32(2.0)})
    mans = [json.loads((tmp_path / s / "step_00000001" /
                        "manifest.json").read_text()) for s in ("port", "ref")]
    assert mans[0] == mans[1]
    assert mans[0]["leaves"][1]["dtype"] == "bfloat16"
    for side in ("port", "ref"):
        got, _, _ = checkpoint.restore_checkpoint(str(tmp_path / side),
                                                  {"w": 0, "s": 0})
        assert got["w"].dtype == torch.bfloat16
        assert np.array_equal(got["w"].view(torch.int16).numpy().view(
            np.uint16), bits)
        assert float(got["s"]) == 2.0
    back, _, _ = ref_ckpt.restore_checkpoint(str(tmp_path / "port"),
                                             {"w": ref_leaf, "s": 0})
    assert np.array_equal(np.asarray(back["w"]).view(np.uint16), bits)


def test_restore_without_checkpoints_fails_loudly(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        checkpoint.restore_checkpoint(str(tmp_path), _like())


# -- streams -----------------------------------------------------------------


def _assert_stream_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.tobytes() == y.tobytes(), f


def _steps(d):
    return sorted(e for e in os.listdir(d)
                  if e.startswith("step_") and not e.endswith(".tmp"))


def _kw(pol):
    return {"backlog_cap": 48} if pol == "bs-fcfs" else {}


@pytest.mark.parametrize("pol", POLICIES)
def test_stream_resumed_mid_way_is_byte_identical(pol, tmp_path):
    """Delete the last checkpoint of a finished stream and resume: the
    driver fetches and scans the tail chunk again, and every observable
    comes out byte-identical to the uninterrupted run."""
    wl = workload.figure1_workload(32)
    d = str(tmp_path / "ckpt")
    kw = dict(chunk_jobs=60, total_jobs=300, wl=wl, device="cpu",
              **_kw(pol))
    src = lambda: workload.DiurnalSource(wl, reps=2, seed=4, period=30.0)
    ref = engines.simulate_stream(pol, src(), **kw)
    full = engines.simulate_stream(pol, src(), ckpt_dir=d, **kw)
    _assert_stream_equal(ref, full)
    assert len(_steps(d)) == 2                     # the last two kept
    shutil.rmtree(os.path.join(d, _steps(d)[-1]))
    res = engines.simulate_stream(pol, src(), ckpt_dir=d, resume=True, **kw)
    _assert_stream_equal(ref, res)
    fresh = engines.simulate_stream(pol, src(), ckpt_dir=str(tmp_path / "e"),
                                    resume=True, **kw)
    _assert_stream_equal(ref, fresh)               # nothing to resume from


def test_stream_resume_rejects_a_changed_layout(tmp_path):
    wl = workload.figure1_workload(32)
    d = str(tmp_path / "ckpt")
    src = lambda: workload.PoissonSource(wl, reps=2, seed=4)
    kw = dict(total_jobs=240, wl=wl, device="cpu", ckpt_dir=d)
    engines.simulate_stream("fcfs", src(), chunk_jobs=60, **kw)
    with pytest.raises(ValueError, match="chunk_jobs=60.*stale ckpt_dir"):
        engines.simulate_stream("fcfs", src(), chunk_jobs=40, resume=True,
                                **kw)
    with pytest.raises(ValueError, match="policy='fcfs'"):
        engines.simulate_stream("modbs-fcfs", src(), chunk_jobs=60,
                                resume=True, **kw)


def test_stream_failures_are_loud():
    assert engines.stream_registered() == tuple(
        (p, "torch") for p in sorted(POLICIES))
    wl = workload.figure1_workload(32)
    batch = wl.sample_traces(100, 2, seed=0)
    with pytest.raises(ValueError, match="resume=True needs a ckpt_dir"):
        engines.simulate_stream("fcfs", batch, chunk_jobs=50, wl=wl,
                                device="cpu", resume=True)
    with pytest.raises(ValueError, match="exhausted"):
        engines.simulate_stream("fcfs", batch, chunk_jobs=60,
                                total_jobs=200, wl=wl, device="cpu")
    with pytest.raises(ValueError, match="total_jobs is required"):
        engines.simulate_stream("fcfs", workload.PoissonSource(wl, reps=2),
                                chunk_jobs=60, wl=wl, device="cpu")
    with pytest.raises(ValueError, match="streaming engines: \\['torch'\\]"):
        engines.simulate_stream("fcfs", batch, engine="pallas",
                                chunk_jobs=50, wl=wl, device="cpu")
    with pytest.raises(KeyError, match="no streaming core for policy"):
        engines.simulate_stream("sf-srpt", batch, chunk_jobs=50, wl=wl,
                                device="cpu")
    # heavily overloaded: the queue grows without bound, so a one-job
    # backlog cap overflows at the first chunk boundary
    hot = workload.Workload(k=4, lam=8.0, classes=(
        workload.JobClass("a", 2, workload.Exp(1.0), 1.0),))
    with pytest.raises(RuntimeError, match="streaming backlog overflow"):
        engines.simulate_stream("bs-fcfs",
                                workload.PoissonSource(hot, reps=2, seed=0),
                                chunk_jobs=40, total_jobs=160, wl=hot,
                                backlog_cap=1, device="cpu")
    with pytest.raises(RuntimeError, match="helper-wait ring buffer "
                                           "overflow"):
        engines.simulate_stream("bs-fcfs",
                                workload.PoissonSource(hot, reps=2, seed=0),
                                chunk_jobs=40, total_jobs=160, wl=hot,
                                backlog_cap=500, queue_cap=3, device="cpu")


def test_stream_defaults_to_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    wl = workload.figure1_workload(32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engines.simulate_stream("fcfs", wl.sample_traces(50, 2),
                                chunk_jobs=25, wl=wl)


# -- SIGKILL a driver mid-run --------------------------------------------------


_STREAM_DRIVER = """\
import sys
from repro_torch.core import engines, workload

wl = workload.figure1_workload(32)
src = workload.DiurnalSource(wl, reps=2, seed=7, period=30.0)
res = engines.simulate_stream(
    "modbs-fcfs", src, chunk_jobs=200, total_jobs=20_000, wl=wl,
    device="cpu", ckpt_dir=sys.argv[1], resume="--resume" in sys.argv)
for f in ("mean_response", "var_response", "mean_wait", "var_wait",
          "p_wait", "p_helper", "p_routed"):
    print(f, getattr(res, f).tobytes().hex())
"""

_SWEEP_DRIVER = """\
import sys
import numpy as np
from repro_torch.core import sim_batch, workload

res = sim_batch.sweep_many_server(
    workload.figure1_workload, (32, 64), num_jobs=200, reps=2,
    policies=("fcfs", "bs-fcfs"), device="cpu", grid=False,
    ckpt_dir=sys.argv[1], resume="--resume" in sys.argv)
for f in ("mean_response", "ci95_response", "mean_wait", "p_wait",
          "ci95_p_wait", "p_helper", "p95_response", "utilization",
          "sim_s"):
    print(f, getattr(res, f).tobytes().hex())
"""


def _run(cmd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)


def _kill_once_checkpointed(cmd, d):
    """Start ``cmd``, SIGKILL it once a finished step is on disk."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = time.time() + 300
    killed = False
    while time.time() < deadline and proc.poll() is None:
        if os.path.isdir(d) and _steps(d):
            proc.send_signal(signal.SIGKILL)
            killed = True
            break
        time.sleep(0.02)
    else:
        proc.kill()
    proc.wait()
    return killed


def _without_sim_s(text):
    return "\n".join(l for l in text.splitlines()
                     if not l.startswith("sim_s "))


@pytest.mark.parametrize("which", ["stream", "sweep"])
def test_sigkilled_driver_resumes_byte_identical(which, tmp_path):
    """SIGKILL a stream (or a sweep) once it has checkpointed; resuming
    finishes it with every observable byte-identical to an uninterrupted
    run (a sweep's ``sim_s`` is wall time, honest per process), and a
    second resume of the finished sweep restores every cell, ``sim_s``
    included."""
    driver = tmp_path / "driver.py"
    driver.write_text(_STREAM_DRIVER if which == "stream" else _SWEEP_DRIVER)
    cmd = lambda d, *a: [sys.executable, str(driver), d, *a]
    clean = _run(cmd(str(tmp_path / "a")))
    assert clean.returncode == 0, clean.stderr
    d = str(tmp_path / "b")
    killed = _kill_once_checkpointed(cmd(d), d)
    resumed = _run(cmd(d, "--resume"))
    assert resumed.returncode == 0, resumed.stderr
    assert _without_sim_s(resumed.stdout) == _without_sim_s(clean.stdout)
    assert killed or which == "sweep"
    if which == "sweep":
        again = _run(cmd(d, "--resume"))
        assert again.stdout == resumed.stdout


# -- sweeps and Fig. 3 ---------------------------------------------------------


def _sweep(**kw):
    return sweep_many_server(workload.figure1_workload, (32, 64),
                             num_jobs=200, reps=2, policies=("fcfs",
                                                             "bs-fcfs"),
                             device="cpu", **kw)


ARRAYS = ("mean_response", "ci95_response", "mean_wait", "p_wait",
          "ci95_p_wait", "p_helper", "p95_response", "utilization")


@pytest.mark.parametrize("grid", [True, False])
def test_sweep_resume_restores_and_completes(grid, tmp_path):
    """Every cell is its own step (point * P + policy); a full resume
    restores them all without simulating (``sim_s`` equal proves it), a
    partial one simulates the missing cells, in either path."""
    d = str(tmp_path / "ckpt")
    ref = _sweep(ckpt_dir=d, grid=grid)
    assert checkpoint.completed_steps(d) == [0, 1, 2, 3]
    full = _sweep(ckpt_dir=d, resume=True, grid=not grid)
    for f in ARRAYS + ("sim_s",):
        assert np.array_equal(getattr(ref, f), getattr(full, f),
                              equal_nan=True), f
    for cell in (2, 3):
        shutil.rmtree(os.path.join(d, f"step_{cell:08d}"))
    part = _sweep(ckpt_dir=d, resume=True, grid=grid)
    for f in ARRAYS:
        assert np.array_equal(getattr(ref, f), getattr(part, f),
                              equal_nan=True), f
    assert np.array_equal(ref.sim_s[:, 0], part.sim_s[:, 0])


def test_sweep_resume_guards(tmp_path):
    with pytest.raises(ValueError, match="needs a ckpt_dir"):
        _sweep(resume=True)
    d = str(tmp_path / "ckpt")
    _sweep(ckpt_dir=d)
    with pytest.raises(ValueError, match="stale ckpt_dir"):
        sweep_many_server(workload.figure1_workload, (32, 64),
                          num_jobs=200, reps=2,
                          policies=("bs-fcfs", "fcfs"), device="cpu",
                          ckpt_dir=d, resume=True)


def test_faulty_sweep_resumes_with_its_availability(tmp_path):
    from repro_torch.core.failures import FailureProcess

    d = str(tmp_path / "ckpt")
    kw = dict(num_jobs=200, reps=2, policies=("fcfs",), device="cpu",
              failures=FailureProcess(mtbf=50.0, mttr=5.0))
    ref = sweep_many_server(workload.figure1_workload, (32,), ckpt_dir=d,
                            **kw)
    res = sweep_many_server(workload.figure1_workload, (32,), ckpt_dir=d,
                            resume=True, **kw)
    for f in ARRAYS + ("sim_s", "availability"):
        assert np.array_equal(getattr(ref, f), getattr(res, f),
                              equal_nan=True), f


def test_fig3_resume_gives_the_same_rows(tmp_path):
    d = str(tmp_path / "ckpt")
    kw = dict(num_jobs=300, ks=(128,), loads=(0.5, 0.7), reps=2,
              policies=("fcfs", "bs-fcfs"), device="cpu")
    ref = fig3_traces.run(ckpt_dir=d, **kw)
    res = fig3_traces.run(ckpt_dir=d, resume=True, **kw)
    assert ref == res                 # JSON round-trips the floats exactly
    shutil.rmtree(os.path.join(d, "step_00000001"))
    part = fig3_traces.run(ckpt_dir=d, resume=True, grid=False, **kw)
    strip = lambda rows: [{c: v for c, v in r.items() if c != "sim_s"}
                          for r in rows]
    assert strip(part) == strip(ref)
    with pytest.raises(ValueError, match="stale ckpt_dir"):
        fig3_traces.run(ckpt_dir=d, resume=True, **{**kw, "loads": (0.85,
                                                                   0.7)})
    with pytest.raises(ValueError, match="needs a ckpt_dir"):
        fig3_traces.run(resume=True, **kw)

