"""The port's ``engine="python"`` against the reference's, rtol=0, and the
registry parity it anchors.

``engines.simulate(policy, batch, engine="python")`` runs the port's own
copy of the reference's event engine (``core/simulator.py``) and must give
the reference's ``engine="python"`` result on every ``BatchSimResult``
field, for all eleven policies, clean and with kill-mode failures, and for
the three drain policies under drain-mode failures.  The port's
``"torch"`` cores (on the CPU: the kernels' plain versions) must equal
``"python"`` on the five scan policies, as the reference's registry
contract asks of every engine.  Also: ``fallback=`` warns once per pair
and never moves a policy that has a ``"torch"`` core, ``simulate_grid``
on ``"python"`` runs cell by cell, and ``sweep_many_server`` sweeps any
python pair.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from _torch_jaxref import port_batch, ref_engines, ref_workload
from repro.core import failures as ref_failures
from repro.core import sim_batch as ref_sim_batch

from repro_torch.bench import bs_cases
from repro_torch.core import engines, failures, sim_batch, workload

PYTHON_POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs", "serverfilling",
                   "sf-srpt", "sf-gittins", "ff-srpt", "msf", "lsf",
                   "backfill", "maxweight")
SCAN_POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs", "sf-srpt", "ff-srpt")
DRAIN_POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs")


def _assert_same_result(out, ref, what, fields=None):
    for f in fields or [f.name for f in dataclasses.fields(ref)]:
        a, b = getattr(out, f), getattr(ref, f)
        assert (a is None) == (b is None), (what, f)
        if a is not None:
            assert a.dtype == b.dtype, (what, f)
            assert np.array_equal(a, b), (what, f)


def _batch(k, J=300, R=2, seed=17):
    """(port batch, reference batch, port wl, reference wl): Fig. 1."""
    rwl = ref_workload.figure1_workload(k)
    rb = rwl.sample_traces(J, R, seed=seed)
    return port_batch(rb), rb, workload.figure1_workload(k), rwl


def _kill(k, batch, seed=1):
    """A kill-mode outage history for ``batch`` on both sides."""
    h = float(batch.arrival.max())
    kw = dict(mtbf=h / 3, mttr=h / 30, pod_size=2, mode="kill")
    return (failures.FailureProcess(**kw).sample(k, h, batch.reps, seed=seed),
            ref_failures.FailureProcess(**kw).sample(k, h, batch.reps,
                                                     seed=seed))


@pytest.mark.parametrize("k", [32, 256])
@pytest.mark.parametrize("policy", PYTHON_POLICIES)
def test_python_engine_equals_reference(policy, k):
    b, rb, wl, rwl = _batch(k)
    out = engines.simulate(policy, b, engine="python", wl=wl)
    ref = ref_engines.simulate(policy, rb, engine="python", wl=rwl)
    _assert_same_result(out, ref, (policy, k))


@pytest.mark.parametrize("policy", PYTHON_POLICIES)
def test_kill_mode_equals_reference(policy):
    b, rb, wl, rwl = _batch(32)
    fb, rfb = _kill(32, b)
    out = engines.simulate(policy, b, engine="python", wl=wl, failures=fb)
    ref = ref_engines.simulate(policy, rb, engine="python", wl=rwl,
                               failures=rfb)
    _assert_same_result(out, ref, policy)
    assert out.kills.sum() > 0 and (out.kills == out.requeues).all()
    assert ((out.availability > 0) & (out.availability < 1)).all()


def test_bs_kill_mode_without_demands_raises_the_reference_error():
    """BS-π built from a bare partition cannot repartition on a capacity
    change: the reference's ``ValueError``, word for word."""
    b, rb, wl, rwl = _batch(32)
    fb, rfb = _kill(32, b)
    from repro.core.partition import balanced_partition as ref_partition
    from repro_torch.core.partition import balanced_partition
    with pytest.raises(ValueError) as ref_err:
        ref_engines.simulate("bs-fcfs", rb, engine="python",
                             partition=ref_partition(rwl), failures=rfb)
    with pytest.raises(ValueError) as err:
        engines.simulate("bs-fcfs", b, engine="python",
                         partition=balanced_partition(wl), failures=fb)
    assert str(err.value) == str(ref_err.value)
    assert "without class demands" in str(err.value)


@pytest.mark.parametrize("k", [32, 256])
@pytest.mark.parametrize("policy", DRAIN_POLICIES)
def test_drain_mode_python_equals_reference_and_torch(policy, k):
    b, rb, wl, rwl = _batch(k)
    fb = bs_cases.bench_failures(wl, b, "heavy", seed=4)
    rfb = ref_failures.FailureBatch(
        t_down=fb.t_down, t_up=fb.t_up, server=fb.server, count=fb.count,
        k=fb.k, horizon=fb.horizon, mode=fb.mode)
    out = engines.simulate(policy, b, engine="python", wl=wl, failures=fb)
    ref = ref_engines.simulate(policy, rb, engine="python", wl=rwl,
                               failures=rfb)
    _assert_same_result(out, ref, (policy, k))
    _assert_same_result(
        engines.simulate(policy, b, wl=wl, failures=fb, device="cpu"), out,
        (policy, k, "torch"))


@pytest.mark.parametrize("k", [32, 256])
@pytest.mark.parametrize("policy", SCAN_POLICIES)
def test_torch_on_cpu_equals_python(policy, k):
    b, _, wl, _ = _batch(k, J=400, seed=5)
    _assert_same_result(engines.simulate(policy, b, wl=wl, device="cpu"),
                        engines.simulate(policy, b, engine="python", wl=wl),
                        (policy, k))


def test_torch_cores_refuse_kill_mode_naming_the_python_engine():
    b, _, wl, _ = _batch(32, J=50)
    fb, _ = _kill(32, b)
    for policy in SCAN_POLICIES:
        with pytest.raises(NotImplementedError, match="python"):
            engines.simulate(policy, b, wl=wl, failures=fb, device="cpu")


def test_fallback_warns_once_and_never_moves_a_torch_policy(monkeypatch):
    monkeypatch.setattr(engines, "_WARNED_FALLBACKS", set())
    b, _, wl, _ = _batch(32, J=100)
    want = engines.simulate("msf", b, engine="python")
    with pytest.raises(ValueError, match="unknown engine 'torch'"):
        engines.simulate("msf", b, device="cpu")
    with pytest.warns(RuntimeWarning, match="'msf' has no engine 'torch'"):
        got = engines.simulate("msf", b, device="cpu", fallback=True)
    _assert_same_result(got, want, "msf")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        engines.simulate("msf", b, device="cpu", fallback=True)
        engines.simulate_grid("msf", [engines.GridCell(b, wl=wl)],
                              fallback=True)
        engines.simulate("fcfs", b, device="cpu", fallback=True)
    with pytest.warns(RuntimeWarning, match="'serverfilling'"):
        engines.simulate_grid("serverfilling", [engines.GridCell(b, wl=wl)],
                              fallback=True)
    with pytest.raises(KeyError, match="no simulation core"):
        engines.simulate("srpt", b, device="cpu", fallback=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engines.simulate("fcfs", b, fallback=True)
        # the host oracle takes no device: the default "cuda" is ignored
        _assert_same_result(engines.simulate("msf", b, engine="python"),
                            want, "msf on the default device")


@pytest.mark.parametrize("policy", ["bs-fcfs", "msf", "sf-srpt"])
def test_simulate_grid_python_equals_per_cell(policy):
    cells = []
    for k, J, seed in ((32, 200, 5), (256, 120, 6)):
        b, _, wl, _ = _batch(k, J=J, seed=seed)
        cells.append(engines.GridCell(b, wl=wl, queue_cap=J))
    out = engines.simulate_grid(policy, cells, engine="python")
    assert len(out) == len(cells)
    for g, (cell, o) in enumerate(zip(cells, out)):
        _assert_same_result(o, engines.simulate(
            policy, cell.batch, engine="python", wl=cell.wl), (policy, g))


def test_sweep_many_server_python_equals_reference():
    kw = dict(num_jobs=200, reps=2, seed=2,
              policies=("bs-fcfs", "serverfilling", "msf"), engine="python")
    out = sim_batch.sweep_many_server(workload.figure1_workload, (32, 64),
                                      **kw)
    ref = ref_sim_batch.sweep_many_server(ref_workload.figure1_workload,
                                          (32, 64), **kw)
    for f in ("mean_response", "ci95_response", "mean_wait", "p_wait",
              "ci95_p_wait", "p_helper", "p95_response", "utilization"):
        assert np.array_equal(getattr(out, f), getattr(ref, f),
                              equal_nan=True), f
