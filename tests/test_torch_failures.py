"""Drain-mode failures on the port against the JAX reference, rtol=0.

The port keeps its own copy of ``repro.core.failures``: sampling, the
capacity observables, the event->block mapping and the merged
arrival+failure stream must equal the reference's array for array.  On
this CPU the ``*_fail_scan`` wrappers run their plain PyTorch versions;
each must equal the reference's Pallas kernel (interpret mode) and its
vmapped scan core on the same merged arrays, on every raw output, failure
rows included.  ``engines.simulate(..., failures=)`` and
``sweep_many_server(..., failures=)`` must give the reference's results
field by field, ``kills``/``requeues``/``availability`` included.  The
reference's ``jax-shard`` engine is left out: on JAX 0.9 its drain-mode
BS-π fails its shard_map scan's carry-type check (ROADMAP Queue 3, R4).
The CUDA kernels are held to the same plain versions on the card by
``chip_smoke.py`` and by ``tests/test_torch_card.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_jaxref import ref_engines, ref_workload, x64

import jax.numpy as jnp
from repro.core import failures as ref_flr
from repro.core import sim_batch as ref_sim_batch
from repro.core.partition import balanced_partition as ref_partition
from repro.kernels.msj_scan import kernel as ref_kernel

from repro_torch.core import engines, sim_batch, workload
from repro_torch.core import failures as flr
from repro_torch.core.partition import balanced_partition
from repro_torch.core.sim_batch import QueueOverflowError
from repro_torch.core.sim_torch import _bs_args
from repro_torch.kernels.msj_scan import kernel as K

POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs")
FIELDS = ("response", "wait", "start", "blocked", "p_helper", "p_routed",
          "kills", "requeues", "availability")


def small_workload(mod, k=32, load=0.8):
    """``tests/test_failures.py``'s three-class workload, from ``mod`` (the
    reference's or the port's workload module)."""
    classes = (mod.JobClass("s", 1, mod.Exp(1.0), 0.7),
               mod.JobClass("m", 4, mod.Exp(4.0), 0.2),
               mod.JobClass("l", 8, mod.Exp(8.0), 0.1))
    return mod.Workload(k=k, lam=1.0, classes=classes).with_load(load)


def faulty(k, num_jobs=400, reps=2, seed=0, mtbf=40.0, mttr=6.0,
           pod_size=1, mode="drain"):
    """The same seeded batch and outage history on both sides:
    (ref wl, ref batch, ref fb, port wl, port batch, port fb)."""
    rwl = small_workload(ref_workload, k)
    pwl = small_workload(workload, k)
    rb = rwl.sample_traces(num_jobs, reps, seed=seed)
    pb = pwl.sample_traces(num_jobs, reps, seed=seed)
    h = float(rb.arrival.max())
    rfb = ref_flr.FailureProcess(mtbf, mttr, pod_size, mode).sample(
        k, h, reps, seed=seed)
    pfb = flr.FailureProcess(mtbf, mttr, pod_size, mode).sample(
        k, h, reps, seed=seed)
    return rwl, rb, rfb, pwl, pb, pfb


def assert_same_result(out, ref, fields=FIELDS):
    for f in fields:
        a, b = getattr(out, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            assert np.array_equal(a, b), f


def assert_arrays_equal(out, ref):
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


# -- the failures module -----------------------------------------------------


@pytest.mark.parametrize("pod_size", [1, 4])
def test_failure_process_sample_equals_reference(pod_size):
    for mode in ("drain", "kill"):
        a = ref_flr.FailureProcess(15.0, 3.0, pod_size, mode).sample(
            16, 300.0, 3, seed=5)
        b = flr.FailureProcess(15.0, 3.0, pod_size, mode).sample(
            16, 300.0, 3, seed=5)
        for f in ("t_down", "t_up", "server", "count"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
            assert getattr(a, f).dtype == getattr(b, f).dtype, f
        assert (a.k, a.horizon, a.mode) == (b.k, b.horizon, b.mode)
        assert b.count.min() > 0
    tr = np.random.Generator(workload.replication_stream(7, 1)).random(4)
    fl = np.random.Generator(flr.failure_stream(7, 1)).random(4)
    assert np.array_equal(
        fl, np.random.Generator(ref_flr.failure_stream(7, 1)).random(4))
    assert not np.array_equal(tr, fl)


def test_failure_process_rejects_what_the_reference_rejects():
    for kw, match in ((dict(mtbf=0.0, mttr=1.0), "mtbf and mttr"),
                      (dict(mtbf=1.0, mttr=1.0, pod_size=0), "pod_size"),
                      (dict(mtbf=1.0, mttr=1.0, mode="preempt"), "mode")):
        with pytest.raises(ValueError, match=match):
            ref_flr.FailureProcess(**kw)
        with pytest.raises(ValueError, match=match):
            flr.FailureProcess(**kw)
    proc = flr.FailureProcess(mtbf=10.0, mttr=1.0)
    for args, match in (((0, 100.0, 2), "k must be"),
                        ((4, 100.0, 0), "replication"),
                        ((4, np.inf, 2), "horizon")):
        with pytest.raises(ValueError, match=match):
            proc.sample(*args)
    with pytest.raises(ValueError, match=r"\[R, E\]"):
        flr.FailureBatch(t_down=np.zeros((2, 3)), t_up=np.zeros((2, 2)),
                         server=np.zeros((2, 3), np.int64),
                         count=np.zeros(2, np.int64), k=4, horizon=1.0)


@pytest.mark.parametrize("pod_size", [1, 4])
def test_failure_batch_observables_equal_reference(pod_size):
    a = ref_flr.FailureProcess(15.0, 3.0, pod_size).sample(16, 300.0, 2,
                                                           seed=1)
    b = flr.FailureProcess(15.0, 3.0, pod_size).sample(16, 300.0, 2, seed=1)
    for r in range(2):
        assert_arrays_equal(b.capacity_trace(r), a.capacity_trace(r))
        assert b.grouped_events(r) == a.grouped_events(r)
        times = a.capacity_trace(r)[0]
        for t in np.concatenate([times[:8], times[:8] + 0.5, [0.0, 1e9]]):
            assert b.k_live(r, float(t)) == a.k_live(r, float(t))
    for horizon in (50.0, 300.0, np.array([120.0, 330.5])):
        assert_arrays_equal([b.availability(horizon)],
                            [a.availability(horizon)])
    if pod_size == 4:
        assert any(m == 4 for _, _, m in b.grouped_events(0))


@pytest.mark.parametrize("pod_size", [1, 4])
def test_partition_targets_equal_reference(pod_size):
    rwl = small_workload(ref_workload, 32)
    pwl = small_workload(workload, 32)
    rpart, ppart = ref_partition(rwl), balanced_partition(pwl)
    a = ref_flr.FailureProcess(30.0, 4.0, pod_size).sample(32, 400.0, 3,
                                                           seed=3)
    b = flr.FailureProcess(30.0, 4.0, pod_size).sample(32, 400.0, 3, seed=3)
    out = flr.partition_targets(b, ppart)
    assert_arrays_equal(out, ref_flr.partition_targets(a, rpart))
    t, tgt, _, count = out
    C = ppart.C
    real = np.arange(t.shape[1])[None, :] < count[:, None]
    assert (tgt[real] == C).any() and (tgt[real] < C).any()  # both blocks
    if pod_size == 4:          # pod rows in one gang slot collapse to one
        assert count.sum() < b.count.sum()
    assert_arrays_equal(flr.fcfs_targets(b), ref_flr.fcfs_targets(a))
    with pytest.raises(ValueError, match="k="):
        flr.partition_targets(flr.FailureProcess(30.0, 4.0).sample(
            33, 400.0, 1), ppart)


@pytest.mark.parametrize("targets", ["fcfs", "partition"])
def test_merge_failure_stream_equals_reference(targets):
    rwl, rb, rfb, pwl, pb, pfb = faulty(32, num_jobs=300, reps=3, seed=4)
    if targets == "fcfs":
        rt, pt, pad = (ref_flr.fcfs_targets(rfb), flr.fcfs_targets(pfb), 0)
    else:
        rt = ref_flr.partition_targets(rfb, ref_partition(rwl))
        pt = flr.partition_targets(pfb, balanced_partition(pwl))
        pad = balanced_partition(pwl).C
    a = ref_flr.merge_failure_stream(rb, *rt, pad_cls=pad)
    b = flr.merge_failure_stream(pb, *pt, pad_cls=pad)
    for f in dataclasses.fields(a):
        assert_arrays_equal([getattr(b, f.name)], [getattr(a, f.name)])
    assert (b.is_fail == 1).sum() == pt[3].sum() + (b.t == np.inf).sum()


# -- drain parity through the entry points -----------------------------------


@functools.lru_cache(maxsize=None)
def _drain_case(k):
    return faulty(k, num_jobs=400, reps=2, seed=k)


@functools.lru_cache(maxsize=None)
def _port_drain(policy, k):
    _, _, _, pwl, pb, pfb = _drain_case(k)
    return engines.simulate(policy, pb, wl=pwl, device="cpu", failures=pfb)


@pytest.mark.parametrize("engine", ["python", "jax", "pallas"])
@pytest.mark.parametrize("k", [32, 256])
@pytest.mark.parametrize("policy", POLICIES)
def test_drain_parity_with_reference_engines(policy, k, engine):
    rwl, rb, rfb, _, _, _ = _drain_case(k)
    ref = ref_engines.simulate(policy, rb, engine=engine, wl=rwl,
                               failures=rfb)
    out = _port_drain(policy, k)
    assert_same_result(out, ref)
    assert (out.kills == 0).all() and (out.requeues == 0).all()
    assert ((out.availability > 0) & (out.availability < 1)).all()


# -- each plain fail kernel against the reference's Pallas kernel ------------


def _kernel_case(k, seed=11):
    """Merged inputs of the three fail kernels, as numpy, for both sides."""
    rwl, rb, rfb, pwl, pb, pfb = faulty(k, num_jobs=300, reps=2, seed=seed,
                                        mtbf=30.0, mttr=5.0, pod_size=2)
    slots, s_max, h, q_cap = _bs_args(pb, None, pwl, None)
    msf = sim_batch._merged_fcfs_inputs(pb, pfb)
    msc = sim_batch._merged_class_inputs(pb, pfb, None, pwl)
    frec = sim_batch._bs_fail_args(pb, pfb, None, pwl)
    assert_arrays_equal(frec, ref_sim_batch._bs_fail_args(rb, rfb, None, rwl))
    return pb, slots, s_max, h, q_cap, msf, msc, frec


def _merged(ms):
    return (ms.t, ms.cls, ms.need, ms.service, ms.t_up, ms.is_fail != 0)


_DT = (np.float64, np.int32, np.int32, np.float64, np.float64, np.bool_)


def _port_fail(name, case, device="cpu"):
    pb, slots, s_max, h, q_cap, msf, msc, (ft, ftgt, fup, length) = case

    def T(x, dtype=None):
        return torch.tensor(np.asarray(x, dtype), device=device)
    sl = T(slots, np.int32)
    if name == "fcfs":
        t, _, n, v, tu, isf = (T(x, d) for x, d in zip(_merged(msf), _DT))
        return (K.fcfs_fail_scan_fwd(t, n, v, tu, isf, k=pb.k),)
    if name == "modbs":
        m = (T(x, d) for x, d in zip(_merged(msc), _DT))
        return K.modbs_fail_scan_fwd(*m, sl, s_max=s_max, h=h)
    return K.bs_fail_scan_fwd(
        T(pb.arrival), T(pb.cls, np.int32), T(pb.need, np.int32),
        T(pb.service), T(ft), T(ftgt, np.int32), T(fup), sl, s_max=s_max,
        h=h, q_cap=q_cap, length=length)


def _ref_fail(name, which, case):
    pb, slots, s_max, h, q_cap, msf, msc, (ft, ftgt, fup, length) = case
    jdt = (jnp.float64, jnp.int32, jnp.int32, jnp.float64, jnp.float64,
           jnp.bool_)
    sl = jnp.asarray(slots, jnp.int32)
    if name == "fcfs":
        t, _, n, v, tu, isf = (jnp.asarray(x, d)
                               for x, d in zip(_merged(msf), jdt))
        if which == "pallas":
            return (ref_kernel.fcfs_fail_scan_fwd(t, n, v, tu, isf, k=pb.k,
                                                  interpret=True),)
        return (ref_sim_batch._fcfs_fail_scan_batch(t, n, v, tu, isf,
                                                    pb.k),)
    if name == "modbs":
        m = [jnp.asarray(x, d) for x, d in zip(_merged(msc), jdt)]
        if which == "pallas":
            return ref_kernel.modbs_fail_scan_fwd(*m, sl, s_max=s_max, h=h,
                                                  interpret=True)
        return ref_sim_batch._modbs_fail_scan_batch(*m, sl, s_max, h)
    args = (jnp.asarray(pb.arrival, jnp.float64),
            jnp.asarray(pb.cls, jnp.int32), jnp.asarray(pb.need, jnp.int32),
            jnp.asarray(pb.service, jnp.float64),
            jnp.asarray(ft, jnp.float64), jnp.asarray(ftgt, jnp.int32),
            jnp.asarray(fup, jnp.float64))
    if which == "pallas":
        return ref_kernel.bs_fail_scan_fwd(*args, sl, s_max=s_max, h=h,
                                           q_cap=q_cap, length=length,
                                           interpret=True)
    return ref_sim_batch._bs_fail_scan_batch(*args, sl, s_max, h, q_cap,
                                             length)


@pytest.mark.parametrize("which", ["pallas", "jax"])
@pytest.mark.parametrize("k", [32, 256])
@pytest.mark.parametrize("name", ["fcfs", "modbs", "bs"])
def test_plain_fail_kernels_bit_equal_to_reference(name, k, which):
    """Raw outputs over every merged row / scan step, failure rows and
    trailing no-op steps included."""
    case = _kernel_case(k)
    out = [o.numpy() for o in _port_fail(name, case)]
    with x64():
        ref = [np.asarray(r) for r in _ref_fail(name, which, case)]
    assert_arrays_equal(out, ref)
    if name == "fcfs":
        assert np.isinf(out[0]).any()     # pad rows: start = +inf


def test_fail_wrappers_check_inputs_and_count_only_kernel_launches():
    pb, slots, s_max, h, q_cap, msf, msc, (ft, ftgt, fup, length) = \
        _kernel_case(32)
    t, c, n, v, tu, isf = (torch.tensor(np.asarray(x, d))
                           for x, d in zip(_merged(msc), _DT))
    sl = torch.tensor(slots, dtype=torch.int32)
    trace = (torch.tensor(pb.arrival), torch.tensor(pb.cls, dtype=torch.int32),
             torch.tensor(pb.need, dtype=torch.int32),
             torch.tensor(pb.service))
    frec = (torch.tensor(ft), torch.tensor(ftgt, dtype=torch.int32),
            torch.tensor(fup))
    kw_b = dict(s_max=s_max, h=h, q_cap=q_cap, length=length)
    K.reset_launches()
    K.fcfs_fail_scan_fwd(t, n, v, tu, isf, k=32)
    K.modbs_fail_scan_fwd(t, c, n, v, tu, isf, sl, s_max=s_max, h=h)
    K.bs_fail_scan_fwd(*trace, *frec, sl, **kw_b)
    assert not any(K.launches().values())
    with pytest.raises(TypeError, match="is_fail must be torch.bool"):
        K.fcfs_fail_scan_fwd(t, n, v, tu, isf.int(), k=32)
    with pytest.raises(ValueError, match="shape"):
        K.modbs_fail_scan_fwd(t, c, n, v, tu[:, :5], isf, sl, s_max=s_max,
                              h=h)
    with pytest.raises(ValueError, match=r"F>=1"):
        K.bs_fail_scan_fwd(*trace, *(x[:, :0] for x in frec), sl, **kw_b)
    with pytest.raises(TypeError, match="ftgt must be torch.int32"):
        K.bs_fail_scan_fwd(*trace, frec[0], frec[1].long(), frec[2], sl,
                           **kw_b)
    with pytest.raises(ValueError, match="length"):
        K.bs_fail_scan_fwd(*trace, *frec, sl, **dict(kw_b, length=-1))


# -- edge cases --------------------------------------------------------------


def _empty_failures(mod, k, reps):
    return mod.FailureBatch(t_down=np.zeros((reps, 0)),
                            t_up=np.zeros((reps, 0)),
                            server=np.zeros((reps, 0), np.int64),
                            count=np.zeros(reps, np.int64), k=k,
                            horizon=100.0)


@pytest.mark.parametrize("policy", POLICIES)
def test_empty_failure_batch_equals_the_clean_run(policy):
    """No failure event: FCFS/ModBS merge nothing, BS-π takes the F = 0
    path with one +inf pad record; the scan equals the clean run."""
    rwl, rb, _, pwl, pb, _ = faulty(32, num_jobs=300, reps=2, seed=9)
    out = engines.simulate(policy, pb, wl=pwl, device="cpu",
                           failures=_empty_failures(flr, 32, 2))
    ref = ref_engines.simulate(policy, rb, engine="jax", wl=rwl,
                               failures=_empty_failures(ref_flr, 32, 2))
    assert_same_result(out, ref)
    clean = engines.simulate(policy, pb, wl=pwl, device="cpu")
    assert_same_result(out, clean, FIELDS[:6])
    assert (out.availability == 1.0).all()
    if policy == "bs-fcfs":
        ft, ftgt, fup, length = sim_batch._bs_fail_args(
            pb, _empty_failures(flr, 32, 2), None, pwl)
        assert ft.shape == (2, 1) and np.isinf(ft).all()
        assert length == 2 * 300 + 1


def _tied_case(wmod, fmod):
    """Arrivals at integer times, services of 2.5 (completions at
    half-integers), outages at an arrival time (3.0), at a completion time
    (2.5) and at both of two simultaneous rows; class-block and helper
    servers alike."""
    J = 40
    arrival = np.repeat(np.arange(J // 2, dtype=np.float64), 2)[None]
    cls = (np.arange(J) % 3)[None]
    need = np.array([1, 4, 8])[cls]
    service = np.full((1, J), 2.5)
    batch = wmod.BatchTrace(arrival=arrival, cls=cls, service=service,
                           need=need, k=32, C=3)
    t_down = np.array([[2.5, 2.5, 3.0, 3.0, 4.5, 6.0, 6.0, 7.5]])
    t_up = t_down + np.array([[1.5, 3.0, 1.5, 2.0, 1.0, 2.5, 2.5, 1.0]])
    server = np.array([[0, 31, 5, 30, 12, 20, 21, 1]])
    fb = fmod.FailureBatch(t_down=t_down, t_up=t_up, server=server,
                          count=np.array([8]), k=32, horizon=20.0)
    return batch, fb


@pytest.mark.parametrize("policy", POLICIES)
def test_failure_ties_with_arrivals_and_completions(policy):
    rb, rfb = _tied_case(ref_workload, ref_flr)
    pb, pfb = _tied_case(workload, flr)
    pwl = small_workload(workload, 32)
    out = engines.simulate(policy, pb, wl=pwl, device="cpu", failures=pfb)
    for engine in ("python", "jax", "pallas"):
        ref = ref_engines.simulate(policy, rb, engine=engine,
                                   wl=small_workload(ref_workload, 32),
                                   failures=rfb)
        assert_same_result(out, ref)
    assert (out.availability < 1.0).all()
    completions = pb.arrival + out.response
    assert np.isin(pfb.t_down, completions).any()   # a tie with a completion
    assert np.isin(pfb.t_down, pb.arrival).any()    # and with an arrival


def test_bs_overflow_raises_on_both_sides():
    rwl, rb, rfb, pwl, pb, pfb = faulty(32, num_jobs=300, reps=2, seed=2,
                                        mtbf=10.0, mttr=8.0, pod_size=4)
    with pytest.raises(QueueOverflowError, match="queue_cap=2"):
        engines.simulate("bs-fcfs", pb, wl=pwl, device="cpu", failures=pfb,
                         queue_cap=2)
    with pytest.raises(RuntimeError, match="queue_cap=2"):
        ref_engines.simulate("bs-fcfs", rb, engine="jax", wl=rwl,
                             failures=rfb, queue_cap=2)


def test_kill_mode_srpt_and_mismatched_batches_are_refused():
    _, _, _, pwl, pb, pfb = faulty(32, num_jobs=50, reps=2, mode="kill")
    for policy in POLICIES:
        with pytest.raises(NotImplementedError, match="python engine"):
            engines.simulate(policy, pb, wl=pwl, device="cpu", failures=pfb)
    with pytest.raises(NotImplementedError, match="mode='drain'"):
        sim_batch.sweep_many_server(
            workload.figure1_workload, (32,), num_jobs=50, reps=2,
            device="cpu", failures=flr.FailureProcess(5.0, 1.0, mode="kill"))
    drain = dataclasses.replace(pfb, mode="drain")
    for policy in ("sf-srpt", "ff-srpt"):
        with pytest.raises(NotImplementedError, match="fault-injection"):
            engines.simulate(policy, pb, device="cpu", failures=drain)
    with pytest.raises(ValueError, match="failures.k"):
        engines.simulate("fcfs", pb, device="cpu",
                         failures=flr.FailureProcess(30.0, 5.0).sample(
                             16, 100.0, 2))
    with pytest.raises(ValueError, match="failures.reps"):
        engines.simulate("fcfs", pb, device="cpu",
                         failures=flr.FailureProcess(30.0, 5.0).sample(
                             32, 100.0, 1))


# -- grids and sweeps --------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_grid_with_failures_equals_per_cell(policy):
    cells, ref_cells = [], []
    for k, J, seed in ((32, 200, 5), (64, 150, 6)):
        rwl, rb, rfb, pwl, pb, pfb = faulty(k, num_jobs=J, reps=2, seed=seed)
        cells.append(engines.GridCell(batch=pb, wl=pwl, failures=pfb))
        ref_cells.append(ref_engines.GridCell(batch=rb, wl=rwl,
                                              failures=rfb))
    out = engines.simulate_grid(policy, cells, device="cpu")
    ref = ref_engines.simulate_grid(policy, ref_cells, engine="jax")
    for o, r in zip(out, ref):
        assert_same_result(o, r)
    with pytest.raises(ValueError, match="mixed failure"):
        engines.simulate_grid(policy, [cells[0], dataclasses.replace(
            cells[1], failures=None)], device="cpu")


def _bench_failures(mod):
    """``bench_sim.bench_failures``' outage process as a sweep callable."""
    def make(wl, batch):
        h = float(batch.arrival.max())
        return mod.FailureProcess(mtbf=h / 4, mttr=h / 40, pod_size=2).sample(
            wl.k, h, batch.reps, seed=1)
    return make


@pytest.mark.parametrize("form", ["process", "callable"])
@pytest.mark.parametrize("grid", [True, False])
def test_sweep_with_failures_equals_reference(grid, form):
    if form == "process":
        pf, rf = (flr.FailureProcess(mtbf=60.0, mttr=3.0),
                  ref_flr.FailureProcess(mtbf=60.0, mttr=3.0))
    else:
        pf, rf = _bench_failures(flr), _bench_failures(ref_flr)
    kw = dict(num_jobs=250, reps=2, seed=3, policies=POLICIES, grid=grid)
    out = sim_batch.sweep_many_server(workload.figure1_workload, (32, 64),
                                      device="cpu", failures=pf, **kw)
    ref = ref_sim_batch.sweep_many_server(ref_workload.figure1_workload,
                                          (32, 64), engine="jax",
                                          failures=rf, **kw)
    for f in ("mean_response", "ci95_response", "mean_wait", "p_wait",
              "ci95_p_wait", "p_helper", "p95_response", "utilization"):
        assert np.array_equal(getattr(out, f), getattr(ref, f),
                              equal_nan=True), f
    strip = lambda rows: [{c: v for c, v in r.items() if c != "sim_s"}
                          for r in rows]
    assert strip(out.rows("k")) == strip(ref.rows("k"))
    # availability: the mean of each cell's reference result
    for j, k in enumerate((32, 64)):
        wl = ref_workload.figure1_workload(k)
        batch = wl.sample_traces(250, 2, seed=3)
        fb = (rf.sample(k, float(batch.arrival.max()), 2, seed=3)
              if form == "process" else rf(wl, batch))
        for i, pol in enumerate(POLICIES):
            res = ref_engines.simulate(pol, batch, engine="jax", wl=wl,
                                       failures=fb)
            assert out.availability[i, j] == res.availability.mean()
    clean = sim_batch.sweep_many_server(workload.figure1_workload, (32,),
                                        device="cpu", num_jobs=50, reps=2)
    assert clean.availability is None


@pytest.mark.parametrize("mix", ["heavy", "bench"])
def test_plain_bs_fail_scan_equals_reference_on_drain_cases(mix):
    """The plain drain-mode BS-π scan against the reference's scan core on
    ``bench.bs_cases``' drain cases (the heavier mix: class drains on free
    slots, pods of 4), every raw output and trailing no-op step, rtol=0."""
    from repro_torch.bench import bs_cases

    case = bs_cases.drain_case(256, 240, 2, 4, mix=mix)
    out = [o.numpy() for o in bs_cases.scan_ref(case)]
    args = [x.numpy() for x in case.trace + case.frec]
    dts = (jnp.float64, jnp.int32, jnp.int32, jnp.float64, jnp.float64,
           jnp.int32, jnp.float64)
    with x64():
        ref = ref_sim_batch._bs_fail_scan_batch(
            *(jnp.asarray(x, d) for x, d in zip(args, dts)),
            jnp.asarray(case.slots.numpy(), jnp.int32), case.s_max, case.h,
            case.q_cap, case.length)
        ref = [np.asarray(r) for r in ref]
    assert_arrays_equal(out, ref)
    assert case.length > 2 * case.J
