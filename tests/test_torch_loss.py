"""The M/GI/s/s loss queue and the single-trace API of the port against
the reference.

``sim_torch._loss_core`` (the ``loss_scan`` kernel's plain version) must
give the reference's ``loss_queue_sim`` / ``loss_queue_sim_batch`` blocked
masks and responses bit for bit, and a heapq event oracle's; Property 1
must hold on the sample path (each ModifiedBS-π class row is a loss queue
with ``slots[c]`` servers on that class's arrivals); ``fcfs_sim``,
``modified_bs_sim``, ``bs_sim`` and ``estimate_p_helper`` must equal the
reference's on every field.  ``test_sim_cross.py``'s loss-queue tests and
``test_erlang.py``'s M/M/s/s check cannot run on the reference here (its
``sim_jax`` import needs the removed ``jax.experimental.enable_x64``),
so this file carries them.
"""

import dataclasses
import heapq

import numpy as np
import pytest
import torch

from _torch_jaxref import port_batch, ref_workload  # the x64 alias
from repro.core import sim_batch as ref_batch
from repro.core import sim_jax as ref

from repro_torch.bench import loss_cases
from repro_torch.core import erlang, sim_batch, sim_torch, workload
from repro_torch.core.partition import balanced_partition
from repro_torch.kernels.msj_scan import kernel as K

CPU = "cpu"


def loss_oracle(arrival, service, s):
    """Event-driven M/GI/s/s: a heap of completion times (the
    reference's ``test_sim_cross.loss_queue_reference``)."""
    comp: list[float] = []
    blocked = np.zeros(len(arrival), dtype=bool)
    for j, (t, svc) in enumerate(zip(arrival, service)):
        while comp and comp[0] <= t:
            heapq.heappop(comp)
        if len(comp) >= s:
            blocked[j] = True
        else:
            heapq.heappush(comp, t + svc)
    return blocked


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_loss_queue_equals_reference_and_oracle(rng):
    n, s, lam = 5000, 6, 5.0
    arrival = np.cumsum(rng.exponential(1 / lam, n))
    service = rng.exponential(1.0, n)
    res = sim_torch.loss_queue_sim(arrival, service, s, device=CPU)
    want = ref.loss_queue_sim(arrival, service, s)
    assert [f.name for f in dataclasses.fields(res)] == \
        [f.name for f in dataclasses.fields(want)]
    assert res.blocked.dtype == want.blocked.dtype == bool
    assert np.array_equal(res.blocked, want.blocked)
    assert np.array_equal(res.response, want.response)
    assert res.p_helper is None and res.mean_response == want.mean_response
    assert np.array_equal(res.blocked, loss_oracle(arrival, service, s))
    assert 0.05 < res.blocked.mean() < 0.5


def test_loss_queue_batch_equals_reference(rng):
    """``test_sim_cross.py``'s batched shapes (R = 3, n = 2000, s = 5)."""
    R, n, s = 3, 2000, 5
    arrival = np.cumsum(rng.exponential(0.25, (R, n)), axis=1)
    service = rng.exponential(1.0, (R, n))
    res = sim_batch.loss_queue_sim_batch(arrival, service, s, device=CPU)
    want = ref_batch.loss_queue_sim_batch(arrival, service, s)
    for f in dataclasses.fields(want):
        x, y = getattr(res, f.name), getattr(want, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
    for r in range(R):
        single = sim_torch.loss_queue_sim(arrival[r], service[r], s,
                                          device=CPU)
        assert np.array_equal(res.blocked[r], single.blocked)
        assert np.array_equal(res.response[r], single.response)
        assert np.array_equal(res.blocked[r],
                              loss_oracle(arrival[r], service[r], s))


def test_loss_queue_ties_and_tensors():
    """Equal arrival times and a completion equal to an arrival (a server
    freed at t is free at t); CPU tensors in, plain version run, no
    launch counted."""
    arrival, service = loss_cases.ties_case(2, 120)
    K.reset_launches()
    out = K.loss_scan_fwd(torch.tensor(arrival), torch.tensor(service), s=4)
    assert K.launches()["loss_scan_fwd"] == 0
    assert out.dtype == torch.bool and out.shape == arrival.shape
    for r in range(2):
        assert np.array_equal(out.numpy()[r],
                              loss_oracle(arrival[r], service[r], 4))
        assert np.array_equal(out.numpy()[r], loss_cases.loss_oracle(
            arrival[r], service[r], 4))
    assert out.any() and not out.all()
    want = ref_batch.loss_queue_sim_batch(arrival, service, 4)
    assert np.array_equal(out.numpy(), want.blocked)
    res = sim_batch.loss_queue_sim_batch(torch.tensor(arrival),
                                         torch.tensor(service), 4)
    assert np.array_equal(res.blocked, want.blocked)


def test_loss_queue_refuses_no_servers_and_a_missing_card():
    a = np.arange(5, dtype=np.float64)[None]
    with pytest.raises(ValueError, match="s >= 1"):
        sim_batch.loss_queue_sim_batch(a, a, 0, device=CPU)
    with pytest.raises(ValueError, match="s >= 1"):
        sim_torch.loss_queue_sim(a[0], a[0], -1, device=CPU)
    with pytest.raises(ValueError, match="s >= 1"):
        K.loss_scan_fwd(torch.tensor(a), torch.tensor(a), s=0)
    with pytest.raises(TypeError, match="float64"):
        K.loss_scan_fwd(torch.tensor(a).float(), torch.tensor(a), s=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim_batch.loss_queue_sim_batch(a, a, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim_torch.loss_queue_sim(a[0], a[0], 2)


def test_erlang_vs_loss_queue_simulation():
    """M/M/s/s sample path vs Erlang-B (``test_erlang.py``'s check: λ = 8,
    d = 1, s = 10), 4 x 25 000 arrivals on the plain version."""
    lam, d, s, n = 8.0, 1.0, 10, 25_000
    rng = np.random.default_rng(3)
    arrival = np.cumsum(rng.exponential(1 / lam, (4, n)), axis=1)
    service = rng.exponential(d, (4, n))
    res = sim_batch.loss_queue_sim_batch(arrival, service, s, device=CPU)
    assert res.blocked.mean() == pytest.approx(erlang.erlang_b(s, lam * d),
                                               abs=0.01)


def test_property1_modbs_class_rows_are_loss_queues():
    """Property 1 as a sample-path identity on Fig. 1 at k = 256: the
    plain ModifiedBS-π's blocked mask restricted to class c equals the
    loss queue with slots[c] servers on class c's substream."""
    wl = workload.figure1_workload(256)
    batch = wl.sample_traces(600, 2, seed=4)
    slots = balanced_partition(wl).slots
    blocked = sim_batch.modified_bs_sim_batch(batch, wl=wl,
                                              device=CPU).blocked
    assert all(slots)
    assert loss_cases.property1_mismatches(
        batch, blocked, slots,
        lambda a, v, s: sim_batch.loss_queue_sim_batch(
            a, v, s, device=CPU).blocked) == []
    assert blocked.any() and not blocked.all()
    # a class row without slots blocks its every job
    bad = list(slots)
    bad[3] = 0
    assert loss_cases.property1_mismatches(
        batch, np.broadcast_to(batch.cls == 3, batch.cls.shape), bad,
        lambda a, v, s: np.zeros(a.shape, dtype=bool)) == []


def _fields_equal(res, want):
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(res)] == names
    for name in names:
        x, y = getattr(res, name), getattr(want, name)
        assert (x is None) == (y is None), name
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        else:
            assert x == y, name


@pytest.mark.parametrize("k", [128, 512])
def test_single_trace_api_equals_reference(k):
    wl, rwl = workload.figure1_workload(k), ref_workload.figure1_workload(k)
    rtrace = rwl.sample_trace(1500, seed=9)
    trace = port_batch(ref_workload.BatchTrace(
        arrival=rtrace.arrival[None], cls=rtrace.cls[None],
        service=rtrace.service[None], need=rtrace.need[None], k=rtrace.k,
        C=rtrace.C)).rep(0)
    _fields_equal(sim_torch.fcfs_sim(trace, device=CPU), ref.fcfs_sim(rtrace))
    _fields_equal(sim_torch.modified_bs_sim(trace, wl=wl, device=CPU),
                  ref.modified_bs_sim(rtrace, wl=rwl))
    _fields_equal(sim_torch.bs_sim(trace, wl=wl, device=CPU),
                  ref.bs_sim(rtrace, wl=rwl))
    _fields_equal(sim_torch.bs_sim(trace, wl=wl, queue_cap=64, device=CPU,
                                   engine="python"),
                  ref.bs_sim(rtrace, wl=rwl, queue_cap=64, engine="python"))
    assert sim_torch.estimate_p_helper(wl, 800, seed=2, reps=2,
                                       device=CPU) == \
        ref.estimate_p_helper(rwl, 800, seed=2, reps=2)


def test_batched_wrappers_equal_reference():
    wl, rwl = workload.figure1_workload(256), ref_workload.figure1_workload(
        256)
    rb = rwl.sample_traces(700, 2, seed=5)
    b = port_batch(rb)
    for mine, theirs, kw, rkw in (
            (sim_batch.fcfs_sim_batch, ref_batch.fcfs_sim_batch, {}, {}),
            (sim_batch.modified_bs_sim_batch, ref_batch.modified_bs_sim_batch,
             {"wl": wl}, {"wl": rwl}),
            (sim_batch.bs_sim_batch, ref_batch.bs_sim_batch,
             {"wl": wl, "queue_cap": 128}, {"wl": rwl, "queue_cap": 128})):
        res, want = mine(b, device=CPU, **kw), theirs(rb, **rkw)
        _fields_equal(res, want)
        _fields_equal(res.rep(1), want.rep(1))
