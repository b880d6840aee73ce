"""The port's workload sampler and eq.-(2) partition against the reference.

Same seed, same Philox streams: ``repro_torch``'s ``sample_traces`` must
give the reference's arrays bit for bit, and its ``balanced_partition``
the reference's slots and helpers, so that every parity test downstream
compares the two packages on identical data.
"""

import numpy as np
import pytest

from _torch_jaxref import port_batch, ref_workload
from repro.core import partition as ref_partition

from repro_torch.core import partition, workload

WORKLOADS = [
    ("figure1", 32), ("figure1", 256), ("figure1", 1024),
    ("figure2", (64, 0.8)), ("figure2", (256, 0.95)),
]


def _factories(kind, arg):
    if kind == "figure1":
        return (ref_workload.figure1_workload(arg),
                workload.figure1_workload(arg))
    return (ref_workload.figure2_workload(*arg),
            workload.figure2_workload(*arg))


@pytest.mark.parametrize("kind,arg", WORKLOADS)
def test_sample_traces_bit_equal(kind, arg):
    ref_wl, wl = _factories(kind, arg)
    ref = ref_wl.sample_traces(300, 3, seed=11)
    out = wl.sample_traces(300, 3, seed=11)
    for f in ("arrival", "cls", "service", "need"):
        a, b = getattr(out, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert (out.k, out.C) == (ref.k, ref.C)


@pytest.mark.parametrize("kind,arg", WORKLOADS)
def test_workload_quantities_equal(kind, arg):
    ref_wl, wl = _factories(kind, arg)
    assert wl.lam == ref_wl.lam
    assert wl.load == ref_wl.load
    assert np.array_equal(wl.demands, ref_wl.demands)
    assert np.array_equal(wl.needs, ref_wl.needs)
    assert wl.zero_wait_response_time() == ref_wl.zero_wait_response_time()


@pytest.mark.parametrize("k", [32, 256, 1024, 2048])
def test_balanced_partition_equal(k):
    ref = ref_partition.balanced_partition(ref_workload.figure1_workload(k))
    out = partition.balanced_partition(workload.figure1_workload(k))
    assert out.slots == ref.slots
    assert out.helpers == ref.helpers
    assert (out.a, out.psi, out.needs) == (ref.a, ref.psi, ref.needs)


def test_partition_from_arrays_carries_reference_across():
    ref = ref_partition.balanced_partition(ref_workload.figure1_workload(256))
    out = partition.BalancedPartition.from_arrays(ref.k, ref.needs, ref.a,
                                                  ref.psi)
    assert out == partition.balanced_partition(workload.figure1_workload(256))
    with pytest.raises(ValueError, match="multiples"):
        partition.BalancedPartition.from_arrays(8, (2,), (3,), 1.0)
    with pytest.raises(ValueError, match="exceed"):
        partition.BalancedPartition.from_arrays(8, (2,), (10,), 1.0)
    with pytest.raises(ValueError, match="blocks"):
        partition.BalancedPartition.from_arrays(8, (1, 2), (2,), 1.0)


def test_from_arrays_copies_and_converts():
    ref = ref_workload.figure1_workload(32).sample_traces(50, 2, seed=3)
    out = port_batch(ref)
    assert out.reps == 2 and out.num_jobs == 50 and out.num_classes == 4
    for f in ("arrival", "cls", "service", "need"):
        assert np.array_equal(getattr(out, f), getattr(ref, f))
        assert not np.shares_memory(getattr(out, f), getattr(ref, f))
    b = workload.BatchTrace.from_arrays(
        [[0.5, 1.0]], [[0, 1]], [[1.0, 2.0]], [[1, 2]], k=4)
    assert b.arrival.dtype == np.float64 and b.need.dtype == np.int64
    assert b.C is None and b.num_classes == 2
    with pytest.raises(ValueError, match="shape"):
        workload.BatchTrace.from_arrays([[0.5]], [[0, 1]], [[1.0]], [[1]],
                                        k=4)


# -- the Figure-3 path: Table-2/3 workloads, synthesized traces, bootstrap --

from repro.data import swf as ref_swf  # noqa: E402

from repro_torch.data import swf  # noqa: E402

TABLES = [("sdsc", 512, 0.85), ("sdsc", 1024, 0.5), ("kit", 512, 0.7),
          ("kit", 1024, 0.85)]


def _table(name, k, load):
    if name == "sdsc":
        return (ref_workload.sdsc_sp2_workload(k=k, load=load),
                workload.sdsc_sp2_workload(k=k, load=load),
                ref_swf.sdsc_sp2_trace, swf.sdsc_sp2_trace)
    return (ref_workload.kit_fh2_workload(k=k, load=load),
            workload.kit_fh2_workload(k=k, load=load),
            ref_swf.kit_fh2_trace, swf.kit_fh2_trace)


@pytest.mark.parametrize("name,k,load", TABLES)
def test_table_workloads_equal(name, k, load):
    ref_wl, wl, _, _ = _table(name, k, load)
    assert workload.SDSC_SP2_TABLE == ref_workload.SDSC_SP2_TABLE
    assert workload.KIT_FH2_TABLE == ref_workload.KIT_FH2_TABLE
    assert wl.lam == ref_wl.lam and wl.load == ref_wl.load
    assert [(c.name, c.n, c.alpha, c.service.kind, c.service.mean,
             c.service.std) for c in wl.classes] == [
        (c.name, c.n, c.alpha, c.service.kind, c.service.mean,
         c.service.std) for c in ref_wl.classes]
    ref_p = ref_partition.balanced_partition(ref_wl)
    p = partition.balanced_partition(wl)
    assert (p.slots, p.helpers) == (ref_p.slots, ref_p.helpers)
    exp = workload.kit_fh2_workload(k=k, load=load, dist="exponential")
    assert exp.lam == ref_workload.kit_fh2_workload(
        k=k, load=load, dist="exponential").lam


@pytest.mark.parametrize("name,k,load", TABLES)
def test_synthesized_traces_equal(name, k, load):
    _, _, ref_fn, fn = _table(name, k, load)
    ref = ref_fn(500, k=k, load=load, seed=7)
    out = fn(500, k=k, load=load, seed=7)
    for f in ("arrival", "cls", "service", "need"):
        a, b = getattr(out, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (out.k, out.C) == (ref.k, ref.C)


@pytest.mark.parametrize("method,block_len", [("iid", None), ("block", None),
                                              ("block", 7)])
def test_from_trace_bootstrap_equal(method, block_len):
    trace = ref_swf.kit_fh2_trace(400, k=512, load=0.85, seed=2)
    ref = ref_workload.BatchTrace.from_trace(trace, 3, seed=5, method=method,
                                             block_len=block_len)
    port_trace = swf.kit_fh2_trace(400, k=512, load=0.85, seed=2)
    out = workload.BatchTrace.from_trace(port_trace, 3, seed=5,
                                         method=method, block_len=block_len)
    for f in ("arrival", "cls", "service", "need"):
        a, b = getattr(out, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (out.k, out.C) == (ref.k, ref.C)
    assert (np.diff(out.arrival, axis=1) >= 0).all()


def test_from_trace_rejects_what_the_reference_rejects():
    trace = swf.sdsc_sp2_trace(50, k=512)
    src = workload.BatchTrace.from_trace(trace, 2, stream=True)
    assert isinstance(src, workload.BootstrapSource)
    assert (src.reps, src.total_jobs, src.block_len) == (2, None, 4)
    with pytest.raises(ValueError, match="bootstrap method"):
        workload.BatchTrace.from_trace(trace, 2, method="wild")
    with pytest.raises(ValueError, match="block_len"):
        workload.BatchTrace.from_trace(trace, 2, method="block",
                                       block_len=51)
    with pytest.raises(ValueError, match="replication"):
        workload.BatchTrace.from_trace(trace, 0)
