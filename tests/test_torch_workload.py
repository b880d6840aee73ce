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
