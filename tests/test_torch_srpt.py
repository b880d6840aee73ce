"""The port's preemptive SRPT pair and its stable sort against the reference.

On this CPU ``srpt_scan_fwd`` and ``stable_sort_fwd`` run their plain
PyTorch versions; each must equal, at tolerance 0, the reference's Pallas
SRPT kernel in interpret mode and its scan core on all seven raw outputs,
and the reference's in-kernel ``bitonic_sort`` on adversarial keys.
The same holds on bursts of equal arrival times (ties on arrival and on
rank), and the CUDA kernel's way of picking ServerFilling's running set
(the index within a need class against a closed-form limit, no second
sort) equals the plain step's two-sort selection at every event.
``engines.simulate("sf-srpt" | "ff-srpt", device="cpu")`` must give the
reference's ``jax``, ``pallas`` and ``python`` engines' results,
``preemptions`` included.  The interpret-mode kernel is slow at the
default slot-table width, so the kernel-level cases pass a small
``queue_cap`` (the peak in-system count of these traces stays below it).
The CUDA kernels are held to the same plain versions by
``tests/test_torch_card.py`` and by ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from _torch_jaxref import port_batch, ref_engines, ref_workload, x64

import jax
import jax.numpy as jnp
from repro.core import sim_batch as ref_sim_batch
from repro.core import sim_jax
from repro.data import swf as ref_swf
from repro.kernels.msj_scan.sort import bitonic_sort
from repro.kernels.msj_scan.srpt import srpt_scan_fwd as ref_srpt_scan

from repro_torch.bench import srpt_cases
from repro_torch.core import engines, sim_batch, sim_torch
from repro_torch.kernels import msj_scan
from repro_torch.kernels.msj_scan import kernel as K

J, R = 300, 2
FIELDS = ("response", "wait", "start", "blocked", "p_helper", "p_routed",
          "preemptions")


def _batch(k, load=0.85, seed=3):
    trace = ref_swf.sdsc_sp2_trace(J, k=k, load=load, seed=seed)
    return ref_workload.BatchTrace.from_trace(trace, R, seed=seed)


def _torch_args(b):
    return (torch.tensor(b.arrival), torch.tensor(b.need, dtype=torch.float64),
            torch.tensor(b.service),
            torch.full((b.reps,), float(b.k), dtype=torch.float64))


def _jax_args(b):
    return (jnp.asarray(b.arrival, jnp.float64),
            jnp.asarray(b.need, jnp.float64),
            jnp.asarray(b.service, jnp.float64),
            jnp.full(b.reps, float(b.k), jnp.float64))


def _assert_streams_equal(out, refs):
    assert len(out) == 7
    for ref in refs:
        for o, r in zip(out, ref):
            r = np.asarray(r)
            o = o.numpy()
            assert o.dtype == r.dtype and o.shape == r.shape
            assert np.array_equal(o, r)


@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("sf", [True, False], ids=["sf", "ff"])
def test_plain_srpt_scan_bit_equal_to_reference_kernel(sf, k):
    b = _batch(k)
    Q = sim_torch._srpt_args(b, k)
    NU = sim_batch._srpt_nu(b)
    assert Q == sim_jax._srpt_args(b, k) and NU == ref_sim_batch._srpt_nu(b)
    out = msj_scan.srpt_scan_fwd(*_torch_args(b), Q=Q, NU=NU, sf=sf)
    assert not out[3].any() and (out[5] == 2 * J).all()
    with x64():
        args = _jax_args(b)
        pallas = ref_srpt_scan(*args, Q=Q, NU=NU, sf=sf, interpret=True)
        core = sim_jax._srpt_core(*args, Q, NU, sf)
        _assert_streams_equal(out, (pallas, core))


def _burst():
    """J = 200 jobs in 10 batches of 20 equal arrival times, 8 time units
    apart, services from four values, k = 64: up to 58 jobs in the system
    (two 32-entry runs in the kernel's sort), so Q = 64 holds them."""
    return srpt_cases.burst_case(200, 64, R, batch=20, gap=8.0, seed=0)


@pytest.mark.parametrize("Q", [64, 16], ids=["fits", "overflow"])
@pytest.mark.parametrize("sf", [True, False], ids=["sf", "ff"])
def test_plain_srpt_scan_bit_equal_to_reference_kernel_on_bursts(sf, Q):
    t, NU = _burst()
    out = msj_scan.srpt_scan_fwd(*t, Q=Q, NU=NU, sf=sf)
    if Q == 64:
        assert not out[3].any() and (out[5] == 400).all()
        assert (out[6] > 32).all()
    else:
        assert out[3].all()
    with x64():
        args = tuple(jnp.asarray(x.numpy(), jnp.float64) for x in t)
        pallas = ref_srpt_scan(*args, Q=Q, NU=NU, sf=sf, interpret=True)
        core = sim_jax._srpt_core(*args, Q, NU, sf)
        _assert_streams_equal(out, (pallas, core))


def _sf_take_by_class(kk, rk_s, need_s, occ_s, NU):
    """ServerFilling's running set by the rule the CUDA kernel uses, with
    no second sort: a job of the prefix M is taken iff its index among M's
    jobs of its need class, in sort-1 order, is below the class's limit
    ``min(count, floor(F / nu))``, the limits taken over the classes in
    descending need with F falling from ``kk`` (the first-fit walk over a
    descending-need order, in closed form)."""
    in_M, has_m = sim_torch._srpt_prefix_m(kk, need_s, occ_s)
    nu = torch.tensor(NU, dtype=torch.float64)
    cls = torch.searchsorted(nu, need_s.contiguous()).clamp(max=len(NU) - 1)
    onehot = (torch.nn.functional.one_hot(cls, len(NU)).bool()
              & in_M[..., None]).long()
    before = (onehot.cumsum(1) - onehot).gather(2, cls[..., None])[..., 0]
    count = onehot.sum(1).double()
    F = kk.clone()
    lim = torch.zeros_like(count)
    for c in reversed(range(len(NU))):
        v = float(NU[c])
        ok = (count[:, c] > 0) & (v <= F)
        q = torch.floor(F / v)
        q = torch.where((q + 1) * v <= F, q + 1, q)
        q = torch.where((q > 0) & (q * v > F), q - 1, q)
        q = torch.where(ok, torch.minimum(q, count[:, c]), 0.0)
        F = torch.where(ok, F - q * v, F)
        lim[:, c] = q
    return in_M & (before < lim.gather(1, cls)), has_m


@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("dataset", ["sdsc", "kit"])
def test_sf_selection_by_need_class_equals_the_two_sort_path(monkeypatch,
                                                            dataset, k):
    """Event by event over a whole SF scan, the kernel's rule
    (``_sf_take_by_class``) gives the plain step's set
    (``_srpt_sf_take``: M re-sorted by (-need, rank, position), then first
    fit); dozens of the lanes' events have a prefix M."""
    two_sort = sim_torch._srpt_sf_take
    with_m = []

    def both(kk, rk_s, need_s, occ_s, NU):
        take, has_m = two_sort(kk, rk_s, need_s, occ_s, NU)
        mine, has_m2 = _sf_take_by_class(kk, rk_s, need_s, occ_s, NU)
        assert torch.equal(has_m, has_m2) and torch.equal(take, mine)
        with_m.append(int(has_m.sum()))
        return take, has_m

    monkeypatch.setattr(sim_torch, "_srpt_sf_take", both)
    t, NU = srpt_cases.table_case(dataset, J, k, R, seed=3)
    Q = srpt_cases.slots(J, k)
    out = sim_torch._srpt_core(*t, Q, NU, True)
    assert not out[3].any() and len(with_m) == 2 * J
    assert sum(with_m) > 20


@functools.lru_cache(maxsize=None)
def _port_result(policy, k):
    return engines.simulate(policy, port_batch(_batch(k, load=0.7)),
                            device="cpu", queue_cap=k)


@pytest.mark.parametrize("engine", ["jax", "pallas", "python"])
@pytest.mark.parametrize("policy", ["sf-srpt", "ff-srpt"])
def test_simulate_bit_equal_to_reference_engines(policy, engine):
    out = _port_result(policy, 64)
    ref = ref_engines.simulate(policy, _batch(64, load=0.7), engine=engine,
                               queue_cap=64)
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            assert np.array_equal(a, b), f
    assert out.preemptions.sum() > 0


@pytest.mark.parametrize("sf", [True, False], ids=["sf", "ff"])
def test_overflow_raises_with_peak_hint_and_streams_still_match(sf):
    """A slot table too small for the trace: the raw streams and counters
    still equal the reference's (the dropped arrival counts in the peak),
    and the result assembly raises the reference's message, which names
    the measured peak and the next power of two."""
    b = _batch(64)
    NU = sim_batch._srpt_nu(b)
    out = msj_scan.srpt_scan_fwd(*_torch_args(b), Q=4, NU=NU, sf=sf)
    assert out[3].all()
    with x64():
        _assert_streams_equal(out, (sim_jax._srpt_core(*_jax_args(b), 4, NU,
                                                       sf),))
    policy = "sf-srpt" if sf else "ff-srpt"
    with pytest.raises(RuntimeError) as port_err:
        engines.simulate(policy, port_batch(b), device="cpu", queue_cap=4)
    with pytest.raises(RuntimeError) as ref_err:
        ref_engines.simulate(policy, b, engine="jax", queue_cap=4)
    assert str(port_err.value) == str(ref_err.value)
    assert isinstance(port_err.value, sim_batch.QueueOverflowError)
    peak = int(out[6].max())
    assert f"measured peak occupancy >= {peak} jobs" in str(port_err.value)
    assert f"queue_cap={1 << (peak - 1).bit_length()}" in str(port_err.value)


def test_failures_and_bad_inputs_raise():
    b = port_batch(_batch(64))
    for policy in ("sf-srpt", "ff-srpt"):
        with pytest.raises(NotImplementedError):
            engines.simulate(policy, b, device="cpu", failures=object())
    with pytest.raises(NotImplementedError, match="sf-srpt"):
        sim_batch._srpt_no_failures(object(), "sf-srpt")
    a, n, v, kk = _torch_args(_batch(64))
    K.reset_launches()
    with pytest.raises(TypeError, match="need must be torch.float64"):
        msj_scan.srpt_scan_fwd(a, n.int(), v, kk, Q=64, NU=(1,), sf=True)
    with pytest.raises(ValueError, match="power of two"):
        msj_scan.srpt_scan_fwd(a, n, v, kk, Q=48, NU=(1,), sf=True)
    with pytest.raises(ValueError, match="NU"):
        msj_scan.srpt_scan_fwd(a, n, v, kk, Q=64, NU=(2, 1), sf=True)
    with pytest.raises(ValueError, match="kk"):
        msj_scan.srpt_scan_fwd(a, n, v, kk[:1], Q=64, NU=(1,), sf=True)
    with pytest.raises(ValueError, match=r"W=5000"):
        msj_scan.stable_sort_fwd(torch.zeros(1, 5000, dtype=torch.float64),
                                 torch.zeros(1, 5000, dtype=torch.int32),
                                 num_keys=1)
    keys = torch.zeros(1, 8, dtype=torch.float64)
    with pytest.raises(TypeError, match="operand 1"):
        msj_scan.stable_sort_fwd(keys, keys, num_keys=1)
    msj_scan.stable_sort_fwd(keys, torch.zeros(1, 8, dtype=torch.int32),
                             num_keys=1)
    assert K.launches()["srpt_scan_fwd"] == 0
    assert K.launches()["stable_sort_fwd"] == 0


# -- the sort primitive: the adversarial cases of tests/test_sim_cross.py --

_SORT_R, _SORT_Q = 2, 24   # non-pow2 width: exercises the +inf padding

sort_cases = st.tuples(
    st.integers(1, 2),                                         # num_keys
    st.lists(st.tuples(
        st.sampled_from([-np.inf, np.inf, 0.0, 0.0, 1.0, 1.5, 2.5, 2.5]),
        st.sampled_from([0.0, 1.0, 1.0, 4.0])),                # tie-breaker
        min_size=_SORT_R * _SORT_Q, max_size=_SORT_R * _SORT_Q),
)


def _sort_both(keys, payload, num_keys):
    out = msj_scan.stable_sort_fwd(*[torch.tensor(k) for k in keys],
                                   torch.tensor(payload), num_keys=num_keys)
    with x64():
        ops = tuple(jnp.asarray(k, jnp.float64) for k in keys) + (
            jnp.asarray(payload, jnp.int32),)
        want = bitonic_sort(ops, num_keys=num_keys)
        lax = jax.lax.sort(ops, dimension=-1, num_keys=num_keys,
                           is_stable=True)
    for o, w, x in zip(out, want, lax):
        assert o.numpy().dtype == np.asarray(w).dtype
        assert np.array_equal(o.numpy(), np.asarray(w))
        assert np.array_equal(o.numpy(), np.asarray(x))


@settings(max_examples=25, deadline=None)
@given(sort_cases)
def test_stable_sort_bit_equal_to_bitonic_sort(args):
    num_keys, rows = args
    key = np.array([r[0] for r in rows]).reshape(_SORT_R, _SORT_Q)
    key2 = np.array([r[1] for r in rows]).reshape(_SORT_R, _SORT_Q)
    payload = np.arange(key.size, dtype=np.int32).reshape(key.shape)
    _sort_both((key, key2)[:num_keys], payload, num_keys)


@pytest.mark.parametrize("Q", [1, 2, 7, 8, 9, 64])
def test_stable_sort_corner_cases(Q):
    """All-equal keys (pure stability), all-+inf rows (indistinguishable
    from the padding) and widths on both sides of a power of two."""
    pay = np.arange(Q, dtype=np.int32)[None]
    for key in (np.zeros(Q), np.full(Q, np.inf),
                np.resize([np.inf, -np.inf, 0.0], Q)):
        _sort_both((key[None],), pay, 1)
        _sort_both((key[None], np.resize([1.0, 0.0], Q)[None]), pay, 2)
