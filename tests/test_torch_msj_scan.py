"""The msj_scan kernels' plain versions against the JAX reference kernels.

On this CPU the wrappers ``fcfs_scan_fwd`` / ``modbs_scan_fwd`` /
``bs_scan_fwd`` run their plain PyTorch versions; each must equal, on its
raw outputs (BS: the full tagged/rec_t event streams and the overflow
flags), both the reference's Pallas kernel run in interpret mode and the
reference's ``*_scan_ref`` scan core — rtol=0.  The CUDA kernels
themselves are held to the same plain versions on the card by
``chip_smoke.py`` and by the card-only test at the end of this file.
"""

import numpy as np
import pytest
import torch

from _torch_jaxref import ref_workload, x64

import jax.numpy as jnp
from repro.core import sim_jax
from repro.kernels.msj_scan import kernel as ref_kernel
from repro.kernels.msj_scan import ref as ref_ref

from repro_torch.kernels import msj_scan
from repro_torch.kernels.msj_scan import kernel as K

J, R = 300, 2


def _case(k, seed=21, queue_cap=None):
    wl = ref_workload.figure1_workload(k)
    b = wl.sample_traces(J, R, seed=seed)
    slots, s_max, h, q_cap = sim_jax._bs_args(b, None, wl, queue_cap)
    return b, slots, s_max, h, q_cap


def _torch_args(b, slots):
    return (torch.tensor(b.arrival), torch.tensor(b.cls, dtype=torch.int32),
            torch.tensor(b.need, dtype=torch.int32), torch.tensor(b.service),
            torch.tensor(slots, dtype=torch.int32))


def _jax_args(b, slots):
    return (jnp.asarray(b.arrival, jnp.float64),
            jnp.asarray(b.cls, jnp.int32), jnp.asarray(b.need, jnp.int32),
            jnp.asarray(b.service, jnp.float64),
            jnp.asarray(slots, jnp.int32))


def _port(name, targs, k, s_max, h, q_cap):
    a, c, n, v, sl = targs
    if name == "fcfs":
        return (msj_scan.fcfs_scan_fwd(a, n, v, k=k),)
    if name == "modbs":
        return msj_scan.modbs_scan_fwd(a, c, n, v, sl, s_max=s_max, h=h)
    return msj_scan.bs_scan_fwd(a, c, n, v, sl, s_max=s_max, h=h,
                                q_cap=q_cap)


def _reference(name, which, jargs, k, s_max, h, q_cap):
    a, c, n, v, sl = jargs
    if which == "pallas":
        if name == "fcfs":
            return (ref_kernel.fcfs_scan_fwd(a, n, v, k=k, interpret=True),)
        if name == "modbs":
            return ref_kernel.modbs_scan_fwd(a, c, n, v, sl, s_max=s_max,
                                             h=h, interpret=True)
        return ref_kernel.bs_scan_fwd(a, c, n, v, sl, s_max=s_max, h=h,
                                      q_cap=q_cap, interpret=True)
    if name == "fcfs":
        return (ref_ref.fcfs_scan_ref(a, n, v, k=k),)
    if name == "modbs":
        return ref_ref.modbs_scan_ref(a, c, n, v, slots=sl, s_max=s_max,
                                      h=h)
    return ref_ref.bs_scan_ref(a, c, n, v, slots=sl, s_max=s_max, h=h,
                               q_cap=q_cap)


def _assert_equal(out, ref):
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        o = o.numpy()
        assert o.dtype == r.dtype and o.shape == r.shape
        assert np.array_equal(o, r)


@pytest.mark.parametrize("which", ["pallas", "ref"])
@pytest.mark.parametrize("k", [32, 256])
@pytest.mark.parametrize("name", ["fcfs", "modbs", "bs"])
def test_plain_kernels_bit_equal_to_reference(name, k, which):
    b, slots, s_max, h, q_cap = _case(k)
    out = _port(name, _torch_args(b, slots), k, s_max, h, q_cap)
    with x64():
        ref = _reference(name, which, _jax_args(b, slots), k, s_max, h,
                         q_cap)
        _assert_equal(out, ref)


def test_bs_overflowing_rings_give_the_reference_streams():
    """With a ring too small the raw streams still match (the ring write
    happens even on overflow) and ovf flags the same replications."""
    b, slots, s_max, h, q_cap = _case(64, seed=7, queue_cap=4)
    out = _port("bs", _torch_args(b, slots), 64, s_max, h, q_cap)
    with x64():
        ref = _reference("bs", "ref", _jax_args(b, slots), 64, s_max, h,
                         q_cap)
        _assert_equal(out, ref)
    assert out[2].any()


@pytest.mark.parametrize("k,n_jobs", [(8, 500), (64, 600), (256, 600)])
def test_fcfs_tied_arrivals_and_zero_services(k, n_jobs):
    """Tied arrivals and zero service times drive searchsorted into tied
    boundaries; the plain step must equal the reference's O(k) step and
    its full-sort oracle (ties injected as in test_sim_cross.py)."""
    rng = np.random.default_rng(12)
    arrival = np.cumsum(rng.exponential(0.05, n_jobs))
    arrival[1::7] = arrival[0::7][: len(arrival[1::7])]
    arrival = np.sort(arrival)
    need = rng.integers(1, max(2, k // 4), size=n_jobs)
    service = np.where(rng.random(n_jobs) < 0.2, 0.0,
                       rng.exponential(1.0, n_jobs))
    out = msj_scan.fcfs_scan_fwd(
        torch.tensor(arrival[None]), torch.tensor(need[None],
                                                  dtype=torch.int32),
        torch.tensor(service[None]), k=k)[0].numpy()
    with x64():
        args = (jnp.asarray(arrival, jnp.float64),
                jnp.asarray(need, jnp.int32),
                jnp.asarray(service, jnp.float64), k)
        assert np.array_equal(out, np.asarray(sim_jax._fcfs_scan(*args)))
        assert np.array_equal(
            out, np.asarray(sim_jax._fcfs_scan_reference(*args)))


def test_fcfs_full_need_jobs_run_serially():
    k = 8
    arrival = (np.arange(20, dtype=np.float64) * 0.1)[None]
    out = msj_scan.fcfs_scan_fwd(
        torch.tensor(arrival), torch.full((1, 20), k, dtype=torch.int32),
        torch.ones(1, 20, dtype=torch.float64), k=k)
    assert np.array_equal(out[0].numpy(), np.arange(20) * 1.0 + arrival[0, 0])


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    b, slots, s_max, h, q_cap = _case(32)
    a, c, n, v, sl = _torch_args(b, slots)
    K.reset_launches()
    msj_scan.fcfs_scan_fwd(a, n, v, k=32)
    msj_scan.bs_scan_fwd(a, c, n, v, sl, s_max=s_max, h=h, q_cap=q_cap)
    assert K.launches() == {"fcfs_scan_fwd": 0, "modbs_scan_fwd": 0,
                            "bs_scan_fwd": 0, "srpt_scan_fwd": 0,
                            "stable_sort_fwd": 0, "fcfs_fail_scan_fwd": 0,
                            "modbs_fail_scan_fwd": 0, "bs_fail_scan_fwd": 0}
    with pytest.raises(TypeError, match="need must be torch.int32"):
        msj_scan.fcfs_scan_fwd(a, n.long(), v, k=32)
    with pytest.raises(TypeError, match="arrival must be torch.float64"):
        msj_scan.fcfs_scan_fwd(a.float(), n, v, k=32)
    with pytest.raises(ValueError, match="contiguous"):
        msj_scan.fcfs_scan_fwd(a, n, v.t().contiguous().t(), k=32)
    with pytest.raises(ValueError, match="shape"):
        msj_scan.modbs_scan_fwd(a, c[:, :10], n, v, sl, s_max=s_max, h=h)
    with pytest.raises(TypeError, match="slots"):
        msj_scan.bs_scan_fwd(a, c, n, v, sl.long(), s_max=s_max, h=h,
                             q_cap=q_cap)
    with pytest.raises(ValueError, match="q_cap"):
        msj_scan.bs_scan_fwd(a, c, n, v, sl, s_max=s_max, h=h, q_cap=0)
    with pytest.raises(ValueError, match=r"\[R, J\]"):
        msj_scan.fcfs_scan_fwd(a[0], n[0], v[0], k=32)


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions_on_the_card():
    """Card only: each CUDA kernel against its plain version, rtol=0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    for k in (32, 256):
        b, slots, s_max, h, q_cap = _case(k)
        targs = _torch_args(b, slots)
        gargs = tuple(t.to(dev) for t in targs)
        for name in ("fcfs", "modbs", "bs"):
            out = _port(name, gargs, k, s_max, h, q_cap)
            ref = _port(name, targs, k, s_max, h, q_cap)
            for o, r in zip(out, ref):
                assert torch.equal(o.cpu(), r), (name, k)
