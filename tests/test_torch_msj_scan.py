"""The msj_scan kernels' plain versions against the JAX reference kernels.

On this CPU the wrappers ``fcfs_scan_fwd`` / ``modbs_scan_fwd`` /
``bs_scan_fwd`` run their plain PyTorch versions; each must equal, on its
raw outputs (BS: the full tagged/rec_t event streams and the overflow
flags), both the reference's Pallas kernel run in interpret mode and the
reference's ``*_scan_ref`` scan core — rtol=0.  The CUDA kernels
themselves are held to the same plain versions on the card by
``chip_smoke.py`` and by ``tests/test_torch_card.py``.
"""

import numpy as np
import pytest
import torch

from _torch_jaxref import ref_workload, x64

import jax.numpy as jnp
from repro.core import sim_jax
from repro.kernels.msj_scan import kernel as ref_kernel
from repro.kernels.msj_scan import ref as ref_ref

from repro_torch.bench import bs_cases, fm_cases
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
    W, t_prev = torch.zeros(R, 32, dtype=torch.float64), torch.zeros(
        R, dtype=torch.float64)
    msj_scan.fcfs_stream_fwd(a, n, v, W, t_prev)
    assert K.launches() == {"fcfs_scan_fwd": 0, "modbs_scan_fwd": 0,
                            "bs_scan_fwd": 0, "srpt_scan_fwd": 0,
                            "stable_sort_fwd": 0, "fcfs_fail_scan_fwd": 0,
                            "modbs_fail_scan_fwd": 0, "bs_fail_scan_fwd": 0,
                            "fcfs_stream_fwd": 0, "modbs_stream_fwd": 0,
                            "bs_stream_fwd": 0}
    with pytest.raises(ValueError, match="W must be a contiguous"):
        msj_scan.fcfs_stream_fwd(a, n, v, W[:1], t_prev)
    with pytest.raises(ValueError, match="at least one job"):
        msj_scan.fcfs_stream_fwd(a[:, :0], n[:, :0], v[:, :0], W, t_prev)
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



# -- the adversarial BS-pi cases (repro_torch.bench.bs_cases) ----------------


ADV_CLEAN = sorted(n for n in bs_cases.ADVERSARIAL if n != "drain_heavy")


@pytest.mark.parametrize("name", ADV_CLEAN)
def test_plain_bs_scan_equals_reference_on_adversarial_cases(name):
    """The plain BS-π scan against the reference's scan core on the cases
    chip_smoke and the card tests hold the kernel to: rings that wrap and
    overflow, KIT-FH2's long helper queues, tied events, SDSC-SP2's seven
    classes — every raw output, rtol=0."""
    case = bs_cases.ADVERSARIAL[name](240, 2, 4)
    out = bs_cases.scan_ref(case)
    a, c, n, v = (x.numpy() for x in case.trace)
    with x64():
        ref = ref_ref.bs_scan_ref(
            jnp.asarray(a, jnp.float64), jnp.asarray(c, jnp.int32),
            jnp.asarray(n, jnp.int32), jnp.asarray(v, jnp.float64),
            slots=jnp.asarray(case.slots.numpy(), jnp.int32),
            s_max=case.s_max, h=case.h, q_cap=case.q_cap)
        _assert_equal(out, ref)
    if name == "wrap":       # one replication overflows, one does not
        assert out[2].any() and not out[2].all()
    if name == "ties":       # many events share their time
        t = out[1].numpy()
        assert (np.diff(np.sort(t[out[0].numpy() >= 0])) == 0).sum() > 100


@pytest.mark.parametrize("name", sorted(bs_cases.ADVERSARIAL))
def test_bs_free_slots_are_exactly_the_big_entries(name):
    """The invariant the CUDA kernel's free-slot masks rest on, checked
    after every step of the plain scan, both modes: in each class row the
    entries at BIG are exactly the free slots below ``slots[c]`` (their
    count is the free counter) plus the padding above, every busy entry is
    below BIG, so the row's first maximum — the reference's argmax — is
    the first free slot whenever one exists."""
    from repro_torch.core import sim_torch

    case = bs_cases.ADVERSARIAL[name](240, 2, 4)
    a, c, n, v = case.trace
    c, n = c.long(), n.long()
    slots = case.slots.long()
    C, s_max = slots.numel(), case.s_max
    s = sim_torch._bs_init(case.R, case.J, C, s_max, case.h, case.q_cap,
                           case.slots)
    if case.frec is not None:
        s["fi"] = torch.zeros(case.R, dtype=torch.int64)
        ft, ftgt, fup = case.frec
    pad = torch.arange(s_max)[None, :] >= slots[:, None]          # [C, s]
    checked = 0
    for _ in range(case.steps):
        if case.frec is None:
            sim_torch._bs_step(s, a, v, c, n, C, s_max, case.h, case.q_cap)
        else:
            sim_torch._bs_fail_step(s, a, v, c, n, ft, ftgt.long(), fup, C,
                                    s_max, case.h, case.q_cap)
        rows = s["comp"][:, :C * s_max].reshape(case.R, C, s_max)
        big = rows == sim_torch._BIG
        assert (rows <= sim_torch._BIG).all()
        assert big[:, pad].all()
        assert torch.equal((big & ~pad).sum(2), s["st"][:, :C])
        has_free = s["st"][:, :C] > 0
        first_free = big.long().argmax(2)
        assert torch.equal(rows.argmax(2)[has_free], first_free[has_free])
        checked += int(has_free.sum())
    assert checked > 0


# -- the premises of the FCFS and ModBS-pi kernels (bench/fm_cases.py) -------


FM_J, FM_R = 240, 2


def _fm_case(name):
    return fm_cases.ADVERSARIAL[name](FM_J, FM_R, 4)


def _fcfs_rows(case):
    """Per-row (t, n, svc, t_up, is_fail) columns of the case's FCFS scan
    (a clean scan's rows are arrivals)."""
    t, n, v = case.fcfs[:3]
    if case.drain:
        return t, n.long(), v, case.fcfs[3], case.fcfs[4]
    return t, n.long(), v, torch.zeros_like(t), torch.zeros_like(t,
                                                                 dtype=bool)


@pytest.mark.parametrize("name", sorted(fm_cases.ADVERSARIAL))
def test_fcfs_step_keeps_w_sorted_and_ranks_past_p_plus_n(name):
    """After every step of the plain FCFS scan (clean or drain): W stays
    sorted, and only ranks [0, p + n) change, p + n = count(W <= comp)
    (a drain: n = 1, comp = max(W[0], t_up)) — the kernel rewrites no
    rank past them."""
    from repro_torch.core import sim_torch

    case = _fm_case(name)
    t, n, v, tu, isf = _fcfs_rows(case)
    k = case.k
    W = torch.zeros(case.R, k, dtype=torch.float64)
    t_prev = torch.zeros(case.R, dtype=torch.float64)
    ranks = torch.arange(k)[None, :]
    moved = 0
    for j in range(t.shape[1]):
        W_new, tp_new, start = sim_torch._fcfs_fail_step(
            W, t_prev, t[:, j], n[:, j], v[:, j], tu[:, j], isf[:, j])
        comp = torch.where(isf[:, j], torch.maximum(W[:, 0], tu[:, j]),
                           start + v[:, j])
        pn = torch.searchsorted(W, comp[:, None], right=True)
        assert (W_new[:, 1:] >= W_new[:, :-1]).all()
        keep = ranks >= pn
        assert torch.equal(W_new[keep], W[keep])
        moved += int(pn.sum())
        W, t_prev = W_new, tp_new
    assert moved > 0


@pytest.mark.parametrize("name", sorted(fm_cases.ADVERSARIAL))
def test_modbs_blocked_iff_row_minimum_above_t(name):
    """After every step of the plain ModBS-π scan (clean or drain): for the
    row of the step's class, count(row > t) >= s_max exactly when
    min(row) > t — what the kernel tests in place of the count."""
    from repro_torch.core import sim_torch

    case = _fm_case(name)
    t, c, n, v = case.modbs[:4]
    c, n = c.long(), n.long()
    C, s_max, h = case.slots.numel(), case.s_max, case.h
    comp, W, t_prev = sim_torch._modbs_init(case.slots, s_max, h, case.R)
    lanes = torch.arange(case.R)
    seen = set()
    for j in range(t.shape[1]):
        row = comp[lanes, c[:, j].clamp(max=C - 1)]
        by_count = (row > t[:, j, None]).sum(1) >= s_max
        assert torch.equal(by_count, row.min(1).values > t[:, j])
        seen.update(by_count.tolist())
        if case.drain:
            W, t_prev, _, _ = sim_torch._modbs_fail_step(
                comp, W, t_prev, t[:, j], c[:, j], n[:, j], v[:, j],
                case.modbs[4][:, j], case.modbs[5][:, j], C)
        else:
            W, t_prev, _, _ = sim_torch._modbs_step(
                comp, W, t_prev, t[:, j], c[:, j], n[:, j], v[:, j])
    assert seen == {True, False}


class _RunLength:
    """The FCFS kernels' run-length free-time state of m servers, as lists:
    F entries <= t_prev (their values never read), and the entries above
    t_prev as [value, multiplicity] groups in ascending order.  With
    ``live`` < m the m - live dead servers start as one group at BIG."""

    def __init__(self, m, live=None):
        live = m if live is None else live
        self.m, self.F, self.t_prev = m, live, 0.0
        self.groups = [] if live == m else [[1e30, m - live]]

    def nth(self, n):
        r = min(max(n, 1), self.m) - 1
        if r < self.F:
            return self.t_prev
        r -= self.F
        for v, mult in self.groups:
            if r < mult:
                return v
            r -= mult
        raise AssertionError("the groups hold fewer than m entries")

    def start(self, t, n):
        return max(max(t, self.t_prev), self.nth(n))

    def _retire(self, n):
        take = min(n, self.F)
        self.F -= take
        n -= take
        while n > 0:
            take = min(n, self.groups[0][1])
            self.groups[0][1] -= take
            n -= take
            if self.groups[0][1] == 0:
                self.groups.pop(0)

    def _insert(self, comp, n):
        if not comp > self.t_prev:
            self.F += n
            return
        for i, g in enumerate(self.groups):
            if g[0] == comp:
                g[1] += n
                return
            if g[0] > comp:
                self.groups.insert(i, [comp, n])
                return
        self.groups.append([comp, n])

    def arrival(self, t, n, svc):
        n = min(max(n, 1), self.m)
        start = self.start(t, n)
        self._retire(n)
        while self.groups and self.groups[0][0] <= start:
            self.F += self.groups.pop(0)[1]
        self.t_prev = start
        self._insert(start + svc, n)
        return start

    def drain(self, tu):
        w0 = self.t_prev if self.F > 0 else self.groups[0][0]
        if not tu > w0:
            return
        self._retire(1)
        self._insert(tu, 1)

    def check(self):
        assert self.F + sum(m for _, m in self.groups) == self.m
        vals = [v for v, _ in self.groups]
        assert all(v > self.t_prev for v in vals) and vals == sorted(set(vals))


@pytest.mark.parametrize("name", sorted(fm_cases.ADVERSARIAL))
def test_run_length_state_gives_the_plain_starts(name):
    """A model of the kernels' state — FCFS on run-length groups above the
    last start, ModBS with each class row's (minimum, first index) kept
    and found again only after the row changes — gives the plain scans'
    raw outputs exactly, failure rows included."""
    case = _fm_case(name)
    t, n, v, tu, isf = (x.numpy() for x in _fcfs_rows(case))
    starts = fm_cases.scan_ref(case, "fcfs")[0].numpy()
    groups = 0
    for r in range(case.R):
        s = _RunLength(case.k)
        for j in range(t.shape[1]):
            assert s.start(t[r, j], n[r, j]) == starts[r, j]
            if isf[r, j]:
                s.drain(tu[r, j])
            else:
                s.arrival(t[r, j], n[r, j], v[r, j])
            s.check()
            groups = max(groups, len(s.groups))
    assert groups >= min(case.k, 2)

    blocked_ref, starts_ref = (x.numpy() for x in fm_cases.scan_ref(case,
                                                                    "modbs"))
    m = [x.numpy() for x in case.modbs]
    slots, s_max, C = case.slots.numpy(), case.s_max, case.slots.numel()
    for r in range(case.R):
        rows = np.where(np.arange(s_max)[None, :] >= slots[:, None], 1e30,
                        0.0)
        rmin = rows.min(1)
        ridx = rows.argmin(1)
        s = _RunLength(case.h)
        for j in range(m[0].shape[1]):
            t_, c_, n_, v_ = m[0][r, j], int(m[1][r, j]), m[2][r, j], \
                m[3][r, j]
            fail = case.drain and bool(m[5][r, j])
            cc = min(c_, C - 1)
            blocked = rmin[cc] > t_
            start = s.start(t_, n_) if blocked else t_
            class_fail = fail and c_ < C
            if class_fail or (not fail and not blocked):
                rows[cc, ridx[cc]] = (max(rmin[cc], m[4][r, j]) if class_fail
                                      else t_ + v_)
                ridx[cc] = rows[cc].argmin()
                rmin[cc] = rows[cc, ridx[cc]]
            if fail and c_ == C:
                s.drain(m[4][r, j])
            elif not fail and blocked:
                s.arrival(t_, n_, v_)
            s.check()
            assert start == starts_ref[r, j]
            assert (blocked and not fail) == blocked_ref[r, j]
