"""Streams of the port against the JAX reference, on the CPU (rtol=0).

* **Sources** — every chunk source of ``repro_torch.core.workload``, and
  ``BatchTrace.from_trace(stream=True)``, gives the reference's chunks
  array for array over the chunk schedules {one chunk, J/4, ragged}, and a
  chunk fetched again from its saved state equals the first fetch.
* **Streams** — ``simulate_stream(..., device="cpu")`` for ``fcfs``,
  ``modbs-fcfs`` and ``bs-fcfs`` at k in {32, 256} over the same
  schedules equals the reference's ``simulate_stream(engine="jax")``, the
  port's ``stream_fold(simulate(...))`` and the reference's, on every
  ``StreamResult`` field.
* **Carries** — the two exactness claims the canonical carry rests on
  (FCFS's W clamped to the last start, ModBS-π's class rows sorted): the
  plain version resumed from the canonical carry equals it resumed from
  the reference's raw carry; after every chunk the port's canonical
  carry equals the reference's carry in canonical form; and a model of
  the kernels' run-length state loads a carried W, steps and writes it
  back equal to the plain version's carry.
"""

import numpy as np
import pytest
import torch

from _torch_jaxref import port_batch, ref_engines, ref_workload, x64

import jax.numpy as jnp
from repro.core import sim_batch as ref_sim_batch

from repro_torch.bench import fm_cases, stream_cases
from repro_torch.core import engines, sim_torch, stream, workload
from repro_torch.kernels.msj_scan import kernel as K

from test_torch_msj_scan import _RunLength

POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs")
FIELDS = ("jobs", "reps", "mean_response", "var_response", "mean_wait",
          "var_wait", "p_wait", "p_helper", "p_routed")
J, R = 240, 2
SCHEDULES = (J, J // 4, 100)          # one chunk, J/4, ragged (100+100+40)
BACKLOG = 48                          # both sides: B steps a chunk


def assert_stream_equal(a, b, what=""):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, (what, f)
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), (what, f)


def _kw(pol):
    return {"backlog_cap": BACKLOG} if pol == "bs-fcfs" else {}


# -- sources -----------------------------------------------------------------


def _trace(side):
    wl = side.figure1_workload(32)
    return wl.sample_trace(120, seed=2)


SOURCES = {
    "replay": lambda s: s.TraceReplaySource(
        s.figure1_workload(32).sample_traces(J, R, seed=6)),
    "poisson": lambda s: s.PoissonSource(s.figure1_workload(32), reps=R,
                                         seed=5),
    "diurnal": lambda s: s.DiurnalSource(s.figure1_workload(32), reps=R,
                                         seed=5, period=40.0, amplitude=0.6),
    "flash": lambda s: s.FlashCrowdSource(s.figure1_workload(32), reps=R,
                                          seed=5, at=10.0, duration=20.0,
                                          factor=2.5),
    "mmpp": lambda s: s.MMPPSource(s.figure1_workload(32), reps=R,
                                   rates=(0.5, 3.0), stay=(8.0, 4.0), seed=5),
    "bootstrap_iid": lambda s: s.BootstrapSource(_trace(s), reps=R, seed=3),
    "bootstrap_block": lambda s: s.BootstrapSource(_trace(s), reps=R, seed=3,
                                                   method="block",
                                                   block_len=7),
    "from_trace": lambda s: s.BatchTrace.from_trace(_trace(s), R, seed=4,
                                                    method="block",
                                                    stream=True),
}


def _chunks_of(src, chunk):
    st = src.init_state()
    out = []
    for lo, hi in stream_cases.bounds(J, chunk):
        b, st = src.next_chunk(st, hi - lo)
        out.append((b, st))
    return out


@pytest.mark.parametrize("chunk", SCHEDULES)
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_source_chunks_equal_the_reference(name, chunk):
    port = _chunks_of(SOURCES[name](workload), chunk)
    ref = _chunks_of(SOURCES[name](ref_workload), chunk)
    for (pb, ps), (rb, rs) in zip(port, ref):
        for f in ("arrival", "cls", "service", "need"):
            x, y = getattr(pb, f), getattr(rb, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert (pb.k, pb.C) == (rb.k, rb.C)
        assert ps.keys() == rs.keys()
        for key in ps:
            assert np.array_equal(ps[key], rs[key]), key
    src, rsrc = SOURCES[name](workload), SOURCES[name](ref_workload)
    assert type(src).__name__ == type(rsrc).__name__
    assert (src.reps, src.k, src.C, src.total_jobs) == (
        rsrc.reps, rsrc.k, rsrc.C, rsrc.total_jobs)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_chunk_fetched_again_from_its_state_is_the_same(name):
    src = SOURCES[name](workload)
    st = src.init_state()
    states, chunks = [], []
    for _ in range(3):
        states.append(st)
        b, st = src.next_chunk(st, 50)
        chunks.append(b)
    again, _ = src.next_chunk(states[1], 50)
    for f in ("arrival", "cls", "service", "need"):
        assert np.array_equal(getattr(again, f), getattr(chunks[1], f)), f


def test_batch_chunks_and_slices_equal_the_reference():
    wl = workload.figure1_workload(32)
    b = wl.sample_traces(J, R, seed=8)
    rb = ref_workload.figure1_workload(32).sample_traces(J, R, seed=8)
    for p, r in zip(b.chunks(70), rb.chunks(70)):
        for f in ("arrival", "cls", "service", "need"):
            assert np.array_equal(getattr(p, f), getattr(r, f))
    assert np.array_equal(b.slice_jobs(10, 30).arrival,
                          rb.slice_jobs(10, 30).arrival)
    with pytest.raises(ValueError, match="chunk_jobs"):
        next(b.chunks(0))


# -- streams -----------------------------------------------------------------


@pytest.mark.parametrize("k", (32, 256))
@pytest.mark.parametrize("pol", POLICIES)
def test_stream_equals_reference_and_folded_batches(pol, k):
    wl = workload.figure1_workload(k)
    rwl = ref_workload.figure1_workload(k)
    rb = rwl.sample_traces(J, R, seed=3)
    b = port_batch(rb)
    fold_port = stream.stream_fold(engines.simulate(pol, b, device="cpu",
                                                    wl=wl))
    fold_ref = ref_sim_batch.stream_fold(ref_engines.simulate(
        pol, rb, engine="jax", wl=rwl))
    assert_stream_equal(fold_port, fold_ref, "folds")
    for chunk in SCHEDULES:
        got = engines.simulate_stream(pol, b, device="cpu", chunk_jobs=chunk,
                                      wl=wl, **_kw(pol))
        ref = ref_engines.simulate_stream(
            pol, ref_workload.TraceReplaySource(rb), engine="jax",
            chunk_jobs=chunk, wl=rwl, **_kw(pol))
        assert_stream_equal(got, ref, f"reference chunk={chunk}")
        assert_stream_equal(got, fold_port, f"fold chunk={chunk}")


@pytest.mark.parametrize("pol", POLICIES)
def test_generated_stream_equals_the_reference(pol):
    wl = workload.figure1_workload(32)
    rwl = ref_workload.figure1_workload(32)
    kw = dict(chunk_jobs=70, total_jobs=300, **_kw(pol))
    got = engines.simulate_stream(
        pol, workload.DiurnalSource(wl, reps=R, seed=2, period=30.0),
        device="cpu", wl=wl, **kw)
    ref = ref_engines.simulate_stream(
        pol, ref_workload.DiurnalSource(rwl, reps=R, seed=2, period=30.0),
        engine="jax", wl=rwl, **kw)
    assert_stream_equal(got, ref)


@pytest.mark.parametrize("name", sorted(stream_cases.BS_STREAMABLE))
def test_stream_on_bs_adversarial_cases(name):
    """The streamable BS-π adversarial cases (``wrap`` overflows its ring
    by design and ``drain_heavy`` has failures; neither streams): every
    policy's stream, in a chunk of 150 and a ragged one of 90, equals its
    folded batch and the reference's stream."""
    b, wl = stream_cases.bs_case_batch(name, J, R, 5)
    rwl = {"kit512": ref_workload.kit_fh2_workload(k=512, load=0.85),
           "sdsc": ref_workload.sdsc_sp2_workload(k=1024, load=0.85),
           "ties": ref_workload.figure1_workload(256)}[name]
    rb = ref_workload.BatchTrace(arrival=b.arrival, cls=b.cls,
                                 service=b.service, need=b.need, k=b.k,
                                 C=b.C)
    for pol in POLICIES:
        fold = stream.stream_fold(engines.simulate(pol, b, device="cpu",
                                                   wl=wl))
        got = engines.simulate_stream(pol, b, device="cpu", chunk_jobs=150,
                                      wl=wl, **_kw(pol))
        ref = ref_engines.simulate_stream(pol, rb, engine="jax",
                                          chunk_jobs=150, wl=rwl, **_kw(pol))
        assert_stream_equal(got, fold, pol)
        assert_stream_equal(got, ref, pol)


def test_stream_accumulator_equals_the_reference():
    rng = np.random.default_rng(1)
    resp, wait = rng.gamma(2.0, size=(3, 1000)), rng.gamma(1.0, size=(3, 1000))
    flags = rng.random((3, 1000)) < 0.3
    accs = [stream.StreamAccumulator(3, block=64),
            ref_sim_batch.StreamAccumulator(3, block=64)]
    for lo, hi in zip([0, 1, 8, 63, 64, 65, 200, 512],
                      [1, 8, 63, 64, 65, 200, 512, 1000]):
        for acc in accs:
            acc.push(resp[:, lo:hi], wait[:, lo:hi], flags[:, lo:hi],
                     flags[:, lo:hi])
    (ca, ma, va), (cb, mb, vb) = (acc.finalize() for acc in accs)
    assert ca == cb and np.array_equal(ma, mb) and np.array_equal(va, vb)
    sa, sb = (acc.state() for acc in accs)
    assert all(np.array_equal(sa[key], sb[key]) for key in sb)
    fresh = stream.StreamAccumulator(3, block=64)
    fresh.load_state(sa)
    assert np.array_equal(fresh.finalize()[1], ma)


# -- the canonical carries ---------------------------------------------------


def _ref_fcfs_chunk(carry, a, n, v):
    with x64():
        W, tp = carry
        (W, tp), starts = ref_sim_batch._fcfs_stream_chunk(
            (jnp.asarray(W), jnp.asarray(tp)), jnp.asarray(a),
            jnp.asarray(n, jnp.int32), jnp.asarray(v))
        return (np.asarray(W), np.asarray(tp)), np.asarray(starts)


def _ref_modbs_chunk(carry, a, c, n, v, s_max):
    with x64():
        comp, W, tp = (jnp.asarray(x) for x in carry)
        (comp, W, tp), (blocked, starts) = ref_sim_batch._modbs_stream_chunk(
            (comp, W, tp), jnp.asarray(a), jnp.asarray(c, jnp.int32),
            jnp.asarray(n, jnp.int32), jnp.asarray(v), s_max)
        return ((np.asarray(comp), np.asarray(W), np.asarray(tp)),
                (np.asarray(blocked), np.asarray(starts)))


def _fm_traces():
    """(name, FMCase) of the clean fm_cases.ADVERSARIAL cases (streams
    have no failures) and two Fig. 1 traces."""
    cases = [(n, fm_cases.ADVERSARIAL[n](J, R, 4))
             for n in sorted(fm_cases.ADVERSARIAL)]
    cases += [(f"fig1_k{k}", fm_cases.fig1_case(k, J, R, 9))
              for k in (32, 256)]
    return [(n, c) for n, c in cases if not c.drain]


FM = dict(_fm_traces())


def _np(ts):
    return [t.numpy() for t in ts]


@pytest.mark.parametrize("name", sorted(FM))
def test_clamped_fcfs_carry_resumes_as_the_raw_one(name):
    """Exactness claim 1: FCFS resumed from W clamped to >= t_prev gives
    the starts it gives resumed from the reference's raw W, at every
    cut."""
    case = FM[name]
    a, n, v = _np(case.fcfs)
    k = case.k
    for cut in (1, J // 3, J - 7):
        carry = (np.zeros((R, k)), np.zeros(R))
        carry, _ = _ref_fcfs_chunk(carry, a[:, :cut], n[:, :cut], v[:, :cut])
        W_raw, tp = (torch.tensor(x) for x in carry)
        rest = [torch.tensor(x[:, cut:]) for x in (a, n, v)]
        _, _, s_raw = sim_torch._fcfs_stream_core(W_raw, tp, *rest)
        W_c = torch.maximum(W_raw, tp[:, None])
        _, _, s_can = sim_torch._fcfs_stream_core(W_c, tp, *rest)
        assert torch.equal(s_raw, s_can), cut


@pytest.mark.parametrize("name", sorted(FM))
def test_sorted_modbs_carry_resumes_as_the_raw_one(name):
    """Exactness claim 2: ModBS-π resumed from each class row sorted (and
    the helper's W clamped) gives the outputs it gives resumed from the
    reference's raw slot-indexed rows."""
    case = FM[name]
    a, c, n, v = _np(case.modbs)
    s_max, h = case.s_max, case.h
    comp0, W0, tp0 = (x.numpy() for x in sim_torch._modbs_init(
        case.slots, s_max, h, R))
    for cut in (1, J // 3, J - 7):
        carry, _ = _ref_modbs_chunk((comp0, W0, tp0), a[:, :cut],
                                    c[:, :cut], n[:, :cut], v[:, :cut],
                                    s_max)
        comp, W, tp = (torch.tensor(x) for x in carry)
        rest = [torch.tensor(x[:, cut:]) for x in (a, c, n, v)]
        raw = sim_torch._modbs_stream_core(comp, W, tp, *rest)
        can = sim_torch._modbs_stream_core(
            torch.sort(comp, dim=2).values, torch.maximum(W, tp[:, None]),
            tp, *rest)
        assert torch.equal(raw[3], can[3]) and torch.equal(raw[4], can[4])
        assert all(torch.equal(x, y) for x, y in zip(raw[:3], can[:3]))


@pytest.mark.parametrize("name", sorted(FM))
def test_fm_carries_equal_the_reference_in_canonical_form(name):
    """After every chunk the port's carries are the reference's in
    canonical form: FCFS W == maximum(W_ref, t_prev_ref), ModBS-π rows ==
    sort(comp_ref) per row; the outputs are the reference's."""
    case = FM[name]
    cuts = stream_cases.bounds(J, 70)
    a, n, v = _np(case.fcfs)
    port = stream_cases.fcfs_chunks(K.fcfs_stream_fwd, *case.fcfs, case.k,
                                    cuts)
    carry = (np.zeros((R, case.k)), np.zeros(R))
    for (lo, hi), (starts, W, tp) in zip(cuts, port):
        carry, s_ref = _ref_fcfs_chunk(carry, a[:, lo:hi], n[:, lo:hi],
                                       v[:, lo:hi])
        assert np.array_equal(starts.numpy(), s_ref)
        assert np.array_equal(W.numpy(), np.maximum(carry[0],
                                                    carry[1][:, None]))
        assert np.array_equal(tp.numpy(), carry[1])
    a, c, n, v = _np(case.modbs)
    port = stream_cases.modbs_chunks(K.modbs_stream_fwd, *case.modbs,
                                     case.slots, case.s_max, case.h, cuts)
    carry = tuple(x.numpy() for x in sim_torch._modbs_init(
        case.slots, case.s_max, case.h, R))
    for (lo, hi), (blocked, starts, comp, W, tp) in zip(cuts, port):
        carry, (b_ref, s_ref) = _ref_modbs_chunk(
            carry, a[:, lo:hi], c[:, lo:hi], n[:, lo:hi], v[:, lo:hi],
            case.s_max)
        assert np.array_equal(blocked.numpy(), b_ref)
        assert np.array_equal(starts.numpy(), s_ref)
        assert np.array_equal(comp.numpy(), np.sort(carry[0], axis=2))
        assert np.array_equal(W.numpy(), np.maximum(carry[1],
                                                    carry[2][:, None]))


@pytest.mark.parametrize("k", (32, 256))
def test_bs_canonical_state_equals_the_reference_after_every_chunk(k):
    """BS-π: after every chunk the port's canonical state (``_bs_extract``
    of its carry) and event streams equal the reference's, from the
    reference's own jitted chunk scan; at k = 32 a backlog crosses a
    chunk boundary."""
    wl = workload.figure1_workload(k)
    rb = ref_workload.figure1_workload(k).sample_traces(J, R, seed=3)
    b = port_batch(rb)
    part, slots, s_max, h, q_cap, B = stream._bs_stream_args(
        None, wl, 60, None, BACKLOG)
    cuts = stream_cases.bounds(J, 60)
    port = stream_cases.bs_chunks(K.bs_stream_fwd, b, slots, s_max, h, q_cap,
                                  B, cuts, "cpu")
    scan = ref_sim_batch._bs_chunk_scan_jax(len(slots), s_max, h, q_cap)
    canon = ref_sim_batch._bs_canon0(R, len(slots), s_max, h, B, slots)
    backlog = 0
    for (lo, hi), got in zip(cuts, port):
        horizon = rb.arrival[:, hi] if hi < J else np.full(R, np.inf)
        carry, rec, idmap = ref_sim_batch._bs_inflate(
            canon, rb.slice_jobs(lo, hi), lo, slots, s_max, h, q_cap, B)
        carry, tagged, rec_t = scan(carry, rec, horizon,
                                    2 * (hi - lo) + B + len(slots) * s_max)
        canon = ref_sim_batch._bs_extract(carry, idmap, rec, B, len(slots),
                                          q_cap)
        assert np.array_equal(got[10].numpy(), tagged)
        assert np.array_equal(got[11].numpy(), rec_t)
        assert got[12].keys() == canon.keys()
        for key in canon:
            assert np.array_equal(got[12][key], canon[key]), key
        for i in (0, 1, 2, 4, 5, 6, 7, 8, 9):   # all but the raw ring
            assert np.array_equal(got[i].numpy(), carry[i]), i
        backlog = max(backlog, int(canon["pend_n"].max()))
    assert backlog > 0 or k != 32


def _run_length_from(W, tp):
    """The run-length state of a carried W (clamped, sorted) and t_prev."""
    s = _RunLength(len(W))
    above = W[W > tp]
    s.F, s.t_prev = len(W) - len(above), tp
    vals, counts = np.unique(above, return_counts=True)
    s.groups = [[float(x), int(m)] for x, m in zip(vals, counts)]
    return s


def _run_length_to(s):
    return np.array([s.t_prev] * s.F
                    + [v for v, m in s.groups for _ in range(m)])


@pytest.mark.parametrize("name", sorted(FM))
def test_run_length_model_carries_like_the_plain_version(name):
    """A model of the FCFS kernels' run-length state, loaded from each
    chunk's carried W, steps the chunk and writes W back equal to the
    plain version's canonical carry, with its starts."""
    case = FM[name]
    a, n, v = _np(case.fcfs)
    cuts = stream_cases.bounds(J, 50)
    plain = stream_cases.fcfs_chunks(K.fcfs_stream_ref, *case.fcfs, case.k,
                                     cuts)
    for r in range(R):
        W, tp = np.zeros(case.k), 0.0
        for (lo, hi), (starts, W_p, tp_p) in zip(cuts, plain):
            s = _run_length_from(W, tp)
            s.check()
            for j in range(lo, hi):
                assert s.arrival(a[r, j], n[r, j], v[r, j]) == \
                    starts[r, j - lo]
            W, tp = _run_length_to(s), s.t_prev
            assert np.array_equal(W, W_p[r].numpy()) and tp == tp_p[r]


def test_bs_stream_carries_only_the_queued_ring_entries():
    """The BS-π plain chunk scan gives its ring back with each class's
    queued entries only (0 elsewhere), as the kernel writes it, and
    leaves the caller's carry untouched."""
    wl = workload.figure1_workload(32)
    b = wl.sample_traces(J, R, seed=3)
    part, slots, s_max, h, q_cap, B = stream._bs_stream_args(
        None, wl, 60, None, BACKLOG)
    C = len(slots)
    canon = stream._bs_canon0(R, C, s_max, h, B, slots)
    carry, rec, _ = stream._bs_inflate(canon, b.slice_jobs(0, 60), 0, slots,
                                       s_max, h, q_cap, B)
    dev = tuple(torch.as_tensor(c, dtype=d)
                for c, d in zip(carry, sim_torch.BS_CARRY_DTYPES))
    before = [t.clone() for t in dev]
    out, _, _ = K.bs_stream_fwd(
        *(torch.as_tensor(x, dtype=d) for x, d in zip(
            rec, (torch.float64, torch.int32, torch.int32, torch.float64))),
        torch.tensor(slots), torch.tensor(b.arrival[:, 60]), dev,
        s_max=s_max, h=h, q_cap=q_cap, length=120 + B + C * s_max)
    assert all(torch.equal(x, y) for x, y in zip(before, dev))
    st, ring = out[1], out[3]
    assert torch.equal(ring, sim_torch.bs_live_ring(ring, st, C, q_cap))
    queued = int((st[:, 2 * C:] - st[:, C:2 * C]).sum())
    assert int((ring != 0).sum()) <= queued
