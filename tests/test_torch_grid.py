"""The port's grid path against the JAX reference's, rtol=0.

``engines.simulate_grid`` stacks a grid's cells — here
``tests/test_grid.py``'s three-class workload at (k, J) = (32, 200) and
(256, 120), R = 3, so both the k padding (dead servers, padded slots and
classes) and the J padding (sentinel jobs, ``j_live``) are exercised —
onto one lane axis and makes one wrapper call per policy.  On this CPU
the wrappers run their plain versions with per-lane sizes; every grid
cell must equal the reference's ``simulate_grid(engine="jax")`` cell and
the port's per-cell ``simulate`` on every field, for the five scan
policies clean and the three FCFS-family policies in drain mode.  The
CUDA kernels are held to the same per-cell results on the card by
``tests/test_torch_card.py`` and ``chip_smoke.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_jaxref import port_batch, ref_engines, ref_workload
from repro.core import failures as ref_flr

from repro_torch.bench import fig3_traces
from repro_torch.core import engines, sim_torch, workload
from repro_torch.core import failures as flr
from repro_torch.core.sim_batch import (QueueOverflowError, _bs_fail_args,
                                        _merged_class_inputs,
                                        _merged_fcfs_inputs, _srpt_nu)
from repro_torch.core.sim_torch import _bs_args
from repro_torch.kernels.msj_scan import kernel as K
from repro_torch.kernels.msj_scan import ops

from test_torch_msj_scan import _RunLength

CELL_SHAPES = ((32, 200), (256, 120))
R = 3
SCAN = ("fcfs", "modbs-fcfs", "bs-fcfs", "sf-srpt", "ff-srpt")
DRAIN = ("fcfs", "modbs-fcfs", "bs-fcfs")
CASES = [(p, False) for p in SCAN] + [(p, True) for p in DRAIN]
#: the wrapper each policy's grid core calls, by (policy, drain)
WRAPPER = {"fcfs": "fcfs_scan_fwd", "modbs-fcfs": "modbs_scan_fwd",
           "bs-fcfs": "bs_scan_fwd", "sf-srpt": "srpt_scan_fwd",
           "ff-srpt": "srpt_scan_fwd"}


def _wl(mod, k, load=0.8):
    """``tests/test_grid.py``'s workload, from ``mod`` (the reference's or
    the port's workload module)."""
    return mod.Workload(k=k, lam=1.0, classes=(
        mod.JobClass("s", 1, mod.Exp(1.0), 0.7),
        mod.JobClass("m", 4, mod.Exp(4.0), 0.2),
        mod.JobClass("l", 8, mod.Exp(8.0), 0.1))).with_load(load)


@functools.lru_cache(maxsize=None)
def _cells(drain: bool):
    """(reference cells, port cells) on the same seeded batches and, in
    drain mode, the same outage histories (tests/test_grid.py's)."""
    ref, port = [], []
    for g, (k, J) in enumerate(CELL_SHAPES):
        rwl = _wl(ref_workload, k)
        rb = rwl.sample_traces(J, R, seed=g)
        rfb = pfb = None
        if drain:
            h = float(rb.arrival.max())
            rfb = ref_flr.FailureProcess(mtbf=h / 2, mttr=h / 40,
                                         mode="drain").sample(k, h, R,
                                                              seed=g)
            pfb = flr.FailureProcess(mtbf=h / 2, mttr=h / 40,
                                     mode="drain").sample(k, h, R, seed=g)
        ref.append(ref_engines.GridCell(rb, wl=rwl, failures=rfb))
        port.append(engines.GridCell(port_batch(rb), wl=_wl(workload, k),
                                     failures=pfb))
    return tuple(ref), tuple(port)


def _assert_same(out, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert a.dtype == b.dtype, f.name
            assert np.array_equal(a, b), f.name


# -- simulate_grid -----------------------------------------------------------


@pytest.mark.parametrize("policy,drain", CASES)
def test_grid_cells_equal_reference_grid_and_per_cell(policy, drain):
    ref_cells, cells = _cells(drain)
    out = engines.simulate_grid(policy, cells, device="cpu")
    ref = ref_engines.simulate_grid(policy, ref_cells, engine="jax")
    assert len(out) == len(ref) == len(cells)
    for cell, o, r in zip(cells, out, ref):
        _assert_same(o, r)
        _assert_same(o, engines.simulate(policy, cell.batch, wl=cell.wl,
                                         failures=cell.failures,
                                         device="cpu"))


@pytest.mark.parametrize("policy,drain", CASES)
def test_grid_makes_one_wrapper_call(policy, drain, monkeypatch):
    """A grid is one call of its policy's wrapper (one launch on the card)
    and no call of any other, whatever its cell count."""
    calls = {}
    for name in set(WRAPPER.values()) | {
            "fcfs_fail_scan_fwd", "modbs_fail_scan_fwd", "bs_fail_scan_fwd"}:
        def counted(*a, _name=name, _fn=getattr(ops, name), **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    engines.simulate_grid(policy, _cells(drain)[1], device="cpu")
    want = WRAPPER[policy].replace("_scan", "_fail_scan") if drain \
        else WRAPPER[policy]
    assert calls == {want: 1}


def test_grid_errors_are_loud():
    _, cells = _cells(False)
    _, fcells = _cells(True)
    with pytest.raises(ValueError, match="at least one cell"):
        engines.simulate_grid("fcfs", [], device="cpu")
    with pytest.raises(ValueError, match="one replication count"):
        b = cells[1].batch
        short = workload.BatchTrace.from_arrays(
            b.arrival[:1], b.cls[:1], b.service[:1], b.need[:1], b.k, b.C)
        engines.simulate_grid("fcfs", [cells[0], dataclasses.replace(
            cells[1], batch=short)], device="cpu")
    with pytest.raises(ValueError, match="mixed failure"):
        engines.simulate_grid("bs-fcfs", [fcells[0], cells[1]],
                              device="cpu")
    b = cells[1].batch
    bad = workload.BatchTrace.from_arrays(b.arrival, b.cls, -b.service,
                                          b.need, b.k, b.C)
    with pytest.raises(ValueError, match="grid cell 1: negative service"):
        engines.simulate_grid("fcfs", [cells[0], dataclasses.replace(
            cells[1], batch=bad)], device="cpu")
    with pytest.raises(NotImplementedError, match="fault-injection"):
        engines.simulate_grid("sf-srpt", fcells, device="cpu")
    with pytest.raises(ValueError, match="grid cell 0: need a partition"):
        engines.simulate_grid("modbs-fcfs", [dataclasses.replace(
            cells[0], wl=None)], device="cpu")
    with pytest.raises(KeyError, match="no simulation core"):
        engines.simulate_grid("srpt", cells, device="cpu")
    with pytest.raises(ValueError, match="unknown engine 'torch' for "
                                         "policy 'msf'"):
        engines.simulate_grid("msf", cells, device="cpu")
    assert engines.grid_registered() == tuple(
        (p, "torch") for p in sorted(SCAN))
    assert engines.grid_engines_for("bs") == ("torch",)


@pytest.mark.parametrize("policy,queue_cap", [("bs-fcfs", 2),
                                              ("sf-srpt", 4)])
def test_overflowing_cell_is_named(policy, queue_cap):
    """A cell whose bounded queue overflows raises QueueOverflowError
    naming its grid cell, as the reference's grid does: cell 0 at load
    0.1 fits the queue, cell 1 (k = 32 at load 0.8) overflows it."""
    ref_cells, cells = _cells(False)
    light = _wl(workload, 32, load=0.1)
    rlight = _wl(ref_workload, 32, load=0.1)
    rb0 = rlight.sample_traces(200, R, seed=0)
    ref_cells = (ref_engines.GridCell(rb0, wl=rlight, queue_cap=queue_cap),
                 dataclasses.replace(ref_cells[0], queue_cap=queue_cap))
    cells = (engines.GridCell(port_batch(rb0), wl=light,
                              queue_cap=queue_cap),
             dataclasses.replace(cells[0], queue_cap=queue_cap))
    with pytest.raises(RuntimeError, match="grid cell 1 ") as ref:
        ref_engines.simulate_grid(policy, ref_cells, engine="jax")
    with pytest.raises(QueueOverflowError, match="grid cell 1 ") as out:
        engines.simulate_grid(policy, cells, device="cpu")
    assert str(out.value) == str(ref.value)


@pytest.mark.parametrize("extra", [0, 1, 37])
def test_pad_jobs_equals_reference(extra):
    ref_cells, cells = _cells(False)
    rb, pb = ref_cells[1].batch, cells[1].batch
    out = pb.pad_jobs(pb.num_jobs + extra)
    ref = rb.pad_jobs(rb.num_jobs + extra)
    for f in ("arrival", "cls", "service", "need"):
        assert np.array_equal(getattr(out, f), getattr(ref, f)), f
    assert (out.k, out.C) == (ref.k, ref.C)
    with pytest.raises(ValueError, match="cannot pad"):
        pb.pad_jobs(pb.num_jobs - 1)


# -- the wrappers with per-lane sizes ----------------------------------------


def _lane_inputs(k, J, seed):
    """A cell's trace tensors and sizes (its own k, partition and J)."""
    wl = _wl(workload, k)
    b = wl.sample_traces(J, 2, seed=seed)
    slots, s_max, h, q_cap = _bs_args(b, None, wl, None)
    t = dict(a=torch.tensor(b.arrival),
             c=torch.tensor(b.cls, dtype=torch.int32),
             n=torch.tensor(b.need, dtype=torch.int32),
             v=torch.tensor(b.service),
             slots=torch.tensor(slots, dtype=torch.int32))
    return wl, b, t, dict(k=k, s_max=s_max, h=h, q_cap=q_cap, J=J)


def _stack(xs, J_pad, fill):
    return torch.cat([torch.nn.functional.pad(x, (0, J_pad - x.shape[1]),
                                              value=fill) for x in xs])


def _lanes(values, reps=2):
    return torch.tensor(np.repeat(values, reps), dtype=torch.int32)


def _untag(tag, jl, J):
    """A single cell's BS event tags (encoded with its own J = jl) as a
    lane of J_pad = J encodes them."""
    return torch.where(tag < jl, tag, torch.where(
        tag < 2 * jl, tag - jl + J, torch.where(tag >= 0, tag - 2 * jl
                                                + 2 * J, tag)))


@pytest.mark.parametrize("name", ["fcfs", "modbs", "bs", "srpt",
                                  "fcfs_fail", "modbs_fail", "bs_fail"])
def test_per_lane_plain_versions_equal_single_cell_calls(name):
    """One wrapper call over two cells' lanes (k 32 / 256, their own
    partitions and helpers; the BS and SRPT cells also of J 200 / 120)
    gives, lane for lane, each cell's own single-cell call."""
    cells = [_lane_inputs(32, 200, 1), _lane_inputs(256, 120, 2)]
    if name in ("fcfs", "modbs", "fcfs_fail", "modbs_fail"):
        cells[1] = _lane_inputs(256, 200, 2)
    J = max(sz["J"] for *_, sz in cells)
    pads = [b.pad_jobs(J) for _, b, _, _ in cells]
    a = torch.tensor(np.concatenate([p.arrival for p in pads]))
    c = torch.tensor(np.concatenate([p.cls for p in pads]),
                     dtype=torch.int32)
    n = torch.tensor(np.concatenate([p.need for p in pads]),
                     dtype=torch.int32)
    v = torch.tensor(np.concatenate([p.service for p in pads]))
    szs = [sz for *_, sz in cells]
    C = max(t["slots"].numel() for _, _, t, _ in cells)
    slots = torch.cat([torch.nn.functional.pad(
        t["slots"], (0, C - t["slots"].numel())).expand(2, -1)
        for _, _, t, _ in cells]).contiguous()
    pad = dict(s_max=max(s["s_max"] for s in szs),
               h=max(s["h"] for s in szs),
               h_lane=_lanes([s["h"] for s in szs]))
    jl = _lanes([s["J"] for s in szs])
    k_pad, k_lane = max(s["k"] for s in szs), _lanes([s["k"] for s in szs])
    singles, grid = [], None
    if name == "fcfs":
        grid = (K.fcfs_scan_fwd(a, n, v, k=k_pad, k_lane=k_lane),)
        singles = [(K.fcfs_scan_fwd(t["a"], t["n"], t["v"], k=s["k"]),)
                   for _, _, t, s in cells]
    elif name == "modbs":
        grid = K.modbs_scan_fwd(a, c, n, v, slots, **pad)
        singles = [K.modbs_scan_fwd(t["a"], t["c"], t["n"], t["v"],
                                    t["slots"], s_max=s["s_max"], h=s["h"])
                   for _, _, t, s in cells]
    elif name == "bs":
        tg, rt, ovf = K.bs_scan_fwd(a, c, n, v, slots, q_cap=200, j_live=jl,
                                    **pad)
        for i, (_, _, t, s) in enumerate(cells):
            st, sr, so = K.bs_scan_fwd(t["a"], t["c"], t["n"], t["v"],
                                       t["slots"], s_max=s["s_max"],
                                       h=s["h"], q_cap=200)
            lane = slice(2 * i, 2 * i + 2)
            e = 2 * s["J"]
            assert torch.equal(tg[lane, :e], _untag(st, s["J"], J))
            assert torch.equal(rt[lane, :e], sr)
            assert torch.equal(so, ovf[lane])
            assert (tg[lane, e:] == -1).all()
            assert (rt[lane, e:] == sim_torch._BIG).all()
        return
    elif name == "srpt":
        kk = torch.tensor(np.repeat([32.0, 256.0], 2))
        NU = _srpt_nu(*(b for _, b, _, _ in cells))
        Q = 256
        out = K.srpt_scan_fwd(a, n.double(), v, kk, Q=Q, NU=NU, sf=True,
                              j_live=jl)
        for i, (_, _, t, s) in enumerate(cells):
            one = K.srpt_scan_fwd(t["a"], t["n"].double(), t["v"],
                                  kk[2 * i:2 * i + 2].clone(), Q=Q, NU=NU,
                                  sf=True)
            lane = slice(2 * i, 2 * i + 2)
            e = 2 * s["J"]
            for x, y in zip(out[:3], one[:3]):
                assert torch.equal(x[lane, :e], y)
                assert (x[lane, e:] == (-1.0 if x is out[0] else 0.0)).all()
            for x, y in zip(out[3:], one[3:]):
                assert torch.equal(x[lane], y)
        return
    else:
        merged = []
        for wl, b, t, s in cells:
            fb = flr.FailureProcess(mtbf=40.0, mttr=6.0).sample(
                s["k"], float(b.arrival.max()), 2, seed=s["k"])
            if name == "fcfs_fail":
                merged.append(_merged_fcfs_inputs(b, fb))
            elif name == "modbs_fail":
                merged.append(_merged_class_inputs(b, fb, None, wl))
            else:
                merged.append((b, fb, wl))
        if name == "bs_fail":
            recs = [_bs_fail_args(b, fb, None, wl) for b, fb, wl in merged]
            F = max(r[0].shape[1] for r in recs)
            length = max(r[3] for r in recs)
            ft = _stack([torch.tensor(r[0]) for r in recs], F, np.inf)
            fup = _stack([torch.tensor(r[2]) for r in recs], F, 0.0)
            ftgt = torch.cat([torch.nn.functional.pad(
                torch.tensor(np.where(r[1] == len(t["slots"]), C, r[1]),
                             dtype=torch.int32), (0, F - r[0].shape[1]),
                value=C) for r, (_, _, t, _) in zip(recs, cells)])
            grid = K.bs_fail_scan_fwd(a, c, n, v, ft, ftgt, fup, slots,
                                      q_cap=200, length=length, j_live=jl,
                                      **pad)
            for i, ((_, _, t, s), r) in enumerate(zip(cells, recs)):
                one = K.bs_fail_scan_fwd(
                    t["a"], t["c"], t["n"], t["v"], torch.tensor(r[0]),
                    torch.tensor(r[1], dtype=torch.int32),
                    torch.tensor(r[2]), t["slots"], s_max=s["s_max"],
                    h=s["h"], q_cap=200, length=r[3])
                lane = slice(2 * i, 2 * i + 2)
                recorded = one[0] >= 0
                # the same events in the same order, tags re-encoded
                for r_ in range(2):
                    g_ok = grid[0][lane][r_] >= 0
                    assert torch.equal(grid[0][lane][r_][g_ok],
                                       _untag(one[0][r_][recorded[r_]],
                                              s["J"], J))
                    assert torch.equal(grid[1][lane][r_][g_ok],
                                       one[1][r_][recorded[r_]])
                assert torch.equal(grid[2][lane], one[2])
            return
        L = max(ms.t.shape[1] for ms in merged)
        C_cells = [t["slots"].numel() for _, _, t, _ in cells]
        cols = []
        for f, fill in (("t", 0.0), ("cls", C), ("need", 1),
                        ("service", 0.0), ("t_up", 0.0), ("is_fail", 1)):
            xs = []
            for ms, Cc in zip(merged, C_cells):
                x = torch.tensor(getattr(ms, f))
                if f == "cls":
                    x = torch.where(x == Cc, C, x)
                xs.append(x)
            x = _stack(xs, L, fill)
            cols.append(x.to({"cls": torch.int32, "need": torch.int32,
                              "is_fail": torch.bool}.get(f, torch.float64)))
        t_, c_, n_, v_, tu, isf = cols
        if name == "fcfs_fail":
            grid = (K.fcfs_fail_scan_fwd(t_, n_, v_, tu, isf, k=k_pad,
                                         k_lane=k_lane),)
        else:
            grid = K.modbs_fail_scan_fwd(t_, c_, n_, v_, tu, isf, slots,
                                         **pad)
        for ms, (_, _, t, s) in zip(merged, cells):
            m = (torch.tensor(ms.t), torch.tensor(ms.cls, dtype=torch.int32),
                 torch.tensor(ms.need, dtype=torch.int32),
                 torch.tensor(ms.service), torch.tensor(ms.t_up),
                 torch.tensor(ms.is_fail != 0))
            if name == "fcfs_fail":
                singles.append((K.fcfs_fail_scan_fwd(
                    m[0], *m[2:], k=s["k"]),))
            else:
                singles.append(K.modbs_fail_scan_fwd(
                    *m, t["slots"], s_max=s["s_max"], h=s["h"]))
    for i, one in enumerate(singles):
        lane = slice(2 * i, 2 * i + 2)
        for x, y in zip(grid, one):
            assert torch.equal(x[lane, :y.shape[1]], y)


@pytest.mark.parametrize("name", ["k7", "k33", "need1", "bursts", "ties",
                                  "drain_k33"])
def test_dead_servers_as_one_group_give_the_plain_starts(name):
    """The FCFS kernels' dead servers: with ``live`` of m servers live,
    the run-length state starts with one group at BIG of the m - live
    dead entries (``rs_init``); that model gives the plain scan's starts
    with ``k_lane = live`` padded to m, failure rows included."""
    from repro_torch.bench import fm_cases

    case = fm_cases.ADVERSARIAL[name](240, 2, 4)
    t, n, v = case.fcfs[:3]
    if case.drain:
        tu, isf = case.fcfs[3], case.fcfs[4]
    else:
        tu, isf = torch.zeros_like(t), torch.zeros_like(t, dtype=bool)
    live = case.k
    m = live + 40
    starts = sim_torch._fcfs_fail_core(t, n, v, tu, isf, m,
                                       torch.full((case.R,), live)).numpy()
    t, n, v, tu, isf = (x.numpy() for x in (t, n, v, tu, isf))
    for r in range(case.R):
        s = _RunLength(m, live)
        for j in range(t.shape[1]):
            assert s.start(t[r, j], n[r, j]) == starts[r, j]
            if isf[r, j]:
                s.drain(tu[r, j])
            else:
                s.arrival(t[r, j], n[r, j], v[r, j])
            s.check()
            assert s.groups[-1] == [sim_torch._BIG, m - live]


# -- the Fig. 3 script -------------------------------------------------------


FIG3 = dict(num_jobs=300, reps=2, ks=(128, 256), loads=(0.7,))


def test_fig3_grid_rows_equal_per_cell_rows():
    """``fig3_traces.run`` with its grid pre-pass gives the per-cell run's
    rows on every column but ``sim_s``."""
    scan = fig3_traces.SCAN_POLICIES
    grid = fig3_traces.run(**FIG3, policies=scan, device="cpu")
    cell = fig3_traces.run(**FIG3, policies=scan, device="cpu", grid=False)
    strip = lambda rows: [{c: v for c, v in r.items() if c != "sim_s"}
                          for r in rows]
    assert len(grid) == 20 and strip(grid) == strip(cell)


def test_fig3_grid_that_raises_falls_back_to_per_cell(monkeypatch):
    """A grid that raises (an overflowing cell) is dropped: its policy
    runs cell by cell and the overflowing cell gives the reference's row
    of infinite response times."""
    real = engines.simulate_grid
    seen = []

    def grid(policy, cells, **kw):
        seen.append(policy)
        if policy == "sf-srpt":
            raise QueueOverflowError("SRPT slot table overflow")
        return real(policy, cells, **kw)

    sim = engines.simulate
    monkeypatch.setattr(engines, "simulate_grid", grid)
    monkeypatch.setattr(engines, "simulate", lambda *a, **kw: sim(
        *a, **kw, **({"queue_cap": 2} if a[0] == "sf-srpt" else {})))
    kw = dict(FIG3, ks=(128,), policies=fig3_traces.SCAN_POLICIES)
    rows = fig3_traces.run(**kw, device="cpu")
    assert seen == list(fig3_traces.SCAN_POLICIES)
    for r in rows:
        if r["policy"] == "sf-srpt":
            assert r["mean_response"] == float("inf")
            assert r["note"].startswith("SRPT slot table overflow "
                                        "(queue_cap=2)")
        else:
            assert np.isfinite(r["mean_response"]) and "note" not in r
