"""The port's serving driver and fleet runtime against the JAX reference,
on the CPU.

* ``launch/serve.py`` — ``fit_fleet`` on a grid of peak rates, loads and
  floors; ``run_epochs`` for fcfs, modbs-fcfs and bs-fcfs on
  ``examples/serve_cluster.py``'s arguments (three epochs, one rescale):
  every printed line equal string for string and every ``StreamResult``
  field equal at rtol=0 (bs-fcfs from the ``main`` runs below); ``main``
  with those arguments prints the reference's stdout; ``--execute`` on
  float32 reduced configs with the reference engine's weights carried
  into the port's ``_params``: the tokens of rids 0–4 equal, and rid 5
  (``llamav-32k``) raises ``KeyError`` in both — in the port before its
  weights are made.  On the card ``deepseek-32k`` is a cut, and
  ``--device cuda`` without one raises before anything is printed.
* ``sched/elastic.py`` — ``elastic_repartition`` on schedulers holding
  running class gangs, helper gangs and waiting gangs (hypothesis-drawn,
  and one shrink that survives, requeues and kills): the
  ``RescaleReport`` and the new scheduler's whole state equal.
* ``sched/gang.py``'s ``simulate_gangs``: every job's start, finish and
  placement in completion order.
* ``runtime/`` — ``StragglerMitigator.tick`` and ``FleetMonitor``.

The reference's decode step is compiled once per config (``jax.jit``)
rather than traced at every step (~1 s a step eagerly); greedy tokens are
the same either way (``tests/test_torch_models.py`` does the same).
torch runs on one thread here: the plain BS-π stream scan is ~27 000
small steps, which more threads only slow down.
"""

import ast
import contextlib
import dataclasses
import functools
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_jaxref import ref_workload

import jax
from repro.launch import serve as ref_serve
from repro.models import model as ref_model
from repro.runtime import fault_tolerance as ref_ft
from repro.runtime import straggler as ref_straggler
from repro.sched import cluster as ref_cluster
from repro.sched import elastic as ref_elastic
from repro.sched import gang as ref_gang
from repro.serve import engine as ref_engine

from repro_torch.core import stream, workload
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import FleetMonitor, NodeFailure, StragglerMitigator
from repro_torch.sched import cluster, elastic, gang
from repro_torch.serve import engine
from repro_torch.serve.cuts import mla_cut

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("fcfs", "modbs-fcfs", "bs-fcfs")
FIELDS = tuple(f.name for f in dataclasses.fields(stream.StreamResult))
# the reference's --execute draws at seed 0 (rid 5 is the first llamav)
EXECUTE_DRAWS = ["starcoder-8k", "deepseek-32k", "yi9b-8k", "deepseek-32k",
                 "yi9b-8k", "llamav-32k"]


def _example_args():
    """The argument list ``examples/serve_cluster.py`` passes to main."""
    tree = ast.parse((ROOT / "examples" / "serve_cluster.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "main")
    return ast.literal_eval(call.args[0])


EXAMPLE = _example_args()


def _opt(name):
    return EXAMPLE[EXAMPLE.index(name) + 1]


EPOCH_KW = dict(fleet=int(_opt("--fleet")), epochs=int(_opt("--epochs")),
                epoch_jobs=int(_opt("--epoch-jobs")),
                chunk_jobs=int(_opt("--chunk-jobs")), reps=int(_opt("--reps")),
                load=float(_opt("--load")), period=float(_opt("--period")),
                amplitude=0.5, seed=0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jit_ref_decode():
    cache = {}

    def decode_step(self, params, caches, tokens, pos):
        f = cache.get(self.cfg)
        if f is None:
            f = cache[self.cfg] = jax.jit(
                functools.partial(ref_model.decode_step, self.cfg))
        return f(params, caches, tokens, pos)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_model.Model, "decode_step", decode_step)
        yield


@pytest.fixture(scope="module")
def mains(jit_ref_decode):
    """Both drivers' ``main`` on the example's arguments (the port's with
    ``--device cpu``): {side: (stdout, the history of its run_epochs)}."""
    out = {}
    for side, mod, extra in (("ref", ref_serve, []),
                             ("port", serve, ["--device", "cpu"])):
        hist = []
        run = mod.run_epochs

        def spy(*a, **kw):
            hist.append(run(*a, **kw))
            return hist[-1]

        buf = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(buf):
            mp.setattr(mod, "run_epochs", spy)
            mod.main(EXAMPLE + extra)
        out[side] = (buf.getvalue(), hist[0])
    return out


def _assert_history_equal(got, ref):
    assert len(got) == len(ref)
    for (k, a), (rk, b) in zip(got, ref):
        assert k == rk
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if x is None or y is None:
                assert x is None and y is None, f
            else:
                assert np.array_equal(np.asarray(x), np.asarray(y)), (k, f)


# -- launch/serve.py ---------------------------------------------------------


def test_main_prints_the_reference_stdout(mains):
    got, ref = mains["port"][0], mains["ref"][0]
    assert got == ref
    assert "rescale: k 512 -> " in got
    assert got.count("  executed request ") == int(_opt("--execute"))


@pytest.mark.parametrize("policy", POLICIES)
def test_run_epochs_equals_the_reference(policy, mains):
    """Every epoch and rescale line string for string, and each epoch's
    k and ``StreamResult`` at rtol=0.  bs-fcfs, the driver's default
    policy, is the ``main`` runs' epoch loop."""
    if policy == "bs-fcfs":
        hist, ref_hist = mains["port"][1], mains["ref"][1]
        lines = mains["port"][0].split("  executed")[0].splitlines()
        ref_lines = mains["ref"][0].split("  executed")[0].splitlines()
    else:
        lines, ref_lines = [], []
        hist = serve.run_epochs(serve.default_classes(512, "cpu"),
                                policy=policy, device="cpu",
                                out=lambda s: lines.extend(s.splitlines()),
                                **EPOCH_KW)
        ref_hist = ref_serve.run_epochs(
            ref_serve.default_classes(512), policy=policy, engine="jax",
            out=lambda s: ref_lines.extend(s.splitlines()), **EPOCH_KW)
    assert lines == ref_lines
    assert sum(s.startswith("rescale:") for s in lines) >= 1
    assert len({k for k, _ in hist}) >= 2
    _assert_history_equal(hist, ref_hist)


@pytest.mark.parametrize("k_min", (1, 600))
@pytest.mark.parametrize("load", (0.5, 0.8, 0.95))
def test_fit_fleet_equals_the_reference(load, k_min):
    classes = serve.default_classes(512, "cpu")
    ref_classes = ref_serve.default_classes(512)
    for lam in np.geomspace(0.05, 200.0, 13):
        assert serve.fit_fleet(float(lam), classes, load, k_min) == \
            ref_serve.fit_fleet(float(lam), ref_classes, load, k_min)


def test_the_cards_classes_cut_deepseek_only():
    """On a card ``deepseek-32k`` serves deepseek-v3's 3 dense layers and
    its first MoE layer at full width, MTP off (15.1 B params); every other
    config, and every class's chips, service time and mix, are the
    reference's."""
    cpu = serve.default_classes(512, "cpu")
    card = serve.default_classes(512, "cuda")
    assert serve.as_job_classes(card) == serve.as_job_classes(cpu)
    for a, b in zip(cpu, card):
        assert (a.name, a.bucket, a.chips, a.mean_service_s, a.alpha) == (
            b.name, b.bucket, b.chips, b.mean_service_s, b.alpha)
        if a.name != "deepseek-32k":
            assert a.cfg == b.cfg
    cut = card[3].cfg
    assert cut == mla_cut(cpu[3].cfg, moe_layers=1)
    assert (cut.num_layers, cut.mtp) == (cpu[3].cfg.moe.first_dense + 1,
                                         False)
    assert dataclasses.replace(cut, name=cpu[3].cfg.name,
                               num_layers=cpu[3].cfg.num_layers,
                               mtp=True) == cpu[3].cfg
    assert abs(cut.num_params() / 1e9 - 15.11) < 0.01


def test_device_cuda_without_a_card_raises_before_printing(monkeypatch,
                                                           capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--epochs", "1", "--epoch-jobs", "10"])
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        serve.main(["--engine", "jax", "--device", "cpu"])


def _f32(classes):
    return [dataclasses.replace(c, cfg=dataclasses.replace(
        c.cfg, compute_dtype="float32")) for c in classes]


def test_execute_equals_the_reference_token_for_token(jit_ref_decode):
    """The reference's ``--execute`` loop (``repro/launch/serve.py``'s
    draws and lines) for six requests against ``serve.execute``, float32
    compute, the reference engine's weights in the port's ``_params``."""
    ref_classes = _f32(ref_serve.default_classes(512))
    ref = ref_engine.ServingEngine(ref_classes, 512, seed=0)
    port = engine.ServingEngine(_f32(serve.default_classes(512, "cpu")),
                                512, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    names = [c.name for c in ref_classes]
    probs = np.array([c.alpha for c in ref_classes])
    ref_out, ref_lines = [], []
    with pytest.raises(KeyError) as ref_err:
        for rid in range(len(EXECUTE_DRAWS)):
            i = rng.choice(len(ref_classes), p=probs)
            ref.submit(ref_engine.Request(
                rid=rid, cls_name=names[i],
                prompt=rng.integers(0, 100, size=16),
                arrival=float(rid)), float(rid))
            out = ref.run_request(max(ref._jobs))
            ref_out.append((out.cls_name, out.output))
            ref_lines.append(f"  executed request {out.rid}: "
                             f"{len(out.output)} tokens")
    for name in dict(ref_out):
        port._params[name] = params_from_jax(
            jax.tree.map(np.asarray, ref._get_params(name)), device="cpu")
    lines = []
    with pytest.raises(KeyError) as port_err:
        serve.execute(port, len(EXECUTE_DRAWS), 0, out=lines.append)
    assert type(port_err.value) is type(ref_err.value) is KeyError
    assert port_err.value.args == ref_err.value.args == ("image_emb",)
    assert "llamav-32k" not in port._params
    assert lines == ref_lines
    reqs = sorted(port._jobs.values(), key=lambda r: r.rid)
    assert [r.cls_name for r in reqs] == EXECUTE_DRAWS
    assert [(r.cls_name, r.output) for r in reqs[:-1]] == ref_out
    assert all(len(out) == 16 for _, out in ref_out)


# -- sched/elastic.py --------------------------------------------------------


def _job_classes(spec):
    """(reference, port) JobClass tuples of ``spec`` [(need, mean,
    alpha)]."""
    return tuple(tuple(mod.JobClass(f"c{i}", n, mod.Exp(m), a)
                       for i, (n, m, a) in enumerate(spec))
                 for mod in (ref_workload, workload))


def _twins(k, spec, ops, aux="fcfs"):
    """A reference and a port ``GangScheduler`` on eq. (2) at ``k`` after
    the same ``ops``: ("arrive", class, time) or ("complete", index into
    the sorted running jids, time)."""
    ref_jc, port_jc = _job_classes(spec)
    scheds = (ref_gang.GangScheduler(
        ref_cluster.BalancedMeshPartition.build(k, ref_jc), aux=aux),
        gang.GangScheduler(cluster.BalancedMeshPartition.build(k, port_jc),
                           aux=aux))
    for mod, s in zip((ref_gang, gang), scheds):
        jid = 0
        for kind, x, t in ops:
            if kind == "arrive":
                s.arrive(mod.GangJob(jid, x, spec[x][0], t, 1.0), t)
                jid += 1
            elif s.running:
                s.complete(sorted(s.running)[x % len(s.running)], t)
    return scheds


def _partition(mp):
    return (mp.k, mp.psi, [dataclasses.astuple(s) for s in mp.slices],
            dataclasses.astuple(mp.helper))


def _job(j):
    return (j.jid, j.cls, j.need, j.arrival, j.start, j.finish, j.placement)


def _state(s):
    return dict(partition=_partition(s.partition), aux=s.aux,
                free=[list(f) for f in s.free_slots],
                helper_free=s.helper_free, helper_used=dict(s.helper_used),
                helper_map=list(s._helper_map),
                wait=[_job(j) for j in s.helper_wait],
                running={i: _job(j) for i, j in s.running.items()},
                n_arrivals=s.n_arrivals, n_helper_served=s.n_helper_served,
                completed=[_job(j) for j in s.completed],
                p_helper=s.p_helper, snapshot=s.utilization_snapshot())


def _report(r):
    return (r.old_k, r.new_k, _partition(r.partition), r.killed_jobs,
            r.requeued_jobs)


def _rescaled_equal(ref, port, new_k):
    """``elastic_repartition`` of both to ``new_k``: the same report and
    state, or the same exception."""
    try:
        ref_new, ref_rep = ref_elastic.elastic_repartition(ref, new_k)
    except Exception as e:  # the reference's own failure, held below
        with pytest.raises(type(e)):
            elastic.elastic_repartition(port, new_k)
        return None
    new, rep = elastic.elastic_repartition(port, new_k)
    assert _report(rep) == _report(ref_rep)
    assert _state(new) == _state(ref_new)
    return rep


SPECS = [((2, 1.0, 0.7), (8, 4.0, 0.3)), ((1, 1.0, 0.5), (4, 2.0, 0.5)),
         ((2, 1.0, 0.55), (2, 1.5, 0.25), (16, 8.0, 0.12), (4, 20.0, 0.08))]


@settings(max_examples=25, deadline=None)
@given(k=st.integers(24, 160), spec=st.sampled_from(SPECS),
       seed=st.integers(0, 10 ** 6), new_k=st.integers(8, 240),
       aux=st.sampled_from(["fcfs", "backfill"]))
def test_elastic_repartition_equals_the_reference(k, spec, seed, new_k, aux):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(int(rng.integers(0, 80))):
        if rng.random() < 0.75:
            ops.append(("arrive", int(rng.integers(len(spec))), float(i)))
        else:
            ops.append(("complete", int(rng.integers(1 << 20)), float(i)))
    try:
        ref, port = _twins(k, spec, ops, aux)
    except Exception as e:  # eq. (2) has no partition at this k
        with pytest.raises(type(e)):
            gang.GangScheduler(cluster.BalancedMeshPartition.build(
                k, _job_classes(spec)[1]))
        return
    assert _state(port) == _state(ref)
    _rescaled_equal(ref, port, new_k)


def test_elastic_shrink_survives_requeues_and_kills():
    """A full fleet (every slot, the helper block and a queue) shrunk from
    64 to 40 chips: some class gangs keep their slot, some lose it and
    are requeued, some helper gangs are killed; grown to 96 all survive."""
    spec = SPECS[0]
    ops = [("arrive", c, 0.0) for c in [0] * 20 + [1] * 6]
    ref, port = _twins(64, spec, ops)
    assert ref.helper_wait and ref.helper_free < spec[0][0]
    rep = _rescaled_equal(ref, port, 40)
    assert rep.killed_jobs and rep.requeued_jobs
    assert len(rep.killed_jobs) + len(rep.requeued_jobs) < len(port.running)
    ref, port = _twins(64, spec, ops)
    rep = _rescaled_equal(ref, port, 96)
    assert not rep.killed_jobs and not rep.requeued_jobs


# -- sched/gang.py: simulate_gangs -------------------------------------------


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 1000), load=st.floats(0.4, 0.95),
       aux=st.sampled_from(["fcfs", "backfill"]))
def test_simulate_gangs_equals_the_reference(seed, load, aux):
    ref_jc, port_jc = _job_classes(((2, 1.0, 0.7), (8, 4.0, 0.3)))
    wl = ref_workload.Workload(k=64, lam=1.0, classes=ref_jc).with_load(load)
    tr = wl.sample_trace(600, seed=seed)
    jobs = [(i, int(tr.cls[i]), int(tr.need[i]), float(tr.arrival[i]),
             float(tr.service[i])) for i in range(tr.num_jobs)]
    ref = ref_gang.simulate_gangs(
        ref_cluster.BalancedMeshPartition.build(64, ref_jc),
        [ref_gang.GangJob(*j) for j in jobs], aux=aux)
    port = gang.simulate_gangs(
        cluster.BalancedMeshPartition.build(64, port_jc),
        [gang.GangJob(*j) for j in jobs], aux=aux)
    assert len(port.completed) == tr.num_jobs
    assert [_job(j) for j in port.completed] == \
        [_job(j) for j in ref.completed]
    assert _state(port) == _state(ref)


# -- runtime/ ----------------------------------------------------------------


def _saturated(mod_gang, mod_cluster, jc):
    """test_sched's saturated two-class fleet (32 chips, need 4): every
    slot and the helper block busy with long gangs."""
    mp = mod_cluster.BalancedMeshPartition.build(32, jc)
    s = mod_gang.GangScheduler(mp)
    jid = 0
    for c, sl in enumerate(mp.slices):
        for _ in range(sl.slots):
            s.arrive(mod_gang.GangJob(jid, c, sl.need, 0.0, 1e3), 0.0)
            jid += 1
    for _ in range(mp.helper.size // 4):
        s.arrive(mod_gang.GangJob(jid, 0, 4, 0.0, 1e3), 0.0)
        jid += 1
    return s, jid


def test_straggler_mitigator_equals_the_reference():
    """Queued gangs of both classes at spread arrivals, ticks before and
    past their deadlines, and a helper gang completing between ticks (so
    a promotion starts a gang): each tick's count, the queue order, the
    running gangs and ``redirected`` equal."""
    sides = []
    jcs = _job_classes(((4, 1.0, 0.5), (4, 10.0, 0.5)))
    for mod_gang, mod_cluster, mitigator, jc in (
            (ref_gang, ref_cluster, ref_straggler.StragglerMitigator,
             jcs[0]),
            (gang, cluster, StragglerMitigator, jcs[1])):
        s, jid = _saturated(mod_gang, mod_cluster, jc)
        for i, (c, t) in enumerate([(1, 0.0), (0, 1.0), (0, 2.0), (1, 3.0),
                                    (0, 8.5), (1, 9.0)]):
            s.arrive(mod_gang.GangJob(jid + i, c, 4, t, 1.0), t)
        mit = mitigator(s, deadline_multiple=2.0)
        trail = []
        for now in (1.5, 4.0, 10.0, 10.0, 25.0):
            if now == 25.0:
                helper = sorted(j for j, g in s.running.items()
                                if g.placement[0] == "helper")
                s.complete(helper[0], 24.0)
            trail.append((mit.tick(now), mit.redirected,
                          [_job(j) for j in s.helper_wait],
                          sorted(s.running)))
        sides.append((trail, _state(s)))
    assert sides[1] == sides[0]
    assert sides[1][0][-1][1] > 0


def test_fleet_monitor_equals_the_reference():
    """Heartbeats, dead chips, two failures and the serving rescale of a
    scheduler with running and queued gangs, on both sides."""
    out = []
    jcs = _job_classes(SPECS[0])
    for monitor, nf, mod_gang, mod_cluster, jc in (
            (ref_ft.FleetMonitor, ref_ft.NodeFailure, ref_gang, ref_cluster,
             jcs[0]),
            (FleetMonitor, NodeFailure, gang, cluster, jcs[1])):
        mon = monitor(64, heartbeat_timeout_s=5.0)
        for chip in range(8):
            mon.heartbeat(chip, now=float(chip))
        dead = mon.dead_chips(10.0)
        mon.fail(nf(time=10.0, chips_lost=12))
        mon.fail(nf(time=11.0, chips_lost=8, reason="host"))
        s = mod_gang.GangScheduler(mod_cluster.BalancedMeshPartition.build(
            64, jc))
        for i in range(26):
            c = 0 if i < 20 else 1
            s.arrive(mod_gang.GangJob(i, c, (2, 8)[c], 0.0, 1.0), 0.0)
        new, rep = mon.rescale_scheduler(s)
        out.append((dead, mon.live_chips, mon.total_chips,
                    [dataclasses.astuple(f) for f in mon.failures],
                    _report(rep), _state(new)))
    assert out[1] == out[0]
    assert out[1][1] == 44 and out[1][4][3]
