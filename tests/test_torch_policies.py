"""The port's policies and event engine against the reference's, rtol=0.

``repro_torch.core.policies`` and ``repro_torch.core.simulator`` are the
port's own copies of the reference's; one ``Simulation`` of each side on
the same trace must give the same schedule bit for bit: completion and
start times, every ``SimResult`` field, and the BS-π routing record and
estimates.  The unit cases are the reference's ``tests/test_policies.py``
ones (which JAX 0.9 cannot collect, ROADMAP R1): the bounded knapsack, the
size-oblivious guard, the SRPT tie cases and the BS-π rule-3 pull-back,
each also held to the reference and, where a scan core exists, to the
port's ``"torch"`` core on the CPU.
"""

import dataclasses

import numpy as np
import pytest

from _torch_jaxref import ref_workload  # noqa: F401  (the R1 alias first)
from repro.core import partition as ref_partition
from repro.core import policies as ref_policies
from repro.core import simulator as ref_simulator
from repro.core.policies import max_weight as ref_max_weight

from repro_torch.core import engines, partition, policies, simulator, workload
from repro_torch.core.policies import max_weight
from repro_torch.data.swf import sdsc_sp2_trace

#: make_policy's short names of the eleven registered python policies
NAMES = ("fcfs", "modbs", "bs", "serverfilling", "sf-srpt", "sf-gittins",
         "ff-srpt", "msf", "lsf", "backfill", "maxweight")


def _traces(which):
    """(port Trace, reference Trace, port wl, reference wl) on one seed."""
    if which == "fig1":
        wl = workload.figure1_workload(32)
        rwl = ref_workload.figure1_workload(32)
        tr = wl.sample_trace(300, seed=11)
    else:
        wl = workload.sdsc_sp2_workload(k=128, load=0.85)
        rwl = ref_workload.sdsc_sp2_workload(k=128, load=0.85)
        tr = workload.BatchTrace.from_trace(
            sdsc_sp2_trace(500, k=128, load=0.85, seed=3), 1, seed=3).rep(0)
    rtr = ref_workload.Trace(arrival=tr.arrival, cls=tr.cls,
                             service=tr.service, need=tr.need, k=tr.k,
                             C=tr.C)
    return tr, rtr, wl, rwl


def _assert_sims_equal(sim, ref_sim, res, ref_res, what):
    for f in ("completion", "start_time", "remaining", "epoch"):
        assert np.array_equal(getattr(sim, f), getattr(ref_sim, f)), \
            (what, f)
    for f in dataclasses.fields(ref_res):
        a, b = getattr(res, f.name), getattr(ref_res, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b, equal_nan=True), (what, f.name)
        else:
            assert a == b and type(a) is type(b), (what, f.name, a, b)
    pol, ref_pol = sim.policy, ref_sim.policy
    for f in ("routed_jobs", "p_helper_estimate", "p_routed_estimate"):
        assert getattr(pol, f, None) == getattr(ref_pol, f, None), (what, f)


@pytest.mark.parametrize("which", ["fig1", "fig3"])
@pytest.mark.parametrize("name", NAMES)
def test_policy_matches_reference_simulation(name, which):
    tr, rtr, wl, rwl = _traces(which)
    sim = simulator.Simulation(tr, policies.make_policy(name, wl=wl))
    ref_sim = ref_simulator.Simulation(
        rtr, ref_policies.make_policy(name, wl=rwl))
    _assert_sims_equal(sim, ref_sim, sim.run(), ref_sim.run(), (name, which))


def test_make_policy_names_and_unknown():
    wl = workload.figure1_workload(32)
    got = {policies.make_policy(n, wl=wl).name for n in NAMES}
    assert got == set(simulator._PYTHON_POLICIES)
    assert got == {p for p, e in engines.registered() if e == "python"}
    with pytest.raises(KeyError, match="unknown policy"):
        policies.make_policy("srpt")


@pytest.mark.parametrize("seed", range(4))
def test_bounded_knapsack_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    items = [(int(rng.integers(1, 9)), float(rng.integers(1, 20)),
              int(rng.integers(1, 12))) for _ in range(n)]
    cap = int(rng.integers(0, 40))
    out = max_weight.bounded_knapsack(cap, items)
    assert dict(out) == dict(ref_max_weight.bounded_knapsack(cap, items))
    assert sum(items[i][0] * c for i, c in out.items()) <= cap
    assert all(c <= items[i][2] for i, c in out.items())


@pytest.mark.parametrize("name", ["bs", "modbs", "fcfs", "backfill",
                                  "serverfilling", "msf", "lsf", "maxweight",
                                  "sf-gittins"])
def test_size_oblivious_policies_never_query_remaining(name, monkeypatch):
    """A policy with ``size_aware=False`` never reads a remaining time."""
    wl = workload.Workload(k=32, lam=1.0, classes=(
        workload.JobClass("s", 1, workload.Exp(1.0), 0.7),
        workload.JobClass("m", 4, workload.Exp(4.0), 0.2),
        workload.JobClass("l", 8, workload.Exp(8.0), 0.1))).with_load(0.7)
    pol = policies.make_policy(name, wl=wl)
    assert not pol.size_aware
    calls = []
    orig = simulator._View.remaining
    monkeypatch.setattr(simulator._View, "remaining",
                        lambda v, j: calls.append(j) or orig(v, j))
    res = simulator.simulate_trace(wl.sample_trace(500, seed=9), pol)
    assert res.num_jobs == 500 and not calls


# -- the reference's SRPT tie cases and BS-π pull-back (test_policies.py) ----


#: (policy, arrival, need, service, k, start, completion, preemptions)
SRPT_TIES = {
    "ff-equal-remaining": ("ff-srpt", [0.0, 1.0], [1, 1], [2.0, 1.0], 1,
                           [0.0, 2.0], [2.0, 3.0], 0),
    "ff-smaller-remaining": ("ff-srpt", [0.0, 1.0], [1, 1], [2.0, 0.5], 1,
                             [0.0, 1.0], [2.5, 1.5], 1),
    "ff-arrival-before-departure": ("ff-srpt", [0.0, 0.0, 1.0], [1, 1, 2],
                                    [1.0, 3.0, 1.0], 2, [0.0, 0.0, 1.0],
                                    [1.0, 4.0, 2.0], 1),
    "sf-zero-remaining-preempted": ("sf-srpt", [0.0, 1.0], [2, 4],
                                    [1.0, 2.0], 4, [0.0, 1.0], [3.0, 3.0],
                                    1),
    "sf-rank-tie-by-arrival": ("sf-srpt", [0.0, 0.0], [2, 2], [1.0, 1.0], 2,
                               [0.0, 1.0], [1.0, 2.0], 0),
}


@pytest.mark.parametrize("case", sorted(SRPT_TIES))
def test_srpt_tie_cases_match_reference_and_torch(case):
    pol, arr, need, svc, k, start, comp, npre = SRPT_TIES[case]
    arrays = dict(arrival=np.array(arr), cls=np.zeros(len(arr), np.int64),
                  service=np.array(svc), need=np.array(need, np.int64), k=k)
    sim = simulator.Simulation(workload.Trace(**arrays),
                               policies.make_policy(pol))
    ref_sim = ref_simulator.Simulation(ref_workload.Trace(**arrays),
                                       ref_policies.make_policy(pol))
    _assert_sims_equal(sim, ref_sim, sim.run(), ref_sim.run(), case)
    assert sim.start_time.tolist() == start
    assert sim.completion.tolist() == comp
    assert sim.preemptions == npre
    batch = workload.BatchTrace.from_arrays(
        arrays["arrival"][None], arrays["cls"][None],
        arrays["service"][None], arrays["need"][None], k=k, C=1)
    py = engines.simulate(pol, batch, engine="python")
    on_cpu = engines.simulate(pol, batch, device="cpu")
    for f in ("response", "wait", "start", "preemptions"):
        assert np.array_equal(getattr(py, f), getattr(on_cpu, f)), (case, f)


def test_bs_rule3_pullback_reschedules_helpers():
    """Three jobs: J0's completion pulls J1 back into A_0 (rule 3), which
    unblocks J2 on the single helper server at t = 10."""
    kw = dict(k=4, needs=(3, 1), a=(3, 0), psi=1.0)
    arrays = dict(arrival=np.array([0.0, 1.0, 2.0]), cls=np.array([0, 0, 1]),
                  service=np.array([10.0, 1.0, 1.0]),
                  need=np.array([3, 3, 1]), k=4)
    pol = policies.BalancedSplitting(partition.BalancedPartition(**kw))
    ref_pol = ref_policies.BalancedSplitting(
        ref_partition.BalancedPartition(**kw))
    sim = simulator.Simulation(workload.Trace(**arrays), pol)
    ref_sim = ref_simulator.Simulation(ref_workload.Trace(**arrays), ref_pol)
    _assert_sims_equal(sim, ref_sim, sim.run(), ref_sim.run(), "pull-back")
    assert sim.start_time.tolist() == [0.0, 10.0, 10.0]
    assert sim.completion.tolist() == [10.0, 11.0, 11.0]
    assert pol.p_routed_estimate == pytest.approx(2 / 3)
    assert pol.p_helper_estimate == pytest.approx(1 / 3)
