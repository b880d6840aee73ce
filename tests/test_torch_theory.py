"""The port's closed forms (``repro_torch.core.theory``) against the
reference's (``repro.core.theory``), and the paper's theorem checks of
``tests/test_theory.py`` on the port.

Every ``TheoryReport`` field must equal the reference's (``==``) on the
Fig. 1 cells, the Fig. 2 heavy-traffic cells, the subcritical f_k = 1
family and the Table-2/3 workloads, and the Thm 1/2 prelimits and limit at
the reference tables' k.  ``tests/test_theory.py`` cannot run on the
reference here (its ``sim_jax`` import needs the installed JAX's removed
``jax.experimental.enable_x64``), so the port carries its checks.
"""

import dataclasses
import math

import numpy as np
import pytest

from _torch_jaxref import ref_workload  # the reference's x64 alias
from repro.core import theory as ref

from repro_torch.core import policies, simulator, theory, workload

ONE = lambda k: 1  # noqa: E731


def _lam():
    return 0.85 / sum(c.alpha * c.d * c.n
                      for c in workload.figure1_base_classes())


WORKLOADS = (
    [(f"fig1 k={k}", "figure1_workload", (k,)) for k in (256, 1024, 2048)]
    + [(f"fig2 k=512 load={x}", "figure2_workload", (512, x))
       for x in (0.5, 0.7, 0.8, 0.9, 0.95)]
    + [("sdsc_sp2", "sdsc_sp2_workload", ()),
       ("sdsc_sp2 k=1024 load=0.85", "sdsc_sp2_workload", (1024, 0.85)),
       ("kit_fh2", "kit_fh2_workload", ()),
       ("kit_fh2 k=1024 load=0.85", "kit_fh2_workload", (1024, 0.85))])


def _same_report(a, b):
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


@pytest.mark.parametrize("name,factory,args", WORKLOADS,
                         ids=[w[0] for w in WORKLOADS])
def test_analyze_equals_reference(name, factory, args):
    wl = getattr(workload, factory)(*args)
    rwl = getattr(ref_workload, factory)(*args)
    _same_report(theory.analyze(wl), ref.analyze(rwl))
    assert theory.stability_sufficient(wl) == ref.stability_sufficient(rwl)
    assert theory.p_helper_upper_bound(wl) == ref.p_helper_upper_bound(rwl)


@pytest.mark.parametrize("k", [64, 256, 1024, 4096])
def test_subcritical_family_equals_reference(k):
    wl = workload.subcritical_scaling(workload.figure1_base_classes(),
                                      _lam(), k, fk=ONE)
    rwl = ref_workload.subcritical_scaling(
        ref_workload.figure1_base_classes(), _lam(), k, fk=ONE)
    _same_report(theory.analyze(wl), ref.analyze(rwl))
    assert theory.theorem1_prelimit(workload.figure1_base_classes(), _lam(),
                                    k, fk=ONE) == ref.theorem1_prelimit(
        ref_workload.figure1_base_classes(), _lam(), k, fk=ONE)


@pytest.mark.parametrize("k", [512, 4096, 32768, 262144])
def test_theorem2_equals_reference(k):
    base, rbase = (workload.figure1_base_classes(),
                   ref_workload.figure1_base_classes())
    assert theory.theorem2_limit(base, 0.7) == ref.theorem2_limit(rbase, 0.7)
    assert theory.theorem2_prelimit(base, 0.7, k) == \
        ref.theorem2_prelimit(rbase, 0.7, k)
    assert theory.theorem1_prelimit(base, _lam(), k) == \
        ref.theorem1_prelimit(rbase, _lam(), k)


def test_explicit_partition_equals_reference():
    """``analyze(wl, part)`` with a partition passed in."""
    from repro.core.partition import balanced_partition as ref_part

    from repro_torch.core.partition import balanced_partition
    wl, rwl = workload.figure1_workload(512), ref_workload.figure1_workload(
        512)
    _same_report(theory.analyze(wl, balanced_partition(wl)),
                 ref.analyze(rwl, ref_part(rwl)))


def test_theorem1_subcritical_ph_vanishes():
    """Thm 1: P_H -> 0 under scaling (7) with f_k = 1 (monotone, below
    5e-4 at k = 4096), and on the sample path accepted jobs wait 0, so
    their mean response is the zero-wait limit Σ α_i d_i."""
    base = workload.figure1_base_classes()
    vals = [theory.theorem1_prelimit(base, _lam(), k, fk=ONE)
            for k in (64, 256, 1024, 4096)]
    assert all(v2 <= v1 + 1e-12 for v1, v2 in zip(vals, vals[1:]))
    assert vals[-1] < 5e-4
    from repro_torch.core.sim_torch import modified_bs_sim
    wl = workload.subcritical_scaling(base, _lam(), 4096, fk=ONE)
    trace = wl.sample_trace(100_000, seed=1)
    sim = modified_bs_sim(trace, wl=wl, device="cpu")
    accepted = ~sim.blocked
    assert accepted.mean() > 0.999
    # wait == 0: response = (start + service) - arrival, start = arrival
    np.testing.assert_allclose(sim.response[accepted],
                               trace.service[accepted], rtol=0, atol=1e-9)
    assert trace.service[accepted].mean() == pytest.approx(
        wl.zero_wait_response_time(), rel=0.02)


def test_theorem2_critical_rate():
    """Thm 2: √(k/f_k)·P_H^mod stays within 8 % of eq. (9) at large k."""
    base = workload.figure1_base_classes()
    limit = theory.theorem2_limit(base, 0.7)
    for k in (4096, 32768, 262144):
        pre = theory.theorem2_prelimit(base, 0.7, k)
        assert pre == pytest.approx(limit, rel=0.08), f"k={k}: {pre}"


def test_proposition1_stability_condition():
    """Eq. (5) holds at large k in the subcritical regime, and the helper
    load falls with k."""
    loads = [theory.analyze(workload.subcritical_scaling(
        workload.figure1_base_classes(), _lam(), k, fk=ONE)).helper_load
        for k in (256, 1024, 4096)]
    assert loads[-1] < 1.0
    assert loads[-1] == min(loads)


def test_proposition2_bs_below_modified():
    """Prop. 2 / Cor. 1 on the port's event engine: P_H(BS-π) <=
    P_H(ModifiedBS-π) + 0.01."""
    wl = workload.figure1_workload(512)
    trace = wl.sample_trace(20_000, seed=7)
    bs = simulator.simulate_trace(
        trace, policies.BalancedSplitting.for_workload(wl))
    mod = simulator.simulate_trace(
        trace, policies.ModifiedBalancedSplitting.for_workload(wl))
    assert bs.p_helper <= mod.p_helper + 0.01
    assert math.isfinite(bs.mean_response)
