"""The paper's analytical results — Prop. 1, eq. (16), Thm. 1, Thm. 2.

The port's copy of ``repro.core.theory``, on the port's own partition and
workloads; every quantity equals the reference's.  Everything here
reduces to Erlang-B applied to the per-class loss queues of Property 1:
class i behaves (under ModifiedBS-π) like an M/GI/s_i/s_i queue with
s_i = a_i/n_i slots, arrival rate λα_i and mean service d_i.  The sample
path of those loss queues is :func:`repro_torch.core.sim_batch.
loss_queue_sim_batch`; :func:`repro_torch.core.sim_torch.estimate_p_helper`
measures the P_H that eq. (16) bounds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .erlang import erlang_b, halfin_whitt_limit
from .partition import BalancedPartition, balanced_partition
from .workload import (Workload, critical_scaling, default_fk,
                       subcritical_scaling)


@dataclasses.dataclass(frozen=True)
class TheoryReport:
    """All closed-form quantities for a (workload, partition) pair."""

    per_class_offered: tuple[float, ...]   # λ α_i d_i
    per_class_slots: tuple[int, ...]       # s_i
    per_class_blocking: tuple[float, ...]  # E_{s_i}(λ α_i d_i)
    p_helper_modified: float               # eq. (16):  Σ α_i E_{s_i}
    helper_load: float                     # LHS of eq. (5)
    stable_sufficient: bool                # eq. (5) < 1
    zero_wait_R: float                     # Σ α_i d_i (Thm-1 limit)
    r_upper_bound: float                   # R bound assuming helpers add W_H

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        lines = ["TheoryReport:"]
        for i, (a, s, e) in enumerate(zip(self.per_class_offered,
                                          self.per_class_slots,
                                          self.per_class_blocking)):
            lines.append(f"  class {i}: offered={a:.3f} slots={s} E_s={e:.3e}")
        lines.append(f"  P_H^mod = {self.p_helper_modified:.3e}")
        lines.append(f"  helper load (eq.5 LHS) = {self.helper_load:.3f} "
                     f"-> {'stable' if self.stable_sufficient else 'unknown'}")
        return "\n".join(lines)


def analyze(wl: Workload, part: BalancedPartition | None = None) -> TheoryReport:
    """Apply Property 1 + Prop. 2 to get the paper's bounds for a workload."""
    part = part or balanced_partition(wl)
    offered, blocking = [], []
    slots = part.slots
    for c, s in zip(wl.classes, slots):
        a = wl.lam * c.alpha * c.d
        offered.append(a)
        blocking.append(erlang_b(s, a) if s > 0 else 1.0)
    p_h = float(sum(c.alpha * e for c, e in zip(wl.classes, blocking)))
    # eq. (5):  (λ/|H|) Σ ϱ_i E_{s_i}(λ α_i d_i) < 1
    helpers = part.helpers
    if helpers > 0:
        helper_load = wl.lam / helpers * float(
            sum(c.demand * e for c, e in zip(wl.classes, blocking)))
    else:
        helper_load = 0.0 if p_h == 0 else math.inf
    zero_wait = wl.zero_wait_response_time()
    # An indicator only (exact R needs simulation): helper jobs wait at
    # least 0, and at most a policy-dependent M/GI/1-like amount.
    r_ub = zero_wait + p_h * max(c.d for c in wl.classes)
    return TheoryReport(
        per_class_offered=tuple(offered),
        per_class_slots=tuple(slots),
        per_class_blocking=tuple(blocking),
        p_helper_modified=p_h,
        helper_load=helper_load,
        stable_sufficient=bool(helper_load < 1.0),
        zero_wait_R=zero_wait,
        r_upper_bound=r_ub,
    )


def stability_sufficient(wl: Workload) -> bool:
    """Prop. 1 sufficient condition (assuming π throughput-optimal on H)."""
    return analyze(wl).stable_sufficient


def p_helper_upper_bound(wl: Workload) -> float:
    """Cor. 1 / eq. (16):  P_H ≤ Σ α_i E_{s_i}(λ α_i d_i)."""
    return analyze(wl).p_helper_modified


# --------------------------------------------------------------------------
# Theorem 2 — critical (Halfin-Whitt) many-server limit.
# --------------------------------------------------------------------------


def theorem2_limit(base_classes, theta: float) -> float:
    """RHS of eq. (9):  θ Σ_i (α_i/θ_i) φ(θ_i)/Φ(θ_i),  θ_i = θ √(ϱ_i/(n_i ϱ)).

    ``base_classes`` are the *unscaled* classes (f_k = 1); the θ_i are scale
    invariant because ϱ_i/(n_i ϱ) only involves base quantities.
    """
    demands = np.array([c.demand for c in base_classes])
    needs = np.array([c.n for c in base_classes], dtype=float)
    alphas = np.array([c.alpha for c in base_classes])
    total = demands.sum()
    out = 0.0
    for a_i, n_i, q_i in zip(alphas, needs, demands):
        th_i = theta * math.sqrt(q_i / (n_i * total))
        out += a_i / th_i * halfin_whitt_limit(th_i)
    return theta * float(out)


def theorem2_prelimit(base_classes, theta: float, k: int, fk=None) -> float:
    """√(k/f_k) · P_H^mod at finite k under scaling (8) — converges to eq. (9)."""
    fk = fk or default_fk
    wl = critical_scaling(base_classes, theta, k, fk)
    f = fk(k)
    return math.sqrt(k / f) * p_helper_upper_bound(wl)


def theorem1_prelimit(base_classes, lam: float, k: int, fk=None) -> float:
    """P_H^mod at finite k under the subcritical scaling (7) — converges to 0."""
    fk = fk or default_fk
    wl = subcritical_scaling(base_classes, lam, k, fk)
    return p_helper_upper_bound(wl)
