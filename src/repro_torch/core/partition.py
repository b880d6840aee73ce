"""Static balanced sub-partition of the server set — paper §3.2, eq. (2).

The port's own copy of the reference ``repro.core.partition`` (same exact
breakpoint scan, so both sides derive the same slots and helpers), plus
:meth:`BalancedPartition.from_arrays` to carry a partition across.

Given a workload with classes i = 1..C, the partition assigns to class i a
dedicated block of

    a_i = |A_i| = floor( ψ · (k/n_i) · (ϱ_i/ϱ) ) · n_i          (2a)

servers, always a *multiple of n_i* (so class-i jobs pack A_i perfectly — the
property that makes each A_i an M/GI/s_i/s_i loss queue under ModifiedBS-π,
Property 1).  The leftover servers are the helpers,

    |H| = k − Σ_i a_i.                                           (2b)

ψ ∈ [0, 1] shrinks the A system just enough that the helper set can host any
single job:

    ψ = max { x ∈ [0,1] : k − Σ_i floor(x·(k/n_i)(ϱ_i/ϱ))·n_i ≥ max_i n_i }.

The helper constraint |H| ≥ max_i n_i applies *unconditionally* — including
when every (k/n_i)(ϱ_i/ϱ) is integral.  In that case x = 1 packs the A
blocks perfectly (|H| = 0), so ψ must still back off below 1: BS-π/ModBS-π
are undefined without a helper set that can host the largest job (an
earlier revision returned ψ = 1 there and the simulators raised on
perfectly legitimate workloads).  x = 0 always satisfies the constraint
(|H| = k ≥ max_i n_i), so the max exists.

Because each floor term is a right-continuous step function of x, the max is
attained and can be found exactly by scanning the finitely many breakpoints
x = m·(n_i ϱ)/(k ϱ_i); we do this exactly (no numerical search).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from .workload import Workload


def _helpers_at(x: float, k: int, needs: np.ndarray, fracs: np.ndarray) -> int:
    """k − Σ floor(x · fracs_i) · n_i   with fracs_i = (k/n_i)(ϱ_i/ϱ)."""
    # guard tiny negative fp noise in x*fracs
    counts = np.floor(x * fracs + 1e-12).astype(np.int64)
    return int(k - (counts * needs).sum())


def compute_psi(k: int, needs: Sequence[int], demands: Sequence[float]) -> float:
    """The ψ of eq. (2) — exact breakpoint scan."""
    needs = np.asarray(needs, dtype=np.int64)
    demands = np.asarray(demands, dtype=np.float64)
    total = demands.sum()
    fracs = (k / needs) * (demands / total)          # (k/n_i)(ϱ_i/ϱ)

    # The helper constraint binds even when every frac is integral (x = 1
    # then gives |H| = 0 < max n_i and the breakpoint scan below must back
    # off) — no integral-fracs shortcut here.
    n_max = int(needs.max())
    if _helpers_at(1.0, k, needs, fracs) >= n_max:
        return 1.0

    # Candidate breakpoints: x where some floor(x*fracs_i) jumps, i.e.
    # x = m / fracs_i for integer m with x in [0,1].  The objective
    # (helpers >= n_max) is satisfied on a union of left-closed intervals;
    # we need the supremum x satisfying it.  Helpers(x) is piecewise constant
    # and right-continuous DEcreasing in x except at breakpoints; the max x
    # satisfying the constraint is just below the first violating breakpoint.
    bps: list[float] = [0.0, 1.0]
    for f in fracs:
        if f <= 0:
            continue
        m_max = int(math.floor(f + 1e-12))
        bps.extend(m / f for m in range(1, m_max + 1))
    bps = sorted({b for b in bps if 0.0 <= b <= 1.0})

    # helpers(x) is constant on [bp_j, bp_{j+1}); evaluate at each breakpoint
    # and return the largest breakpoint (the sup of its interval is open, but
    # the floor value — hence a_i and |H| — is identical anywhere inside, so
    # taking the breakpoint itself is exact).
    best = 0.0
    for b in bps:
        if _helpers_at(b, k, needs, fracs) >= n_max:
            best = max(best, b)
    return float(best)


@dataclasses.dataclass(frozen=True)
class BalancedPartition:
    """The static partition {A_1..A_C, H} of servers {0..k-1}.

    ``slots[i]`` = s_i = a_i / n_i, the number of whole-job slots of class i
    (the server count of the associated M/GI/s_i/s_i queue, Property 1).
    Blocks are laid out contiguously: A_1 = [0, a_1), A_2 = [a_1, a_1+a_2)...
    and H is the tail — contiguity matters when A_i maps to a device slice.
    """

    k: int
    needs: tuple[int, ...]
    a: tuple[int, ...]            # a_i, multiples of n_i
    psi: float

    @property
    def C(self) -> int:
        return len(self.a)

    @property
    def slots(self) -> tuple[int, ...]:
        return tuple(ai // ni for ai, ni in zip(self.a, self.needs))

    @property
    def helpers(self) -> int:
        return self.k - sum(self.a)

    @property
    def offsets(self) -> tuple[int, ...]:
        out, acc = [], 0
        for ai in self.a:
            out.append(acc)
            acc += ai
        return tuple(out)

    @property
    def helper_offset(self) -> int:
        return sum(self.a)

    def block(self, i: int) -> range:
        return range(self.offsets[i], self.offsets[i] + self.a[i])

    def helper_block(self) -> range:
        return range(self.helper_offset, self.k)

    def validate(self) -> None:
        if not all(ai % ni == 0 for ai, ni in zip(self.a, self.needs)):
            raise ValueError(f"blocks {self.a} are not multiples of the "
                             f"needs {self.needs}")
        if self.helpers < 0:
            raise ValueError(f"blocks {self.a} exceed k={self.k}")

    @classmethod
    def from_arrays(cls, k: int, needs, a, psi: float) -> "BalancedPartition":
        """A partition from plain values — e.g. the fields of the JAX
        reference's ``BalancedPartition`` — validated like one computed
        here."""
        p = cls(k=int(k), needs=tuple(int(n) for n in needs),
                a=tuple(int(x) for x in a), psi=float(psi))
        if len(p.needs) != len(p.a):
            raise ValueError(f"{len(p.needs)} needs but {len(p.a)} blocks")
        p.validate()
        return p


def balanced_partition_for(k: int, needs: Sequence[int],
                           demands: Sequence[float]) -> BalancedPartition:
    """Eq. (2) as a pure function of ``(k, needs, demands)``.

    Demand is what the workload offers, capacity is what survives — the
    elastic/kill-mode paths re-run this on every capacity change with the
    *live* server count while the class demands stay fixed (the same split
    ``sched/elastic.py`` performs on the gang-scheduler side).
    """
    needs_arr = np.asarray(needs, dtype=np.int64)
    demands_arr = np.asarray(demands, dtype=np.float64)
    if k < int(needs_arr.max()):
        raise ValueError(
            f"k={k} cannot host the largest job (need {int(needs_arr.max())})")
    psi = compute_psi(k, needs_arr, demands_arr)
    total = demands_arr.sum()
    fracs = (k / needs_arr) * (demands_arr / total)
    counts = np.floor(psi * fracs + 1e-12).astype(np.int64)
    a = tuple(int(c * n) for c, n in zip(counts, needs_arr))
    p = BalancedPartition(k=k, needs=tuple(int(n) for n in needs_arr),
                          a=a, psi=psi)
    p.validate()
    return p


def balanced_partition(wl: Workload) -> BalancedPartition:
    """Eq. (2) applied to a workload."""
    return balanced_partition_for(wl.k, wl.needs, wl.demands)
