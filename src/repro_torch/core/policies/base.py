"""Policy protocol for the event-driven multiserver-job simulator.

A policy sees a ``SystemView`` (read-only facade over the simulator state)
and returns, at every event, the set of job ids that *should be running now*.
The engine reconciles: newly selected jobs start, deselected jobs are
preempted (only legal for ``preemptive=True`` policies, preempt-resume
semantics).  Stateful policies (the BSF family) additionally get
``on_arrival`` / ``on_departure`` hooks, fired before ``select``.
"""

from __future__ import annotations

from typing import Iterable, Protocol, Sequence

import numpy as np


class SystemView(Protocol):
    """What a policy may observe.  Size-oblivious policies MUST NOT call
    ``remaining`` — this is enforced in tests via a guard wrapper."""

    now: float
    k: int

    def queue(self) -> Sequence[int]: ...          # waiting ids, arrival order
    def running(self) -> frozenset[int]: ...
    def free(self) -> int: ...
    def need(self, j: int) -> int: ...
    def cls(self, j: int) -> int: ...
    def arrival(self, j: int) -> float: ...
    def remaining(self, j: int) -> float: ...      # size-aware policies only
    def num_classes(self) -> int: ...


class Policy:
    """Base class.  Subclasses set the class attributes and implement select."""

    name: str = "abstract"
    preemptive: bool = False
    size_aware: bool = False

    def reset(self, view: SystemView) -> None:  # called once before t=0
        pass

    def on_arrival(self, view: SystemView, j: int) -> None:
        pass

    def on_departure(self, view: SystemView, j: int) -> None:
        pass

    # -- failure hooks (kill-mode fault injection, see core.simulator) -----

    def on_capacity_change(self, view: SystemView,
                           k_live: int) -> Sequence[int] | None:
        """Fired on every breakdown/repair event, before the engine picks
        kill victims.  Return job ids to kill (a breakdown may force
        ``select`` to shrink), or None for the engine default (most
        recently started first).  ``view.k`` already reports ``k_live``."""
        return None

    def on_kill(self, view: SystemView, j: int) -> None:
        """Job ``j`` was killed mid-service and requeued (full restart)."""
        pass

    def select(self, view: SystemView) -> Iterable[int]:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} {self.name}>"


def greedy_pack(view: SystemView, order: Sequence[int], base: Iterable[int],
                budget: int | None = None) -> list[int]:
    """First-fit packing: keep ``base`` running, then walk ``order`` adding
    every job that still fits.  Returns the union as a list."""
    out = list(base)
    free = (view.k if budget is None else budget) - sum(
        view.need(j) for j in out)
    for j in order:
        if j in out:
            continue
        n = view.need(j)
        if n <= free:
            out.append(j)
            free -= n
        if free == 0:
            break
    return out


def np_order_by(keys: np.ndarray, ids: Sequence[int]) -> list[int]:
    """Sort ids by key ascending (stable)."""
    idx = np.argsort(keys, kind="stable")
    return [ids[i] for i in idx]
