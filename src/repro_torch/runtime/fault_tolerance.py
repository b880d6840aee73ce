"""Fleet-level fault tolerance: heartbeats, failure detection, rescale.

The port's copy of ``repro/runtime/fault_tolerance.py``.  On real fleets
the heartbeat source is the cluster manager; here the FleetMonitor
consumes simulated NodeFailure events (tests inject them) and drives the
two recovery paths:

* training — ``run_with_restarts`` builds a fresh Trainer after each
  injected failure, which restores the latest checkpoint and resumes the
  deterministic data stream (bit-exact continuation is tested);
* serving  — ``sched.elastic_repartition`` recomputes eq. (2) on the
  surviving chip count; only gangs on dead chips are lost (the paper's
  non-preemption trade), everything else keeps running.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from ..sched.elastic import elastic_repartition
from ..sched.gang import GangScheduler


@dataclasses.dataclass(frozen=True)
class NodeFailure:
    time: float
    chips_lost: int
    reason: str = "simulated"


@dataclasses.dataclass
class FleetMonitor:
    """Tracks liveness; converts failures into elastic rescale actions."""

    total_chips: int
    heartbeat_timeout_s: float = 30.0

    def __post_init__(self):
        self.live_chips = self.total_chips
        self.failures: list[NodeFailure] = []
        self._last_beat: dict[int, float] = {}

    def heartbeat(self, chip_id: int, now: float | None = None):
        self._last_beat[chip_id] = now if now is not None else time.time()

    def dead_chips(self, now: float) -> list[int]:
        return [c for c, t in self._last_beat.items()
                if now - t > self.heartbeat_timeout_s]

    def fail(self, event: NodeFailure):
        self.failures.append(event)
        self.live_chips = max(0, self.live_chips - event.chips_lost)

    def rescale_scheduler(self, sched: GangScheduler
                          ) -> tuple[GangScheduler, object]:
        """Apply the current live-chip count to a serving scheduler."""
        return elastic_repartition(sched, self.live_chips)


def run_with_restarts(make_trainer: Callable[[], object], num_steps: int,
                      *, max_restarts: int = 3, failure_steps=()):
    """Drive a Trainer to ``num_steps`` surviving injected failures.

    ``make_trainer`` builds a fresh Trainer (simulating a restarted job);
    each failure loses all state except checkpoints — the resumed run must
    continue from the last checkpoint.  Returns (result, restarts).

    Only :class:`~repro_torch.train.trainer.InjectedFailure` triggers a
    restart: a genuine RuntimeError out of the train step (NaN loss, shape
    bug) propagates on the first attempt instead of burning
    ``max_restarts`` retries on a deterministic crash."""
    from ..train.trainer import FailureInjector, InjectedFailure
    restarts = 0
    fail_iter = iter(sorted(failure_steps))
    next_fail = next(fail_iter, None)
    while True:
        trainer = make_trainer()
        inj = FailureInjector(at_step=next_fail if next_fail is not None
                              else -1)
        try:
            result = trainer.run(num_steps, failure=inj)
            return result, restarts
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            next_fail = next(fail_iter, None)
