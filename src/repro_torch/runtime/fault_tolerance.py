"""Fleet-level fault tolerance: heartbeats, failure detection, rescale.

The serving half of ``repro/runtime/fault_tolerance.py``: ``NodeFailure``
and ``FleetMonitor``.  On real fleets the heartbeat source is the cluster
manager; here the FleetMonitor consumes simulated NodeFailure events
(tests inject them) and drives the serving recovery path:
``sched.elastic_repartition`` recomputes eq. (2) on the surviving chip
count; only gangs on dead chips are lost (the paper's non-preemption
trade), everything else keeps running.  The training path
(``run_with_restarts``, which restarts a trainer from its latest
checkpoint) comes with the port's trainer.
"""

from __future__ import annotations

import dataclasses
import time

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

