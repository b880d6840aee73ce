"""Straggler mitigation — the helper set IS the mechanism.

The port's copy of ``repro/runtime/straggler.py``, over the port's
``GangScheduler``.

Under BS-π a straggling class slice (slow chips, thermal throttling, a
flaky host) manifests as its queue backing up; Definition 1 rule 1 already
overflows new arrivals to the helper block.  This module adds the *active*
variant: gangs whose wait exceeds a deadline multiple of their class's mean
service time are re-targeted to the helper block immediately (they have
not started — no preemption involved, consistent with the framework).
"""

from __future__ import annotations

import dataclasses

from ..sched.gang import GangScheduler


@dataclasses.dataclass
class StragglerMitigator:
    sched: GangScheduler
    deadline_multiple: float = 2.0
    redirected: int = 0

    def tick(self, now: float) -> int:
        """Re-prioritize helper-queued gangs that blew their deadline: move
        them to the queue head so π serves them next (π stays FCFS among
        deadline peers).  Returns how many were promoted."""
        promoted = 0
        q = self.sched.helper_wait
        items = list(q)
        for job in items:
            cls = self.sched.partition.classes[job.cls]
            deadline = self.deadline_multiple * cls.d
            if now - job.arrival > deadline:
                q.remove(job)
                q.insert(promoted, job)
                promoted += 1
        if promoted:
            self.redirected += promoted
            self.sched._helper_schedule(now)
        return promoted
