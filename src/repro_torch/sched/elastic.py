"""Elastic rescale: recompute the balanced partition on chip loss/gain.

The port's copy of ``repro/sched/elastic.py`` (host bookkeeping, no
tensors), over the port's ``GangScheduler``.

Eq. (2) is a pure function of ``(k, per-class demand)``, so losing a pod
slice or adding capacity is: (1) recompute the partition on the surviving
device list; (2) remap running gangs whose slice survived; (3) the only
casualties are gangs on dead chips — exactly the paper's non-preemption
trade (no migration, no checkpoint-preempt of multi-chip gangs).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.workload import JobClass
from .cluster import BalancedMeshPartition
from .gang import GangScheduler


@dataclasses.dataclass(frozen=True)
class RescaleReport:
    old_k: int
    new_k: int
    partition: BalancedMeshPartition
    killed_jobs: tuple[int, ...]      # gangs lost with the dead chips
    requeued_jobs: tuple[int, ...]    # gangs whose slot no longer exists


def elastic_repartition(sched: GangScheduler, new_k: int,
                        classes: Sequence[JobClass] | None = None
                        ) -> tuple[GangScheduler, RescaleReport]:
    """Rebuild the scheduler for ``new_k`` chips, carrying over running
    gangs whose class slot still exists.  Jobs on removed chips are killed
    (reported), jobs in slots beyond the new slot count are requeued onto
    the helper queue."""
    classes = classes or sched.partition.classes
    old = sched.partition
    new_part = BalancedMeshPartition.build(new_k, classes)
    new_sched = GangScheduler(new_part, aux=sched.aux,
                              on_place=sched.on_place,
                              on_finish=sched.on_finish)
    killed: list[int] = []
    requeued: list[int] = []
    for jid, job in sched.running.items():
        kind, idx = job.placement
        if kind == "class":
            ns = new_part.slices[job.cls]
            if idx < ns.slots:
                new_sched.free_slots[job.cls].remove(idx)
                new_sched.running[jid] = job
                continue
            requeued.append(jid)
            new_sched.helper_wait.append(job)
        else:
            off = idx
            end = off + job.need
            if old.helper.start + end <= new_k and \
                    end <= new_part.helper.size:
                # helper block shrank from the tail; survivors keep offsets
                for j in range(off, off + job.need):
                    new_sched._helper_map[j] = True
                new_sched.helper_free -= job.need
                new_sched.helper_used[jid] = (off, job.need)
                new_sched.running[jid] = job
            else:
                killed.append(jid)
    # waiting gangs carry over untouched
    for w in sched.helper_wait:
        new_sched.helper_wait.append(w)
    new_sched.n_arrivals = sched.n_arrivals
    new_sched.n_helper_served = sched.n_helper_served
    new_sched.completed = sched.completed
    report = RescaleReport(old_k=old.k, new_k=new_k, partition=new_part,
                           killed_jobs=tuple(killed),
                           requeued_jobs=tuple(requeued))
    return new_sched, report
