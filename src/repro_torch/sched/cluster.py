"""Balanced Splitting applied to a physical device fleet — eq. (2) on chips.

The port's copy of ``repro/sched/cluster.py``, on the port's own
``core/partition.py`` and ``core/workload.py``.

A *gang job class* is (chips needed, service-time distribution): an
inference request class or a training job that needs ``n_i`` chips
exclusively (all-or-nothing — the defining multiserver-job constraint).
``BalancedMeshPartition`` applies the paper's eq. (2) to the flat device
list: class ``i`` gets a static block of ``a_i`` chips (a multiple of
``n_i``), the remainder is the helper block ``H``.  Blocks are contiguous
in the device ordering, which on a pod of accelerators means
interconnect-contiguous slices.

The partition is a *pure function of (k, per-class demand)* — the property
``elastic_repartition`` exploits on chip loss/gain.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.partition import BalancedPartition, compute_psi
from ..core.workload import JobClass


@dataclasses.dataclass(frozen=True)
class MeshSlice:
    """A contiguous block of devices dedicated to one job class."""

    name: str
    start: int
    size: int                 # a_i (multiple of need for class slices)
    need: int                 # chips per gang (n_i); 0 for the helper slice

    @property
    def slots(self) -> int:
        """Whole-gang slots in this slice (s_i of Property 1)."""
        return self.size // self.need if self.need else 0

    def devices(self, all_devices: Sequence) -> list:
        return list(all_devices[self.start:self.start + self.size])

    def slot_devices(self, all_devices: Sequence, slot: int) -> list:
        off = self.start + slot * self.need
        return list(all_devices[off:off + self.need])


@dataclasses.dataclass(frozen=True)
class BalancedMeshPartition:
    """Eq. (2) over ``k`` devices for the given job classes."""

    k: int
    classes: tuple[JobClass, ...]
    slices: tuple[MeshSlice, ...]
    helper: MeshSlice
    psi: float

    @classmethod
    def build(cls, k: int, classes: Sequence[JobClass]
              ) -> "BalancedMeshPartition":
        needs = np.array([c.n for c in classes], dtype=np.int64)
        demands = np.array([c.demand for c in classes])
        psi = compute_psi(k, needs, demands)
        fracs = (k / needs) * (demands / demands.sum())
        counts = np.floor(psi * fracs + 1e-12).astype(np.int64)
        a = counts * needs
        slices, off = [], 0
        for c, ai in zip(classes, a):
            slices.append(MeshSlice(c.name, off, int(ai), c.n))
            off += int(ai)
        helper = MeshSlice("helpers", off, k - off, 0)
        return cls(k=k, classes=tuple(classes), slices=tuple(slices),
                   helper=helper, psi=float(psi))

    def as_core_partition(self) -> BalancedPartition:
        """The queueing-theoretic view (for theory cross-checks)."""
        return BalancedPartition(
            k=self.k, needs=tuple(c.n for c in self.classes),
            a=tuple(s.size for s in self.slices), psi=self.psi)

    def validate(self) -> None:
        off = 0
        for s in self.slices:
            assert s.start == off and s.size % s.need == 0
            off += s.size
        assert self.helper.start == off
        assert self.helper.size == self.k - off

    def summary(self) -> str:
        rows = [f"  {s.name:>16s}: chips [{s.start:5d},"
                f"{s.start + s.size:5d})  {s.slots:3d} slots x {s.need} chips"
                for s in self.slices]
        rows.append(f"  {'helpers':>16s}: chips [{self.helper.start:5d},"
                    f"{self.k:5d})  ({self.helper.size} chips)")
        return "\n".join([f"BalancedMeshPartition(k={self.k}, "
                          f"psi={self.psi:.4f})"] + rows)
