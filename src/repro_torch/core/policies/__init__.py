"""Scheduling policies for the multiserver-job model (paper §2 + §3).

The port's own copy of the reference's ``repro.core.policies``, statement
for statement: plain Python and numpy on the host, driven by the event
engine of :mod:`repro_torch.core.simulator` (``engine="python"``).  The
set iteration orders, stable sorts and float expressions are the
reference's, so every policy gives the reference's schedule bit for bit.
"""

from .base import Policy, SystemView
from .balanced_splitting import BalancedSplitting, ModifiedBalancedSplitting
from .fcfs import FCFS, FirstFitBackfill
from .max_weight import MaxWeight
from .server_filling import ServerFilling, ServerFillingGittins, ServerFillingSRPT
from .servers_first import LeastServersFirst, MostServersFirst
from .srpt import FirstFitSRPT

__all__ = [
    "Policy", "SystemView",
    "BalancedSplitting", "ModifiedBalancedSplitting",
    "FCFS", "FirstFitBackfill",
    "MaxWeight",
    "ServerFilling", "ServerFillingSRPT", "ServerFillingGittins",
    "MostServersFirst", "LeastServersFirst",
    "FirstFitSRPT",
]


def make_policy(name: str, wl=None, aux: str = "fcfs") -> Policy:
    """Factory by short name; BSF policies need the workload for eq. (2)."""
    if name in ("bs", "balanced-splitting"):
        return BalancedSplitting.for_workload(wl, aux=aux)
    if name in ("modbs", "modified-bs"):
        return ModifiedBalancedSplitting.for_workload(wl, aux=aux)
    if name == "sf-gittins":
        return ServerFillingGittins([c.d * c.n for c in wl.classes])
    table = {
        "fcfs": FCFS,
        "backfill": FirstFitBackfill,
        "maxweight": MaxWeight,
        "serverfilling": ServerFilling,
        "sf-srpt": ServerFillingSRPT,
        "msf": MostServersFirst,
        "lsf": LeastServersFirst,
        "ff-srpt": FirstFitSRPT,
    }
    if name not in table:
        raise KeyError(f"unknown policy {name!r}")
    return table[name]()
