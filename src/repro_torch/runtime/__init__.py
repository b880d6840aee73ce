"""Fleet runtime: failure detection and straggler mitigation on the BS-π
scheduler (serving), and restarts of a trainer from its checkpoints."""

from .fault_tolerance import FleetMonitor, NodeFailure, run_with_restarts
from .straggler import StragglerMitigator

__all__ = ["FleetMonitor", "NodeFailure", "StragglerMitigator",
           "run_with_restarts"]
