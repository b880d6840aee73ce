"""Fleet runtime for serving: failure detection and straggler
mitigation on the BS-π scheduler."""

from .fault_tolerance import FleetMonitor, NodeFailure
from .straggler import StragglerMitigator

__all__ = ["FleetMonitor", "NodeFailure", "StragglerMitigator"]
