"""Fault tolerance of the training loop (``repro.runtime``)."""
from repro_torch.runtime.fault_tolerance import (
    FaultToleranceSupervisor,
    StragglerMonitor,
    StragglerReport,
    run_with_restarts,
)

__all__ = [
    "FaultToleranceSupervisor",
    "StragglerMonitor",
    "StragglerReport",
    "run_with_restarts",
]
