"""Fault tolerance and elastic restart of the training loop
(``repro.runtime``)."""
from repro_torch.runtime.elastic import (
    ElasticPlan,
    elastic_restart_plan,
    make_mesh_from_plan,
    remesh_state,
)
from repro_torch.runtime.fault_tolerance import (
    FaultToleranceSupervisor,
    StragglerMonitor,
    StragglerReport,
    run_with_restarts,
)

__all__ = [
    "ElasticPlan",
    "FaultToleranceSupervisor",
    "StragglerMonitor",
    "StragglerReport",
    "elastic_restart_plan",
    "make_mesh_from_plan",
    "remesh_state",
    "run_with_restarts",
]
