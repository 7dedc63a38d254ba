"""repro_torch.sched — demand-aware query scheduling (``repro.sched``).

``planner``: demand signatures, the greedy micro-batch plan and its
``PlanCache``.  ``queue``: the bounded EDF request queue and the
``QueryScheduler`` serve loop over a ``SearchSession``.
"""
from repro_torch.sched.planner import (
    DemandPlan,
    PlanCache,
    demand_signatures,
    plan_micro_batches,
)
from repro_torch.sched.queue import (
    QueueFull,
    QueryScheduler,
    Request,
    RequestQueue,
    SearchResult,
)

__all__ = [
    "DemandPlan",
    "PlanCache",
    "demand_signatures",
    "plan_micro_batches",
    "QueueFull",
    "QueryScheduler",
    "Request",
    "RequestQueue",
    "SearchResult",
]
