"""Algorithm-1 plan engines of the port (``host``/``host_loop``,
``batched`` and ``sharded``)."""
from repro_torch.planning.batched import BatchedEngine, FleetPlan, fleet_plan
from repro_torch.planning.engine import (HOST_ENGINE, HostEngine, PlanEngine,
                                         UnsupportedPlanConfig,
                                         assemble_payload, host_loop_plan)
from repro_torch.planning.sharded import ShardedEngine

__all__ = ["BatchedEngine", "FleetPlan", "HOST_ENGINE", "HostEngine",
           "PlanEngine", "ShardedEngine", "UnsupportedPlanConfig",
           "assemble_payload", "fleet_plan", "host_loop_plan"]
