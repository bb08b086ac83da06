"""Algorithm-1 plan engines of the port (``batched``; the host and
sharded engines are not ported yet)."""
from repro_torch.planning.batched import BatchedEngine, FleetPlan, fleet_plan
from repro_torch.planning.engine import (PlanEngine, UnsupportedPlanConfig,
                                         assemble_payload)

__all__ = ["BatchedEngine", "FleetPlan", "PlanEngine",
           "UnsupportedPlanConfig", "assemble_payload", "fleet_plan"]
