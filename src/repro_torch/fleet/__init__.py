"""Fleet topology (regions, sites, per-link WAN properties) and the event
loop's budget controller."""
from repro_torch.fleet.controller import BudgetController, water_fill
from repro_torch.fleet.topology import (FleetTopology, LinkSpec, RegionSpec,
                                        SiteSpec, make_topology)

__all__ = ["BudgetController", "FleetTopology", "LinkSpec", "RegionSpec",
           "SiteSpec", "make_topology", "water_fill"]
