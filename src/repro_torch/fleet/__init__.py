"""Fleet topology: regions, sites and per-link WAN properties."""
from repro_torch.fleet.topology import (FleetTopology, LinkSpec, RegionSpec,
                                        SiteSpec, make_topology)

__all__ = ["FleetTopology", "LinkSpec", "RegionSpec", "SiteSpec",
           "make_topology"]
