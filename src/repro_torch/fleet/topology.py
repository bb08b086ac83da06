"""Fleet topology: regions, edge sites and per-link WAN properties.

Copied from ``repro.fleet.topology`` (plain dataclasses and numpy): the
same arguments and seed give the same topology.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One site's WAN uplink."""

    cost_per_byte: float = 1.0     # relative $ (or energy) per byte
    latency_ms: float = 40.0       # one-way propagation latency
    jitter_ms: float = 0.0         # per-payload U(0, jitter) delay on top
    drop_prob: float = 0.0         # per-payload loss probability
    bandwidth_bytes_per_ms: Optional[float] = None  # None = instantaneous


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    site_id: int                   # dense 0..E-1, fleet-wide
    region: str
    k: int                         # streams cached at this site per window
    link: LinkSpec = LinkSpec()


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    name: str
    sites: tuple


@dataclasses.dataclass(frozen=True)
class FleetTopology:
    regions: tuple

    def __post_init__(self):
        ids = [s.site_id for s in self.sites]
        if sorted(ids) != list(range(len(ids))):
            raise ValueError(f"site_ids must be dense 0..E-1, got {sorted(ids)}")
        ks = {s.k for s in self.sites}
        if len(ks) != 1:
            # the batched planner stacks windows into one (E, k, N) tensor
            raise ValueError(f"all sites must cache the same k streams, got {ks}")

    @property
    def sites(self) -> tuple:
        return tuple(sorted((s for r in self.regions for s in r.sites),
                            key=lambda s: s.site_id))

    @property
    def n_sites(self) -> int:
        return sum(len(r.sites) for r in self.regions)

    @property
    def k(self) -> int:
        return self.sites[0].k

    @property
    def region_names(self) -> tuple:
        return tuple(r.name for r in self.regions)

    def region_of(self) -> np.ndarray:
        """(E,) region index (into ``region_names``) per site."""
        name_idx = {n: i for i, n in enumerate(self.region_names)}
        return np.asarray([name_idx[s.region] for s in self.sites], np.int64)


def make_topology(n_regions: int, sites_per_region: int, k: int,
                  seed: int = 0, drop_prob: float = 0.0,
                  hetero_links: bool = True, latency_scale: float = 1.0,
                  jitter_ms: float = 0.0,
                  bandwidth_bytes_per_ms: Optional[float] = None
                  ) -> FleetTopology:
    """Synthetic geo topology: distant regions pay more per byte and see
    higher latency, with per-site jitter on top."""
    rng = np.random.default_rng(seed)
    regions = []
    sid = 0
    for r in range(n_regions):
        base_cost = 1.0 + (0.5 * r if hetero_links else 0.0)
        base_lat = 30.0 + (25.0 * r if hetero_links else 0.0)
        sites = []
        for _ in range(sites_per_region):
            jitter = rng.uniform(0.9, 1.1) if hetero_links else 1.0
            link = LinkSpec(cost_per_byte=base_cost * jitter,
                            latency_ms=base_lat * jitter * latency_scale,
                            jitter_ms=jitter_ms,
                            drop_prob=drop_prob,
                            bandwidth_bytes_per_ms=bandwidth_bytes_per_ms)
            sites.append(SiteSpec(site_id=sid, region=f"region{r}", k=k,
                                  link=link))
            sid += 1
        regions.append(RegionSpec(name=f"region{r}", sites=tuple(sites)))
    return FleetTopology(regions=tuple(regions))
