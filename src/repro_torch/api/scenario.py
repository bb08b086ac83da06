"""ScenarioConfig — the port's copy of ``repro.api.scenario``.

One frozen experiment description: data source, fleet topology, planner,
WAN transport, budget controller, queries and seeds.
``ScenarioConfig.from_dict`` loads the reference's scenario files
(``tests/goldens/scenarios/*.json``) unchanged.

Construction checks the spelling of every registry-backed name (an
unknown name raises with the alternatives listed); whether the port can
run a scenario is decided when it is built into an experiment, which
raises ``NotImplementedError`` naming the ROADMAP item for anything not
ported yet.  The adaptive and chaos specs are kept as plain data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.api import registry as _reg
from repro_torch.core.types import PlannerConfig

_reg.populate()        # spelling checks need the registries filled

DEMAND_SIGNALS = ("obs_err", "pred_err", "max_err")
SOLVERS = ("ipm", "slsqp", "closed_form")
IID_MODES = ("none", "iid", "thinning", "m_dependence")
# baseline planners of the event path (not ported yet)
BASELINES = ("approx_iot", "neyman_cost", "s_voila", "srs")


def _freeze(v):
    """Arrays/lists -> nested tuples so frozen configs compare and hash."""
    if isinstance(v, np.ndarray):
        return _freeze(v.tolist())
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, dict):
        return {k: _freeze(x) for k, x in v.items()}
    return v


def _one_of(kind: str, name: str, names: tuple) -> None:
    if name not in names:
        raise _reg.UnknownComponentError(kind, name, names)


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Which dataset generator feeds the experiment (``window`` tuples per
    tumbling window; ``options`` passed to the generator verbatim)."""

    dataset: str = "smartcity"
    n_points: int = 2048
    window: int = 256
    seed: int = 0
    options: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        _reg.DATASETS.check(self.dataset)
        object.__setattr__(self, "options",
                           {k: _freeze(v) for k, v in self.options.items()})

    def __hash__(self):
        return hash((self.dataset, self.n_points, self.window, self.seed,
                     tuple(sorted(self.options.items()))))


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Fleet geometry + per-link WAN character."""

    n_regions: int = 1
    sites_per_region: int = 1
    seed: int = 0
    drop_prob: float = 0.0
    hetero_links: bool = True
    latency_scale: float = 1.0
    jitter_ms: float = 0.0
    bandwidth_bytes_per_ms: Optional[float] = None

    @property
    def n_sites(self) -> int:
        return self.n_regions * self.sites_per_region

    def build(self, k: int):
        from repro_torch.fleet.topology import make_topology
        return make_topology(self.n_regions, self.sites_per_region, k,
                             seed=self.seed, drop_prob=self.drop_prob,
                             hetero_links=self.hetero_links,
                             latency_scale=self.latency_scale,
                             jitter_ms=self.jitter_ms,
                             bandwidth_bytes_per_ms=self.bandwidth_bytes_per_ms)


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """WAN timing of the event-driven runtime (the scan models zero latency)."""

    drop_prob: float = 0.0
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    window_period_ms: float = 1000.0
    staleness_deadline_ms: Optional[float] = None
    bandwidth_bytes_per_ms: Optional[float] = None
    retransmit_timeout_ms: Optional[float] = None
    max_retries: int = 0


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """Fleet budget controller configuration."""

    mode: str = "rebalance"            # "rebalance" | "static"
    floor_mult: float = 0.3
    ceil_mult: float = 3.0
    ewma: float = 0.5
    link_cost_aware: bool = False
    demand_signal: str = "obs_err"
    query_split: Optional[float] = None
    tail_demand_signal: str = "max_err"

    def __post_init__(self):
        if self.mode not in ("rebalance", "static"):
            raise ValueError(f"controller mode must be 'rebalance' or "
                             f"'static', got {self.mode!r}")
        _one_of("controller demand signal", self.demand_signal,
                DEMAND_SIGNALS)
        _one_of("controller demand signal", self.tail_demand_signal,
                DEMAND_SIGNALS)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Everything one experiment run depends on, declaratively."""

    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    method: str = "model"
    budget_fraction: float = 0.25
    planner: PlannerConfig = dataclasses.field(default_factory=PlannerConfig)
    topology: Optional[TopologySpec] = None
    controller: Optional[ControllerSpec] = None
    transport: TransportSpec = dataclasses.field(default_factory=TransportSpec)
    queries: tuple = ("AVG", "VAR", "MIN", "MAX")
    runtime: str = "event"
    name: str = ""
    adaptive: Optional[dict] = None    # plain data; not ported yet
    chaos: Optional[dict] = None       # plain data; not ported yet

    def __post_init__(self):
        planner = self.planner
        for f in ("cost_per_sample", "fixed_predictors"):
            v = getattr(planner, f)
            if v is not None and not isinstance(v, tuple):
                planner = dataclasses.replace(planner, **{f: _freeze(v)})
        object.__setattr__(self, "planner", planner)
        object.__setattr__(self, "queries", tuple(self.queries))
        for f in ("adaptive", "chaos"):
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, _freeze(dict(v)))

        if self.method != "model" and self.method not in BASELINES:
            _reg.MODELS.check(self.method)
        _one_of("solver", planner.solver, SOLVERS)
        _one_of("iid mode", planner.iid_mode, IID_MODES)
        _reg.MODELS.check(planner.model)
        _reg.EPSILON_POLICIES.check(planner.epsilon_policy)
        _reg.DEPENDENCE.check(planner.dependence)
        _reg.RUNTIMES.check(self.runtime)
        if planner.engine is not None:
            _reg.ENGINES.check(planner.engine)
        for q in self.queries:
            _reg.QUERIES.check(q)

    @property
    def is_fleet(self) -> bool:
        return self.topology is not None and self.topology.n_sites > 1

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioConfig":
        d = dict(d)
        planner = {k: (_freeze(v) if isinstance(v, list) else v)
                   for k, v in d.get("planner", {}).items()}
        return cls(
            data=DataSpec(**d.get("data", {})),
            method=d.get("method", "model"),
            budget_fraction=d.get("budget_fraction", 0.25),
            planner=PlannerConfig(**planner),
            topology=(None if d.get("topology") is None
                      else TopologySpec(**d["topology"])),
            controller=(None if d.get("controller") is None
                        else ControllerSpec(**d["controller"])),
            transport=TransportSpec(**d.get("transport", {})),
            queries=tuple(d.get("queries", ("AVG", "VAR", "MIN", "MAX"))),
            runtime=d.get("runtime", "event"),
            name=d.get("name", ""),
            adaptive=d.get("adaptive"),
            chaos=d.get("chaos"),
        )
