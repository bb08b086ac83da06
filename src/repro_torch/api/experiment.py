"""Experiment — scenario in, report out (port of ``repro.api.experiment``).

``Experiment.from_scenario(cfg, device=None).run()`` builds the scan
runtime (a fleet, or one edge) from a
:class:`~repro_torch.api.scenario.ScenarioConfig`, generates the
scenario's windows and returns a :class:`RunReport`.
``device=None`` means the GPU; with no CUDA device it raises rather than
running on the CPU.  Scenarios the port cannot run yet raise
``NotImplementedError`` naming the ROADMAP item that will port them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.api.registry import DATASETS, ENGINES, MODELS, RUNTIMES
from repro_torch.api.scenario import ScenarioConfig


@dataclasses.dataclass(frozen=True)
class RunReport:
    """Structured result of one scenario run.

    ``nrmse`` is the per-query fleet-wide nan-mean; ``nrmse_per_stream``
    keeps the (E, k) table.  ``raw`` is the runtime's native dict.
    """

    scenario: Optional[ScenarioConfig]
    n_sites: int
    nrmse: dict
    nrmse_at_query: dict
    nrmse_per_stream: dict
    region_nrmse: dict
    wan_bytes: int
    wan_cost: float
    full_bytes: int
    wan_bytes_by_region: dict
    wan_cost_by_region: dict
    gaps: int
    revisions: int
    late_drops: int
    duplicates: int
    retransmits: int
    freshness_ms: dict
    freshness_by_region: dict
    plan_seconds: float
    raw: dict

    @property
    def wan_fraction(self) -> float:
        """WAN bytes as a fraction of shipping every tuple raw."""
        return self.wan_bytes / max(self.full_bytes, 1)


def _report_single(scenario, r: dict) -> RunReport:
    nrmse = {q: float(np.nanmean(v)) for q, v in r["nrmse"].items()}
    nrmse_q = {q: float(np.nanmean(v))
               for q, v in r["nrmse_at_query"].items()}
    return RunReport(
        scenario=scenario, n_sites=1,
        nrmse=nrmse, nrmse_at_query=nrmse_q,
        nrmse_per_stream={q: np.asarray(v) for q, v in r["nrmse"].items()},
        region_nrmse={"local": nrmse},
        wan_bytes=int(r["wan_bytes"]), wan_cost=float(r["wan_cost"]),
        full_bytes=int(r["full_bytes"]),
        wan_bytes_by_region={"local": int(r["wan_bytes"])},
        wan_cost_by_region={"local": float(r["wan_cost"])},
        gaps=int(r["gaps"]), revisions=int(r["revisions"]),
        late_drops=int(r["late_drops"]), duplicates=int(r["duplicates"]),
        retransmits=int(r["retransmits"]),
        freshness_ms=dict(r["freshness_ms"]),
        freshness_by_region={"local": dict(r["freshness_ms"])},
        plan_seconds=float(r["plan_seconds"]),
        raw=r)


def _report_fleet(scenario, r: dict, n_sites: int) -> RunReport:
    return RunReport(
        scenario=scenario, n_sites=n_sites,
        nrmse=dict(r["fleet_nrmse"]),
        nrmse_at_query=dict(r["fleet_nrmse_at_query"]),
        nrmse_per_stream={q: np.asarray(v)
                          for q, v in r["site_nrmse"].items()},
        region_nrmse={reg: dict(qs)
                      for reg, qs in r["region_nrmse"].items()},
        wan_bytes=int(r["wan_bytes"]), wan_cost=float(r["wan_cost"]),
        full_bytes=int(r["full_bytes"]),
        wan_bytes_by_region=dict(r["wan_bytes_by_region"]),
        wan_cost_by_region=dict(r["wan_cost_by_region"]),
        gaps=int(r["gaps"]), revisions=int(r["revisions"]),
        late_drops=int(r["late_drops"]), duplicates=int(r["duplicates"]),
        retransmits=int(r.get("retransmits", 0)),
        freshness_ms=dict(r["freshness_ms"]),
        freshness_by_region={reg: dict(f)
                             for reg, f in r["freshness_by_region"].items()},
        plan_seconds=float(r["plan_seconds"]),
        raw=r)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP.md: queue 1, {item!r})")


def check_scan_scenario(scenario: ScenarioConfig) -> None:
    """Reject what the port cannot run yet, and what the scan runtime can
    never honor (WAN timing it does not model)."""
    # the event loop (and chaos on it) raises here: queue 1, 'Event path'
    RUNTIMES.get(scenario.runtime)
    if scenario.method != "model":
        if scenario.method not in MODELS:
            raise _not_ported(f"baseline method {scenario.method!r}",
                              "Event path")
        if scenario.is_fleet:
            raise ValueError("the fleet scan plans with planner.model; set "
                             "method='model'")
    DATASETS.get(scenario.data.dataset)
    t = scenario.transport
    if t.latency_ms or t.jitter_ms or t.drop_prob:
        raise ValueError("runtime='scan' models a zero-latency WAN; transport "
                         "latency_ms/jitter_ms/drop_prob must be 0")
    if (t.bandwidth_bytes_per_ms is not None
            or t.retransmit_timeout_ms is not None
            or t.staleness_deadline_ms is not None):
        raise ValueError("runtime='scan' does not model bandwidth, "
                         "retransmits or staleness deadlines")
    topo = scenario.topology
    if topo is not None:
        if topo.latency_scale != 0.0 or topo.jitter_ms or topo.drop_prob:
            raise ValueError("runtime='scan' needs a zero-latency topology: "
                             "set latency_scale=0, jitter_ms=0, drop_prob=0")
        if topo.bandwidth_bytes_per_ms is not None:
            raise ValueError("runtime='scan': topology bandwidth modeling "
                             "needs runtime='event'")
    spec = scenario.controller
    if spec is not None and spec.query_split is not None:
        raise _not_ported("the per-query controller split", "Event path")
    ENGINES.get(scenario.planner.engine or "batched").check(scenario.planner)


@dataclasses.dataclass
class Experiment:
    """One runnable experiment, built declaratively from a scenario."""

    scenario: ScenarioConfig
    runtime: object

    @classmethod
    def from_scenario(cls, scenario: ScenarioConfig, *,
                      use_kernel: Optional[bool] = None,
                      collect: str = "payloads",
                      device=None) -> "Experiment":
        """``use_kernel`` as in ``fleet_plan``; ``collect`` picks the
        payload replay or the on-device estimates; ``device=None`` is the
        GPU."""
        dev = resolve_device(device)
        check_scan_scenario(scenario)
        from repro_torch.runtime.scan import ScanRuntime
        runtime = ScanRuntime.from_scenario(scenario, use_kernel=use_kernel,
                                            collect=collect, device=dev)
        return cls(scenario=scenario, runtime=runtime)

    def make_windows(self) -> list:
        """Materialize the scenario's window sequence (deterministic): (E,
        k, N) arrays for a fleet, ``WindowBatch``es for one edge."""
        from repro_torch.data.streams import fleet_windows, windows_from_matrix
        data = self.scenario.data
        if not self.scenario.is_fleet:
            return windows_from_matrix(data.generate()[0], data.window)
        topo = self.scenario.topology
        gen = DATASETS.get(data.dataset)
        vals, _ = gen(n_sites=topo.n_sites, n_regions=topo.n_regions,
                      n_points=data.n_points, seed=data.seed,
                      window=data.window, **dict(data.options))
        return fleet_windows(vals, data.window)

    def run(self, windows=None, n_windows: Optional[int] = None,
            state=None) -> RunReport:
        """Run the scenario's windows (or ``windows``); ``n_windows`` cycles
        the pool to that many windows; ``state`` resumes from a carry."""
        if windows is None:
            windows = self.make_windows()
        r = self.runtime.run(windows, n_windows=n_windows, state=state)
        if self.runtime.n_sites > 1:
            return _report_fleet(self.scenario, r, self.runtime.n_sites)
        return _report_single(self.scenario, r)
