"""Experiment — scenario in, report out (port of ``repro.api.experiment``).

``Experiment.from_scenario(cfg, device=None).run()`` builds the runtime a
:class:`~repro_torch.api.scenario.ScenarioConfig` names, generates the
scenario's windows and returns a :class:`RunReport`:

  * ``runtime="scan"`` / ``"scan_steps"`` — the scan runtime
    (:class:`~repro_torch.runtime.scan.ScanRuntime`), a fleet or one edge,
    on a zero-latency WAN;
  * ``runtime="event"`` on the WAN event clock (per-link latency, jitter,
    drops, bandwidth and retransmits, late payloads that revise served
    answers, stragglers): :class:`SingleEdgeRuntime` for one edge (no
    topology, or a one-site one whose link gives the WAN), planned by the
    host planner; :class:`FleetRuntime` for a fleet (E > 1), with the host
    budget controller, adaptive re-planning and chaos.

``device=None`` means the GPU; with no CUDA device it raises rather than
running on the CPU.  Scenarios the port cannot run yet raise
``NotImplementedError`` naming the ROADMAP item that will port them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

import repro_torch.core.planner  # noqa: F401  — fills MODELS, SOLVERS, ...
from repro_torch import resolve_device
from repro_torch.api.registry import (DATASETS, DEPENDENCE, ENGINES,
                                      EPSILON_POLICIES, MODELS, QUERIES,
                                      RUNTIMES, SOLVERS)
from repro_torch.api.scenario import ControllerSpec, ScenarioConfig
from repro_torch.core import queries as Q
from repro_torch.core.reconstruct import reconstruct_window
from repro_torch.core.types import EdgePayload, PlannerConfig


# ==========================================================================
# single-edge runtime (one edge, one uplink, one cloud)
# ==========================================================================

@dataclasses.dataclass
class SingleEdgeRuntime:
    """Event-driven edge -> WAN -> cloud run on a virtual clock.

    Window ``wid`` closes at the edge at ``wid * window_period_ms``; its
    query is answered one period later from whatever has arrived.  A
    payload landing after its due time but within
    ``staleness_deadline_ms`` revises the emitted answer (``revisions``;
    ``nrmse`` scores the revised table, ``nrmse_at_query`` what was
    served on time); past the deadline the cloud keeps serving stale and
    counts a gap.  A plain ``Transport`` or ``CloudNode`` is upgraded to
    the event clock's, and the cloud's counters are mirrored back after
    ``run``.  The edge plans on its device; the link, the cloud, the
    reconstruction and the queries are host numpy.
    """

    edge: "EdgeNode"
    cloud: "CloudNode"
    transport: "Transport"
    window_period_ms: float = 1000.0
    staleness_deadline_ms: Optional[float] = None

    def __post_init__(self):
        from repro_torch.streaming import AsyncTransport, ReorderCloudNode
        if not isinstance(self.transport, AsyncTransport):
            self.transport = AsyncTransport.from_transport(self.transport)
        self._user_cloud = None
        if not isinstance(self.cloud, ReorderCloudNode):
            self._user_cloud = self.cloud
            self.cloud = ReorderCloudNode(query_names=self.cloud.query_names)
        self.cloud.window_period_ms = self.window_period_ms
        if self.staleness_deadline_ms is not None:
            self.cloud.deadline_ms = self.staleness_deadline_ms

    def run(self, windows: list) -> dict:
        from repro_torch.runtime.report import freshness_percentiles
        k = windows[0].k
        T = len(windows)
        qnames = self.cloud.query_names
        period = self.window_period_ms
        est = {q: np.full((T, k), np.nan) for q in qnames}       # revised
        est_q = {q: np.full((T, k), np.nan) for q in qnames}     # at query
        tru = {q: np.full((T, k), np.nan) for q in qnames}
        ages = np.full(T, np.nan)
        revised = np.zeros(T, bool)

        def _record(wid, rec, tables):
            res = self.cloud.query(rec)
            for q in qnames:
                row = res.get(q, [])
                vals = np.asarray(row) if len(row) == k else np.full(k, np.nan)
                for tbl in tables:
                    tbl[q][wid] = vals

        def _apply(outcome):
            if outcome.kind == "revised":
                _record(outcome.window_id, outcome.reconstruction, (est,))
                revised[outcome.window_id] = True

        t_run = time.perf_counter()
        for wid, w in enumerate(windows):
            now = wid * period
            q_time = now + period
            payload = self.edge.process_window(w)
            payload = dataclasses.replace(payload, sent_at_ms=now)
            self.transport.send(payload, now_ms=now)
            for ev in self.transport.drain(q_time):
                _apply(self.cloud.ingest_event(ev.payload, now_ms=ev.at_ms))
            rec, age, _ = self.cloud.serve(wid, q_time)
            _record(wid, rec, (est, est_q))
            ages[wid] = age
            full = [np.asarray(w.values[i, : int(w.counts[i])])
                    for i in range(k)]
            _record(wid, full, (tru,))

        # in-flight payloads may still land within the deadline and revise
        for ev in self.transport.drain(float("inf")):
            _apply(self.cloud.ingest_event(ev.payload, now_ms=ev.at_ms))
        self.cloud.finalize(T)
        run_seconds = time.perf_counter() - t_run
        if self._user_cloud is not None:
            self._user_cloud.gaps = self.cloud.gaps
            self._user_cloud.windows_seen = self.cloud.windows_seen
            self._user_cloud.last_reconstruction = \
                self.cloud.last_reconstruction

        nrmse = {q: Q.nrmse_table(est[q].T, tru[q].T) for q in qnames}
        nrmse_q = {q: Q.nrmse_table(est_q[q].T, tru[q].T) for q in qnames}
        total_tuples = int(sum(int(np.sum(w.counts)) for w in windows))
        return {
            "nrmse": nrmse,
            "nrmse_at_query": nrmse_q,
            "wan_bytes": self.transport.bytes_sent,
            "wan_cost": float(self.transport.bytes_cost),
            "full_bytes": total_tuples * 4,
            "plan_seconds": self.edge.plan_seconds,
            "gaps": self.cloud.gaps,
            "revisions": self.cloud.revisions,
            "late_drops": self.cloud.late_drops,
            "duplicates": self.cloud.duplicates,
            "retransmits": getattr(self.transport, "retransmits", 0),
            "window_age_ms": ages,
            "revised_windows": revised,
            "freshness_ms": freshness_percentiles(ages),
            "device_seconds": self.edge.device_seconds,
            "solve_seconds": self.edge.solve_seconds,
            "newton_steps": self.edge.newton_steps,
            "run_seconds": run_seconds,
            "windows_per_sec": T / max(run_seconds, 1e-9),
        }


# ==========================================================================
# fleet runtime (E edges against per-site clouds, on the WAN event clock)
# ==========================================================================

def _draw_real_np(rng: np.random.Generator, values: np.ndarray,
                  counts: np.ndarray, alloc: np.ndarray) -> list:
    """SRS without replacement per stream (host numpy, the reference's
    draw order: one ``permutation`` a stream with ``n_i > 0``)."""
    out = []
    for i in range(len(alloc)):
        n_i = int(min(int(alloc[i]), int(counts[i])))
        if n_i <= 0:
            out.append(np.zeros((0,), np.float32))
            continue
        idx = rng.permutation(int(counts[i]))[:n_i]
        out.append(values[i, idx].astype(np.float32))
    return out


@dataclasses.dataclass
class FleetRuntime:
    """Simulates E edge sites against their clouds for a window sequence.

    Planning goes through the engine registry: ``planning`` names the
    engine, else ``cfg.engine``, else ``"batched"``.  The plan (and, under
    ``sampling="device"``, the samples) runs on ``device``; the links,
    clouds, reconstruction, queries and controller are host numpy, as in
    the reference.  Each window is uploaded once and its plan read back
    once (plus the gate's decision under ``adaptive``).
    """

    topology: "FleetTopology"
    controller: "BudgetController"
    cfg: PlannerConfig = dataclasses.field(default_factory=PlannerConfig)
    planning: Optional[str] = None     # ENGINES name; None = cfg.engine
    use_kernel: Optional[bool] = None  # as in fleet_plan
    straggler_drop: Optional[Callable[[int, int, int], bool]] = None
    query_names: tuple = ("AVG", "VAR")
    window_period_ms: float = 1000.0   # virtual tumbling-window cadence
    staleness_deadline_ms: float = float("inf")
    sampling: str = "host"             # "host" | "device" (scan-parity RNG)
    retransmit_timeout_ms: Optional[float] = None
    max_retries: int = 0
    adaptive: Optional["AdaptiveSpec"] = None   # None = plan every window
    chaos: Optional["ChaosSpec"] = None         # None = fixed membership
    device: object = None              # None -> "cuda"

    def __post_init__(self):
        from repro_torch.streaming import AsyncTransport, ReorderCloudNode
        if self.sampling not in ("host", "device"):
            raise ValueError(f"sampling must be 'host' or 'device', got "
                             f"{self.sampling!r}")
        self.device = resolve_device(self.device)
        sites = self.topology.sites
        engine_name = self.planning or self.cfg.engine or "batched"
        self.engine = ENGINES.get(engine_name)
        self.engine.check(self.cfg)      # fail at construction, not mid-run
        from repro_torch.planning import HostEngine
        # the host engine uploads each site's window itself
        self._host_windows = isinstance(self.engine, HostEngine)
        self._adaptive_policy = None
        if self.adaptive is not None:
            if engine_name in ("host", "host_loop"):
                raise ValueError(
                    "adaptive re-planning cannot reuse host-engine plans "
                    "(plan_window draws samples inside the plan); use the "
                    "batched or sharded engine")
            from repro_torch.adaptive import AdaptivePolicy
            self._adaptive_policy = AdaptivePolicy(
                self.adaptive, use_kernel=self.use_kernel,
                device=self.device)
        # a trivial spec injects nothing: the fixed-membership loop runs
        self._chaos_active = (self.chaos is not None
                              and not self.chaos.is_trivial)
        if self._chaos_active:
            if self.adaptive is not None:
                raise ValueError(
                    "chaos and adaptive re-planning cannot be combined: "
                    "the drift gate's cached plan would replay allocations "
                    "for dead sites")
            self.chaos.validate_topology(
                self.topology.n_sites, len(self.topology.region_names))
        self.transports = [AsyncTransport(
            drop_prob=s.link.drop_prob,
            seed=self.cfg.seed + s.site_id,
            cost_per_byte=s.link.cost_per_byte,
            latency_ms=s.link.latency_ms,
            jitter_ms=s.link.jitter_ms,
            bandwidth_bytes_per_ms=s.link.bandwidth_bytes_per_ms,
            retransmit_timeout_ms=self.retransmit_timeout_ms,
            max_retries=self.max_retries)
            for s in sites]
        self.clouds = [ReorderCloudNode(query_names=self.query_names,
                                        window_period_ms=self.window_period_ms,
                                        deadline_ms=self.staleness_deadline_ms)
                       for _ in sites]
        self.plan_seconds = 0.0
        self.plan_windows = 0
        self._rng = np.random.default_rng(self.cfg.seed)

    # ---------------------------------------------------------------- plan
    def _plan(self, wid: int, values, counts, budgets: np.ndarray) -> dict:
        """One window's plan: the engine's host arrays (reference
        ``FleetPlan`` field names)."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("event_loop/plan"):
            out = self.engine.plan_fleet(values, counts, budgets, self.cfg,
                                         window_id=wid,
                                         use_kernel=self.use_kernel,
                                         device=self.device)
        self.plan_seconds += time.perf_counter() - t0
        self.plan_windows += 1
        return out

    def _payload(self, plan: dict, s: int, wid: int, values: np.ndarray,
                 counts: np.ndarray,
                 samples: Optional[np.ndarray] = None) -> EdgePayload:
        if "payloads" in plan:           # the host engine drew them already
            return plan["payloads"][s]
        from repro_torch.planning import assemble_payload
        if samples is not None:          # device sampling (scan-parity RNG)
            real = [samples[i, :int(min(int(plan["n_real"][s][i]),
                                        int(counts[i])))]
                    for i in range(len(counts))]
        else:
            real = _draw_real_np(self._rng, values, counts,
                                 plan["n_real"][s])
        return assemble_payload(MODELS.get(self.cfg.model), plan, s, wid,
                                real)

    # ----------------------------------------------------------------- run
    def run(self, fleet_windows: list) -> dict:
        """fleet_windows: list over time of (E, k, N) float arrays.

        Window ``wid`` is planned and sent at ``wid * window_period_ms``;
        each site's query is answered one period later from whatever its
        uplink has delivered by then, and late-but-within-deadline
        arrivals revise their window's entry in the (revised) estimate
        table.
        """
        E, k, n = np.asarray(fleet_windows[0]).shape
        T = len(fleet_windows)
        qnames = self.query_names
        period = self.window_period_ms
        est = {q: np.full((T, E, k), np.nan) for q in qnames}    # revised
        est_q = {q: np.full((T, E, k), np.nan) for q in qnames}  # at query
        tru = {q: np.full((T, E, k), np.nan) for q in qnames}
        ages = np.full((T, E), np.nan)
        budget_history = []
        chaos_live = None
        if self._chaos_active:
            from repro_torch.chaos import liveness_table
            chaos_live = liveness_table(self.chaos, T, E,
                                        self.topology.region_of())

        def _row(res):
            return {q: (np.asarray(res[q]) if len(res.get(q, [])) == k
                        else np.full(k, np.nan)) for q in qnames}

        def _apply(s, outcome):
            if outcome.kind == "revised":
                res = _row(self.clouds[s].query(outcome.reconstruction))
                for q in qnames:
                    est[q][outcome.window_id, s] = res[q]

        site_seconds = 0.0
        t_run = time.perf_counter()
        for wid, w in enumerate(fleet_windows):
            now = wid * period
            q_time = now + period
            w = np.asarray(w, np.float32)
            w_dev = (w if self._host_windows
                     else torch.as_tensor(w, device=self.device))
            counts = np.full((E, k), n, np.int64)
            if self.straggler_drop is not None:
                for s in range(E):
                    for i in range(k):
                        if self.straggler_drop(wid, s, i):
                            counts[s, i] = 0
            live = None if chaos_live is None else chaos_live[wid]
            if live is None:
                budgets = np.maximum(np.floor(self.controller.budgets()),
                                     2.0)
            else:
                # the >=2 clamp would resurrect dead sites' zero budgets
                budgets = np.where(
                    live,
                    np.maximum(np.floor(self.controller.budgets(live=live)),
                               2.0),
                    0.0)
            budget_history.append(budgets)
            if self._adaptive_policy is not None:
                # the gate decides whether this window pays for planning;
                # the planner callback runs only on a re-plan, so
                # plan_windows counts the planner's invocations
                plan, _ = self._adaptive_policy.step(
                    w_dev, counts,
                    lambda: self._plan(wid, w_dev, counts, budgets))
            else:
                plan = self._plan(wid, w_dev, counts, budgets)
            if live is not None and "n_real" in plan:
                # the planner floors every stream at 1 sample even on a
                # zero budget; dead sites must ship nothing (and the
                # masked n_real keeps device sampling bitwise with scan)
                plan = dict(plan)
                plan["n_real"] = np.asarray(plan["n_real"]) * live[:, None]

            fleet_samples = None
            if self.sampling == "device" and "payloads" not in plan:
                # one draw for the whole fleet, from the exact RNG streams
                # the scan runtime consumes
                from repro_torch.runtime.step import draw_fleet_samples
                fleet_samples = draw_fleet_samples(
                    self.cfg.seed, wid, w_dev, plan["n_real"],
                    device=self.device)
            t_sites = time.perf_counter()
            split_on = self.controller.query_split is not None
            obs_err = np.zeros(E)
            obs_err_tail = np.zeros(E) if split_on else None
            lag_obs = np.full(E, np.nan)
            for s in range(E):
                if live is not None and not live[s]:
                    # dark site: nothing is planned-for or sent, but in-flight
                    # payloads still land and the cloud keeps gap-serving its
                    # freshest reconstruction
                    for ev in self.transports[s].drain(q_time):
                        _apply(s, self.clouds[s].ingest_event(
                            ev.payload, now_ms=ev.at_ms))
                    rec, age, _ = self.clouds[s].serve(wid, q_time)
                    res = _row(self.clouds[s].query(rec))
                    res_true = _row(self.clouds[s].query(
                        [w[s, i] for i in range(k)]))
                    for q in qnames:
                        est[q][wid, s] = res[q]
                        est_q[q][wid, s] = res[q]
                        tru[q][wid, s] = res_true[q]
                    ages[wid, s] = age
                    # no payload => no edge-local error observation; the
                    # live-masked controller update freezes this site's demand
                    # EWMA at its pre-outage value
                    obs_err[s] = np.nan
                    if split_on:
                        obs_err_tail[s] = np.nan
                    continue
                payload = self._payload(
                    plan, s, wid, w[s], counts[s],
                    samples=(None if fleet_samples is None
                             else fleet_samples[s]))
                payload = dataclasses.replace(payload, sent_at_ms=now)
                self.transports[s].send(payload, now_ms=now)
                lags = []
                for ev in self.transports[s].drain(q_time):
                    lags.append(ev.at_ms - ev.payload.sent_at_ms)
                    _apply(s, self.clouds[s].ingest_event(ev.payload,
                                                          now_ms=ev.at_ms))
                if lags:
                    lag_obs[s] = float(np.mean(lags))
                rec, age, _ = self.clouds[s].serve(wid, q_time)
                res = _row(self.clouds[s].query(rec))
                res_true = _row(self.clouds[s].query([w[s, i]
                                                      for i in range(k)]))
                for q in qnames:
                    est[q][wid, s] = res[q]
                    est_q[q][wid, s] = res[q]
                    tru[q][wid, s] = res_true[q]
                ages[wid, s] = age
                # edge-local error proxy: the edge knows its true window and
                # its own payload, so it scores the reconstruction the cloud
                # would produce -- the controller's observation, for free
                edge_rec = reconstruct_window(payload)
                t_mean = np.asarray([np.mean(w[s, i]) for i in range(k)])
                e_mean = np.asarray([np.mean(r) if len(r) else np.nan
                                     for r in edge_rec])
                obs_err[s] = np.nanmean(np.abs(e_mean - t_mean)
                                        / np.maximum(np.abs(t_mean), 1e-6))
                if split_on:
                    # tail-query proxy (VAR/MAX) for the split tranche
                    errs = []
                    for qfn in (Q.QUERIES["VAR"], Q.QUERIES["MAX"]):
                        t_q = np.asarray([qfn(w[s, i]) for i in range(k)])
                        e_q = np.asarray([qfn(r) for r in edge_rec])
                        errs.append(np.abs(e_q - t_q)
                                    / np.maximum(np.abs(t_q), 1e-6))
                    obs_err_tail[s] = np.nanmean(np.concatenate(errs))
            site_seconds += time.perf_counter() - t_sites
            self.controller.update(obs_err, plan["r2"],
                                   objective=plan.get("objective"),
                                   arrival_lag=lag_obs,
                                   obs_err_tail=obs_err_tail, live=live)

        # drain in-flight payloads: late revisions and gap accounting
        for s in range(E):
            for ev in self.transports[s].drain(float("inf")):
                _apply(s, self.clouds[s].ingest_event(ev.payload,
                                                      now_ms=ev.at_ms))
            self.clouds[s].finalize(T)
        run_seconds = time.perf_counter() - t_run

        chaos_info = None
        if chaos_live is not None:
            from repro_torch.chaos import chaos_metrics
            chaos_info = chaos_metrics(
                chaos_live, np.asarray(budget_history, np.float64),
                self.controller.equal_share, est, tru, qnames,
                self.topology.region_of(), self.topology.region_names)

        from repro_torch.runtime.report import aggregate_fleet
        raw = aggregate_fleet(
            topology=self.topology, qnames=qnames,
            est=est, est_q=est_q, tru=tru, ages=ages,
            bytes_per_site=np.asarray([t.bytes_sent
                                       for t in self.transports], np.int64),
            cost_per_site=np.asarray([t.bytes_cost
                                      for t in self.transports]),
            gaps=sum(c.gaps for c in self.clouds),
            revisions=sum(c.revisions for c in self.clouds),
            late_drops=sum(c.late_drops for c in self.clouds),
            duplicates=sum(c.duplicates for c in self.clouds),
            retransmits=sum(t.retransmits for t in self.transports),
            arrival_lag_ms=self.controller.arrival_lag_ms,
            plan_seconds=self.plan_seconds, plan_windows=self.plan_windows,
            budget_history=np.asarray(budget_history),
            total_tuples=T * E * k * n,
            adaptive=(None if self._adaptive_policy is None
                      else self._adaptive_policy.counters()),
            chaos=chaos_info)
        raw.update(run_seconds=run_seconds, site_seconds=site_seconds,
                   windows_per_sec=T / max(run_seconds, 1e-9))
        return raw


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


def check_scan_scenario(scenario: ScenarioConfig) -> None:
    """Reject what the scan runtimes (``scan``, ``scan_steps``,
    ``scan_sharded``) can never honor (WAN timing they do not model)."""
    RUNTIMES.get(scenario.runtime)
    if scenario.method != "model":
        if scenario.method not in MODELS:
            raise ValueError(
                f"runtime='scan' plans through the model families; baseline "
                f"method {scenario.method!r} needs runtime='event'")
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
        raise ValueError("runtime='scan' does not implement the per-query "
                         "controller split; use runtime='event'")
    from repro_torch.planning.batched import BatchedEngine
    engine = ENGINES.get(scenario.planner.engine or "batched")
    if not isinstance(engine, BatchedEngine):
        raise ValueError(
            f"runtime='scan' needs the 'batched' or 'sharded' plan engine, "
            f"not {engine.name!r}")
    engine.check(scenario.planner)


def check_event_scenario(scenario: ScenarioConfig) -> None:
    """Reject what the port's event loops cannot run.  One edge plans as
    the reference's ``EdgeNode`` routes it: a baseline through
    ``plan_with_baseline``; else the host planner for ``engine`` None,
    "host" or "host_loop", else that engine's E = 1 pass."""
    RUNTIMES.get(scenario.runtime)
    DATASETS.get(scenario.data.dataset)
    for q in scenario.queries:
        QUERIES.get(q)
    planner = scenario.planner
    if scenario.is_fleet:
        ENGINES.get(planner.engine or "batched").check(planner)
        return
    if planner.engine not in (None, "host", "host_loop"):
        ENGINES.get(planner.engine).check(planner)
        return
    SOLVERS.get(planner.solver)
    MODELS.get(planner.model)
    EPSILON_POLICIES.get(planner.epsilon_policy)
    DEPENDENCE.get(planner.dependence)


def check_scenario(scenario: ScenarioConfig) -> None:
    """The check of the runtime ``scenario`` names."""
    if scenario.runtime == "event":
        check_event_scenario(scenario)
    else:
        check_scan_scenario(scenario)


@dataclasses.dataclass
class Experiment:
    """One runnable experiment, built declaratively from a scenario.

    ``straggler_drop`` is the one knob that is not serializable: a
    callable ``(wid, stream) -> bool`` (one edge) or ``(wid, site,
    stream) -> bool`` (a fleet) that zeroes a stream's count in a window
    (the event loops only).
    """

    scenario: ScenarioConfig
    runtime: object          # ScanRuntime | SingleEdgeRuntime | FleetRuntime

    @classmethod
    def from_scenario(cls, scenario: ScenarioConfig, *,
                      use_kernel: Optional[bool] = None,
                      collect: str = "payloads",
                      straggler_drop: Optional[Callable] = None,
                      device=None) -> "Experiment":
        """``use_kernel`` as in ``fleet_plan``; ``collect`` (the scan only)
        picks the payload replay or the on-device estimates;
        ``device=None`` is the GPU."""
        dev = resolve_device(device)
        if scenario.runtime != "event" and straggler_drop is not None:
            raise ValueError("runtime='scan' plans full windows only; "
                             "straggler_drop needs runtime='event'")
        check_scenario(scenario)
        if scenario.runtime == "event" and not scenario.is_fleet:
            return cls(scenario=scenario,
                       runtime=cls._single_edge(scenario, straggler_drop,
                                                dev))
        if scenario.runtime == "event":
            tspec = scenario.transport
            topo = scenario.topology.build(cls._fleet_k(scenario))
            runtime = RUNTIMES.get("event")(
                topology=topo, controller=cls._build_controller(scenario,
                                                                topo),
                cfg=scenario.planner, use_kernel=use_kernel,
                straggler_drop=straggler_drop,
                query_names=tuple(scenario.queries),
                window_period_ms=tspec.window_period_ms,
                staleness_deadline_ms=(float("inf")
                                       if tspec.staleness_deadline_ms is None
                                       else tspec.staleness_deadline_ms),
                retransmit_timeout_ms=tspec.retransmit_timeout_ms,
                max_retries=tspec.max_retries,
                adaptive=scenario.adaptive, chaos=scenario.chaos,
                device=dev)
            return cls(scenario=scenario, runtime=runtime)
        # ScanRuntime, or ShardedScanRuntime for runtime="scan_sharded"
        runtime = RUNTIMES.get(scenario.runtime).from_scenario(
            scenario, use_kernel=use_kernel, collect=collect, device=dev)
        return cls(scenario=scenario, runtime=runtime)

    @staticmethod
    def _single_edge(scenario: ScenarioConfig, straggler_drop,
                     device) -> SingleEdgeRuntime:
        """One edge, one uplink, one cloud: the E = 1 degenerate fleet.  A
        one-site topology contributes its link's WAN character; otherwise
        the transport spec describes the uplink."""
        from repro_torch.streaming import AsyncTransport, CloudNode, EdgeNode
        tspec = scenario.transport
        drop, cost, lat, jit = (tspec.drop_prob, 1.0, tspec.latency_ms,
                                tspec.jitter_ms)
        bandwidth = tspec.bandwidth_bytes_per_ms
        if scenario.topology is not None:
            link = scenario.topology.build(1).sites[0].link
            drop, cost, lat, jit = (link.drop_prob, link.cost_per_byte,
                                    link.latency_ms, link.jitter_ms)
            bandwidth = link.bandwidth_bytes_per_ms
        return SingleEdgeRuntime(
            edge=EdgeNode(cfg=scenario.planner,
                          budget_fraction=scenario.budget_fraction,
                          method=scenario.method,
                          straggler_drop=straggler_drop, device=device),
            cloud=CloudNode(query_names=tuple(scenario.queries)),
            transport=AsyncTransport(
                drop_prob=drop, seed=scenario.planner.seed,
                cost_per_byte=cost, latency_ms=lat, jitter_ms=jit,
                bandwidth_bytes_per_ms=bandwidth,
                retransmit_timeout_ms=tspec.retransmit_timeout_ms,
                max_retries=tspec.max_retries),
            window_period_ms=tspec.window_period_ms,
            staleness_deadline_ms=tspec.staleness_deadline_ms)

    @staticmethod
    def _fleet_k(scenario: ScenarioConfig) -> int:
        return int(scenario.data.options.get("k", 6))

    @staticmethod
    def _build_controller(scenario: ScenarioConfig, topo):
        """The event loop's host controller (f64), wired as the
        reference wires it."""
        from repro_torch.fleet.controller import BudgetController
        spec = scenario.controller or ControllerSpec()
        E = topo.n_sites
        total = (scenario.budget_fraction * E * topo.k
                 * scenario.data.window)
        link_cost = np.asarray([s.link.cost_per_byte for s in topo.sites])
        return BudgetController(
            total_budget=total, n_sites=E, mode=spec.mode,
            floor_mult=spec.floor_mult, ceil_mult=spec.ceil_mult,
            ewma=spec.ewma,
            link_cost=link_cost if spec.link_cost_aware else None,
            cost_aware=spec.link_cost_aware,
            demand_signal=spec.demand_signal,
            query_split=spec.query_split,
            tail_demand_signal=spec.tail_demand_signal)

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
        the pool to that many windows; ``state`` resumes the scan from a
        carry (the event loop keeps none)."""
        if windows is None:
            windows = self.make_windows()
        if isinstance(self.runtime, SingleEdgeRuntime):
            if state is not None:
                raise ValueError("the event loop keeps no carry to resume; "
                                 "state= resumes runtime='scan'")
            if n_windows is not None:
                # a cycled pool: each window keeps its place on the clock
                windows = [dataclasses.replace(windows[t % len(windows)],
                                               window_id=t)
                           for t in range(int(n_windows))]
            return _report_single(self.scenario, self.runtime.run(windows))
        if isinstance(self.runtime, FleetRuntime):
            if state is not None:
                raise ValueError("the event loop keeps no carry to resume; "
                                 "state= resumes runtime='scan'")
            if n_windows is not None:
                windows = [windows[t % len(windows)]
                           for t in range(int(n_windows))]
            return _report_fleet(self.scenario, self.runtime.run(windows),
                                 self.runtime.topology.n_sites)
        r = self.runtime.run(windows, n_windows=n_windows, state=state)
        if self.runtime.n_sites > 1:
            return _report_fleet(self.scenario, r, self.runtime.n_sites)
        return _report_single(self.scenario, r)
