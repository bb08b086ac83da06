"""ScanRuntime — the streaming engine on the card, for a fleet or one edge.

Port of ``repro.runtime.scan.ScanRuntime``.  The reference stacks the
windows into one device pool and runs the per-window cycle as one
``lax.scan``; PyTorch has no scan, so the port loops over the windows in
Python and updates the carry in place.  ``mode="scan"`` and
``mode="steps"`` (the reference's incremental cadence) are therefore the
same loop.  A single edge (no topology) is the same step over a one-site
pool, with a static budget and the permutation sampler.

Two result fidelities, as in the reference:

  * ``collect="payloads"`` — each window's samples and plan arrays come
    back to the host and are replayed through ``assemble_payload`` /
    ``reconstruct_window`` / the query functions (host numpy).
  * ``collect="estimates"`` — the queries are answered on the device in
    f32 and only (T, E, k) tables come back; the throughput mode.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.registry import ENGINES, MODELS
from repro_torch.core import queries as Q
from repro_torch.runtime.controller import CtrlParams
from repro_torch.runtime.state import (RuntimeState, init_state,
                                       state_to_numpy)
from repro_torch.runtime.step import (PAYLOAD_PLAN_FIELDS, SCAN_QUERIES,
                                      make_window_step)


@dataclasses.dataclass
class ScanRuntime:
    """Scan runtime for a fleet or one edge; zero-latency WAN semantics."""

    cfg: "PlannerConfig"
    ctrl: CtrlParams
    topology: Optional["FleetTopology"] = None   # None => single edge
    query_names: tuple = ("AVG", "VAR")
    mode: str = "scan"                 # "scan" | "steps"
    collect: str = "payloads"          # "payloads" | "estimates"
    method: str = "model"              # single edge: "model" | model name
    budget_fraction: float = 0.25      # single edge: per-window budget
    use_kernel: Optional[bool] = None
    device: object = None              # None -> "cuda"
    adaptive: Optional["AdaptiveSpec"] = None   # None = plan every window
    chaos: Optional["ChaosSpec"] = None         # None = fixed membership

    def __post_init__(self):
        if self.mode not in ("scan", "steps"):
            raise ValueError(f"mode must be 'scan' or 'steps', got "
                             f"{self.mode!r}")
        if self.collect not in ("payloads", "estimates"):
            raise ValueError(f"collect must be 'payloads' or 'estimates', "
                             f"got {self.collect!r}")
        for q in self.query_names:
            if q not in SCAN_QUERIES:
                raise ValueError(
                    f"query {q!r} has no on-device mirror; the scan runtime "
                    f"supports {SCAN_QUERIES}")
        cfg = self.cfg
        if self.method != "model":
            if self.method not in MODELS:
                raise ValueError(
                    f"method {self.method!r}: the scan runtime plans through "
                    f"the model families ('model' or {MODELS.names()}); "
                    f"baselines need runtime='event'")
            cfg = dataclasses.replace(cfg, model=self.method)
        self.cfg_eff = cfg
        self.device = resolve_device(self.device)
        from repro_torch.planning.batched import BatchedEngine
        self.engine = ENGINES.get(cfg.engine or "batched")
        if not isinstance(self.engine, BatchedEngine):
            raise ValueError(
                f"engine {self.engine.name!r} cannot run inside the scan; "
                f"the scan runtime needs the 'batched' or 'sharded' engine")
        self.engine.check(cfg)
        if self.adaptive is not None and self.topology is None:
            raise ValueError("adaptive re-planning requires a fleet "
                             "topology (>1 site); single-edge scans plan "
                             "per window by construction")
        if self.chaos is not None and self.topology is None:
            raise ValueError("chaos fault injection requires a fleet "
                             "topology; a single edge has no membership "
                             "to vary")
        # a trivial spec injects nothing: the step runs unmasked
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
        self.spec = MODELS.get(cfg.model)
        if self.topology is None:
            self.n_sites = 1
            self._cost = np.ones(1)
        else:
            self.n_sites = self.topology.n_sites
            self._cost = np.asarray([s.link.cost_per_byte
                                     for s in self.topology.sites])
        # site rows this process's step carries: the fleet here; one
        # rank's share of the padded fleet in the sharded runtime
        self._rows = self.n_sites

    @classmethod
    def from_scenario(cls, scenario, *, use_kernel=None,
                      collect: str = "payloads", device=None) -> "ScanRuntime":
        """Build from a ScenarioConfig with ``runtime="scan"`` or
        ``"scan_steps"`` (the same budget wiring as the reference)."""
        from repro_torch.api.scenario import ControllerSpec
        spec = scenario.controller or ControllerSpec()
        mode = "steps" if scenario.runtime == "scan_steps" else "scan"
        if not scenario.is_fleet:
            # one edge: the controller is inert (one site, static budget);
            # a one-site topology contributes its link's cost per byte
            rt = cls(cfg=scenario.planner,
                     ctrl=CtrlParams(total_budget=1.0, n_sites=1,
                                     mode="static"),
                     query_names=tuple(scenario.queries), mode=mode,
                     collect=collect, method=scenario.method,
                     budget_fraction=scenario.budget_fraction,
                     use_kernel=use_kernel, device=device)
            if scenario.topology is not None:
                link = scenario.topology.build(1).sites[0].link
                rt._cost = np.asarray([link.cost_per_byte])
            return rt
        k = int(scenario.data.options.get("k", 6))
        topo = scenario.topology.build(k)
        E = topo.n_sites
        total = scenario.budget_fraction * E * topo.k * scenario.data.window
        discount = None
        if spec.link_cost_aware:
            discount = CtrlParams.make_cost_discount(
                [s.link.cost_per_byte for s in topo.sites])
        ctrl = CtrlParams(total_budget=total, n_sites=E, mode=spec.mode,
                          floor_mult=spec.floor_mult,
                          ceil_mult=spec.ceil_mult, ewma=spec.ewma,
                          demand_signal=spec.demand_signal,
                          cost_discount=discount)
        return cls(cfg=scenario.planner, ctrl=ctrl, topology=topo,
                   query_names=tuple(scenario.queries), mode=mode,
                   collect=collect, use_kernel=use_kernel, device=device,
                   adaptive=scenario.adaptive, chaos=scenario.chaos)

    def _n_static(self, values) -> Optional[int]:
        """The counts' constant, where the reference folds it.  Full
        windows: every count is the window length, a constant of the step
        that the reference's compiler folds -- except inside the adaptive
        gate's lax.cond, whose branch takes the counts as an operand
        (data); "always" at interval 1 plans unwrapped."""
        ad = self.adaptive
        folded = ad is None or (ad.detector == "always"
                                and int(ad.min_replan_interval) == 1)
        return values.shape[-1] if folded else None

    def _plan_fn(self, values, counts, budgets):
        return self.engine.run(values, counts, budgets, self.cfg_eff,
                               use_kernel=self.use_kernel,
                               n_static=self._n_static(values))

    def _static_exec(self, k: int, n: int) -> Optional[tuple]:
        """Executed budgets when they are window-invariant (one edge, or
        static mode), computed on the host in f64 as the event loop
        computes them."""
        if self.topology is None:
            return (float(max(int(self.budget_fraction * k * n), 2)),)
        if self.ctrl.mode == "static":
            eq = self.ctrl.equal_share
            b = np.minimum(np.full(self.n_sites, eq),
                           np.full(self.n_sites, self.ctrl.ceil_mult * eq))
            return tuple(np.maximum(np.floor(b), 2.0).tolist())
        return None                    # rebalance: budgets live on device

    def _liveness_table(self, T: int, w0: int) -> Optional[np.ndarray]:
        """(T, E) bool membership of windows w0 .. w0 + T - 1, or None (all
        live).  Absolute window ids key it, so a resumed run slices it."""
        if not self._chaos_active:
            return None
        from repro_torch.chaos import liveness_table
        return liveness_table(self.chaos, T, self.n_sites,
                              self.topology.region_of(), first_window=w0)

    # The sharded runtime (runtime/sharded.py) reuses run() and
    # specializes these seams: the executed budgets, the state, the
    # liveness mask and the pool as the step holds them (this process's
    # rows), the plan, and the outputs and state as they leave the run.

    def _step_exec(self, static_exec: Optional[tuple]):
        return static_exec

    def _adopt_state(self, state: RuntimeState) -> RuntimeState:
        """A given (resumed) state as the step carries it."""
        return state

    def _step_liveness(self, live_tbl: Optional[np.ndarray], T: int,
                       w0: int) -> Optional[np.ndarray]:
        """The (T, rows) mask the step applies, or None (no mask)."""
        return live_tbl

    def _step_pool(self, pool_np: np.ndarray) -> np.ndarray:
        return pool_np

    def _step_kwargs(self) -> dict:
        return {}

    def _finalize(self, ys: dict, state: RuntimeState, live_tbl):
        """(ys, final state, liveness table) of the whole fleet."""
        return ys, state, live_tbl

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, windows, n_windows: Optional[int] = None, *,
            state: Optional[RuntimeState] = None,
            first_window: Optional[int] = None) -> dict:
        """windows: list of (E, k, N) arrays (fleet) or of
        :class:`~repro_torch.core.types.WindowBatch` (one edge; full
        windows only).

        ``n_windows`` extends the run past the pool by cycling it (window
        ``wid`` reads slot ``wid % P``).  ``state``/``first_window`` resume
        from a carry (see :func:`~repro_torch.runtime.state.state_from_numpy`);
        window ids start at ``first_window``, default ``state.window_id``.
        The passed state is updated in place.  On an adaptive run a state
        without an adaptive carry gets a fresh one (the first window
        plans); on a chaos run a state without a chaos carry gets a fresh
        one (everyone live, nothing served yet).
        """
        single = self.topology is None
        if single:
            for w in windows:
                if not np.all(np.asarray(w.counts) == w.values.shape[-1]):
                    raise ValueError("the scan runtime requires full "
                                     "windows (every count N)")
            pool_np = np.stack([np.asarray(w.values, np.float32)
                                for w in windows])[:, None]
        else:
            pool_np = np.stack([np.asarray(w, np.float32) for w in windows])
        P, _, k, n = pool_np.shape
        T = int(n_windows) if n_windows is not None else P
        static_exec = self._static_exec(k, n)
        eq = static_exec[0] if single else self.ctrl.equal_share
        given = state
        if state is None:
            state = init_state(self._rows, k, float(eq), device=self.device)
            w0 = int(first_window) if first_window is not None else 0
        else:
            w0 = (int(first_window) if first_window is not None
                  else int(state.window_id))
            state = self._adopt_state(state)
        if self.adaptive is not None and state.adaptive is None:
            from repro_torch.adaptive import make_adaptive_carry
            state.adaptive = make_adaptive_carry(self._rows, k,
                                                 device=self.device)
        live_tbl = self._liveness_table(T, w0)
        step_live = self._step_liveness(live_tbl, T, w0)
        if step_live is None:
            xs = list(range(w0, w0 + T))
        else:
            if state.chaos is None:
                from repro_torch.chaos import make_chaos_carry
                state.chaos = make_chaos_carry(self._rows, k,
                                               self.query_names,
                                               device=self.device)
            live = torch.as_tensor(step_live, device=self.device)
            xs = [(w0 + t, live[t]) for t in range(T)]
        pool = torch.as_tensor(self._step_pool(pool_np), device=self.device)
        step = make_window_step(
            pool, seed=self.cfg_eff.seed, plan_fn=self._plan_fn,
            qnames=self.query_names, multi=self.spec.multi,
            mean=self.spec.mean, ctrl=self.ctrl,
            static_exec_budgets=self._step_exec(static_exec),
            collect=self.collect, adaptive=self.adaptive,
            use_kernel=self.use_kernel, chaos=step_live is not None,
            **self._step_kwargs())

        self._sync()
        t0 = time.perf_counter()
        outs = [step(state, x) for x in xs]
        self._sync()
        scan_seconds = time.perf_counter() - t0
        ys, state, live_tbl = self._finalize(_stack_outputs(outs), state,
                                             live_tbl)
        if given is not None and given is not state:
            # the passed state is updated in place, as the step updates it
            for f in dataclasses.fields(state):
                setattr(given, f.name, getattr(state, f.name))
            state = given
        host_state = state_to_numpy(state)

        if self.collect == "payloads":
            est, tru, bytes_site, cost_site = self._replay(
                ys, pool_np, T, windows, w0=w0, live_tbl=live_tbl)
        else:
            est = {q: np.asarray(ys["est"][q], np.float64)
                   for q in self.query_names}
            tru = {q: np.asarray(ys["tru"][q], np.float64)
                   for q in self.query_names}
            bytes_site = ys["bytes"].astype(np.int64).sum(axis=0)
            cost_site = bytes_site * self._cost
            if single:
                est = {q: v[:, 0] for q, v in est.items()}
                tru = {q: v[:, 0] for q, v in tru.items()}

        extras = {
            "final_state": state,
            "scan_seconds": scan_seconds,
            "windows_per_sec": T / max(scan_seconds, 1e-9),
            "mode": self.mode,
            "collect": self.collect,
            "device": str(self.device),
            "stream_totals": {"count": host_state.totals.count,
                              "s1": host_state.totals.s1,
                              "s2": host_state.totals.s2},
            "controller_demand": host_state.controller.demand,
            "plan_raw": {f: ys[f] for f in
                         ("budgets", "obs_err", "r2", "objective")},
            "bytes_history": ys["bytes"],
        }
        if single:
            return self._result_single(est, tru, bytes_site, cost_site, T,
                                       k, n, scan_seconds, extras)
        from repro_torch.runtime.report import aggregate_fleet
        ad = None
        if self.adaptive is not None:
            from repro_torch.adaptive import gate_counters
            ad = gate_counters(state.adaptive.gate)
        gaps, chaos_info = 0, None
        if live_tbl is not None:
            from repro_torch.chaos import chaos_metrics
            gaps = int((~live_tbl).sum())
            chaos_info = chaos_metrics(
                live_tbl, np.asarray(ys["budgets"], np.float64),
                self.ctrl.equal_share, est, tru, self.query_names,
                self.topology.region_of(), self.topology.region_names)
        raw = aggregate_fleet(
            topology=self.topology, qnames=self.query_names,
            est=est, est_q=est, tru=tru, ages=np.zeros((T, self.n_sites)),
            bytes_per_site=bytes_site, cost_per_site=cost_site,
            gaps=gaps, revisions=0, late_drops=0, duplicates=0,
            arrival_lag_ms=np.asarray(host_state.controller.lag, np.float64),
            plan_seconds=scan_seconds,
            plan_windows=T if ad is None else ad["planner_invocations"],
            budget_history=ys["budgets"],
            total_tuples=T * self.n_sites * k * n, adaptive=ad,
            chaos=chaos_info)
        raw.update(extras)
        return raw

    def _replay(self, ys, pool_np, T, windows, w0: int = 0, live_tbl=None):
        """Host replay of the collected payloads through the event path's
        assemble/reconstruct/query code (host numpy).  Output row ``t``
        holds window ``w0 + t``, which read pool slot ``(w0 + t) % P``.
        One edge's truth comes from its original windows' values, as the
        event path computes it.

        ``live_tbl`` (chaos runs): a dead (window, site) cell assembles no
        payload, so ships no bytes, and is served from the site's last live
        reconstruction (NaN before its first live window)."""
        from repro_torch.core.reconstruct import reconstruct_window
        from repro_torch.planning.engine import assemble_payload
        E, k = self.n_sites, pool_np.shape[2]
        P = pool_np.shape[0]
        qnames = self.query_names
        est = {q: np.full((T, E, k), np.nan) for q in qnames}
        tru = {q: np.full((T, E, k), np.nan) for q in qnames}
        bytes_site = np.zeros(E, np.int64)
        cost_site = np.zeros(E, np.float64)
        samples = ys["samples"]
        last_rec = [None] * E          # gap-serving memory (chaos only)
        for t in range(T):
            plan_t = {f: ys[f][t] for f in PAYLOAD_PLAN_FIELDS}
            vals = pool_np[(w0 + t) % P]
            for s in range(E):
                if live_tbl is not None and not live_tbl[t, s]:
                    for q in qnames:
                        fn = Q.QUERIES[q]
                        if last_rec[s] is not None:
                            est[q][t, s] = [fn(r) for r in last_rec[s]]
                        tru[q][t, s] = [fn(vals[s, i]) for i in range(k)]
                    continue
                real = [samples[t, s, i, :int(plan_t["n_real"][s, i])]
                        for i in range(k)]
                payload = assemble_payload(self.spec, plan_t, s, w0 + t, real)
                nb = payload.wan_bytes()
                bytes_site[s] += nb
                cost_site[s] += nb * self._cost[s]
                rec = reconstruct_window(payload)
                if live_tbl is not None:
                    last_rec[s] = rec
                if self.topology is None:
                    w = windows[(w0 + t) % P]
                    true_rows = [np.asarray(w.values[i, :int(w.counts[i])])
                                 for i in range(k)]
                else:
                    true_rows = [vals[s, i] for i in range(k)]
                for q in qnames:
                    fn = Q.QUERIES[q]
                    est[q][t, s] = [fn(r) for r in rec]
                    tru[q][t, s] = [fn(r) for r in true_rows]
        if self.topology is None:
            est = {q: v[:, 0] for q, v in est.items()}
            tru = {q: v[:, 0] for q, v in tru.items()}
        return est, tru, bytes_site, cost_site

    def _result_single(self, est, tru, bytes_site, cost_site, T, k, n,
                       scan_seconds, extras) -> dict:
        """One edge's result dict: (k,) NRMSE per query over T windows."""
        from repro_torch.runtime.report import freshness_percentiles
        ages = np.zeros(T)             # zero latency: served the moment due
        nrmse = {q: Q.nrmse_table(est[q].T, tru[q].T)
                 for q in self.query_names}
        return {
            "nrmse": nrmse,
            "nrmse_at_query": dict(nrmse),
            "wan_bytes": int(bytes_site.sum()),
            "wan_cost": float(cost_site.sum()),
            "full_bytes": T * k * n * 4,
            "plan_seconds": scan_seconds,
            "gaps": 0, "revisions": 0, "late_drops": 0, "duplicates": 0,
            "retransmits": 0,
            "window_age_ms": ages,
            "revised_windows": np.zeros(T, bool),
            "freshness_ms": freshness_percentiles(ages),
            **extras,
        }


def _stack_outputs(outs: list) -> dict:
    """Per-window output dicts of tensors -> dict of (T, ...) host arrays."""
    ys = {}
    for key, v in outs[0].items():
        if isinstance(v, dict):
            ys[key] = {q: torch.stack([o[key][q] for o in outs]).cpu().numpy()
                       for q in v}
        else:
            ys[key] = torch.stack([o[key] for o in outs]).cpu().numpy()
    return ys
