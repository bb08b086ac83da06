"""ScanRuntime — the fleet streaming engine on the card.

Port of ``repro.runtime.scan.ScanRuntime`` for fleets.  The reference
stacks the windows into one device pool and runs the per-window cycle as
one ``lax.scan``; PyTorch has no scan, so the port loops over the windows
in Python and updates the carry in place.  ``mode="scan"`` and
``mode="steps"`` (the reference's incremental cadence) are therefore the
same loop.

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
    """Fleet scan runtime; zero-latency WAN semantics."""

    cfg: "PlannerConfig"
    ctrl: CtrlParams
    topology: "FleetTopology"
    query_names: tuple = ("AVG", "VAR")
    mode: str = "scan"                 # "scan" | "steps"
    collect: str = "payloads"          # "payloads" | "estimates"
    use_kernel: Optional[bool] = None
    device: object = None              # None -> "cuda"

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
        if self.topology is None or self.topology.n_sites < 2:
            raise NotImplementedError(
                "single-edge (E=1) scans are not ported to repro_torch yet "
                "(ROADMAP.md: queue 1, 'Single-edge scans')")
        self.device = resolve_device(self.device)
        self.engine = ENGINES.get(self.cfg.engine or "batched")
        self.engine.check(self.cfg)
        self.spec = MODELS.get(self.cfg.model)
        self.n_sites = self.topology.n_sites
        self._cost = np.asarray([s.link.cost_per_byte
                                 for s in self.topology.sites])

    @classmethod
    def from_scenario(cls, scenario, *, use_kernel=None,
                      collect: str = "payloads", device=None) -> "ScanRuntime":
        """Build from a fleet ScenarioConfig with ``runtime="scan"`` or
        ``"scan_steps"`` (the same budget wiring as the reference)."""
        from repro_torch.api.scenario import ControllerSpec
        spec = scenario.controller or ControllerSpec()
        mode = "steps" if scenario.runtime == "scan_steps" else "scan"
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
                   collect=collect, use_kernel=use_kernel, device=device)

    def _plan_fn(self, values, counts, budgets):
        # full windows: every count is the window length, a constant of
        # the step (as the reference compiles it)
        return self.engine.run(values, counts, budgets, self.cfg,
                               use_kernel=self.use_kernel,
                               n_static=values.shape[-1])

    def _static_exec(self) -> Optional[tuple]:
        """Executed budgets when they are window-invariant (static mode),
        computed on the host in f64 as the event loop computes them."""
        if self.ctrl.mode == "static":
            eq = self.ctrl.equal_share
            b = np.minimum(np.full(self.n_sites, eq),
                           np.full(self.n_sites, self.ctrl.ceil_mult * eq))
            return tuple(np.maximum(np.floor(b), 2.0).tolist())
        return None                    # rebalance: budgets live on device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, windows, n_windows: Optional[int] = None, *,
            state: Optional[RuntimeState] = None,
            first_window: Optional[int] = None) -> dict:
        """windows: list of (E, k, N) arrays.

        ``n_windows`` extends the run past the pool by cycling it (window
        ``wid`` reads slot ``wid % P``).  ``state``/``first_window`` resume
        from a carry (see :func:`~repro_torch.runtime.state.state_from_numpy`);
        window ids start at ``first_window``, default ``state.window_id``.
        The passed state is updated in place.
        """
        pool_np = np.stack([np.asarray(w, np.float32) for w in windows])
        P, _, k, n = pool_np.shape
        T = int(n_windows) if n_windows is not None else P
        if state is None:
            state = init_state(self.n_sites, k, float(self.ctrl.equal_share),
                               device=self.device)
            w0 = int(first_window) if first_window is not None else 0
        else:
            w0 = (int(first_window) if first_window is not None
                  else int(state.window_id))
        pool = torch.as_tensor(pool_np, device=self.device)
        step = make_window_step(
            pool, seed=self.cfg.seed, plan_fn=self._plan_fn,
            qnames=self.query_names, ctrl=self.ctrl,
            static_exec_budgets=self._static_exec(), collect=self.collect)

        self._sync()
        t0 = time.perf_counter()
        outs = [step(state, w) for w in range(w0, w0 + T)]
        self._sync()
        scan_seconds = time.perf_counter() - t0
        ys = _stack_outputs(outs)
        host_state = state_to_numpy(state)

        if self.collect == "payloads":
            est, tru, bytes_site, cost_site = self._replay(ys, pool_np, T,
                                                           w0=w0)
        else:
            est = {q: np.asarray(ys["est"][q], np.float64)
                   for q in self.query_names}
            tru = {q: np.asarray(ys["tru"][q], np.float64)
                   for q in self.query_names}
            bytes_site = ys["bytes"].astype(np.int64).sum(axis=0)
            cost_site = bytes_site * self._cost

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
        from repro_torch.runtime.report import aggregate_fleet
        raw = aggregate_fleet(
            topology=self.topology, qnames=self.query_names,
            est=est, est_q=est, tru=tru, ages=np.zeros((T, self.n_sites)),
            bytes_per_site=bytes_site, cost_per_site=cost_site,
            gaps=0, revisions=0, late_drops=0, duplicates=0,
            arrival_lag_ms=np.asarray(host_state.controller.lag, np.float64),
            plan_seconds=scan_seconds, plan_windows=T,
            budget_history=ys["budgets"],
            total_tuples=T * self.n_sites * k * n)
        raw.update(extras)
        return raw

    def _replay(self, ys, pool_np, T, w0: int = 0):
        """Host replay of the collected payloads through the event path's
        assemble/reconstruct/query code (host numpy).  Output row ``t``
        holds window ``w0 + t``, which read pool slot ``(w0 + t) % P``."""
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
        for t in range(T):
            plan_t = {f: ys[f][t] for f in PAYLOAD_PLAN_FIELDS}
            vals = pool_np[(w0 + t) % P]
            for s in range(E):
                real = [samples[t, s, i, :int(plan_t["n_real"][s, i])]
                        for i in range(k)]
                payload = assemble_payload(self.spec, plan_t, s, w0 + t, real)
                nb = payload.wan_bytes()
                bytes_site[s] += nb
                cost_site[s] += nb * self._cost[s]
                rec = reconstruct_window(payload)
                for q in qnames:
                    fn = Q.QUERIES[q]
                    est[q][t, s] = [fn(r) for r in rec]
                    tru[q][t, s] = [fn(vals[s, i]) for i in range(k)]
        return est, tru, bytes_site, cost_site


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
