"""The PlanEngine interface and payload assembly — port of
``repro.planning.engine``.

An engine plans a fleet's (E, k, N) stack (:meth:`PlanEngine.plan_fleet`)
and one window as its E = 1 case (:meth:`PlanEngine.plan_one`, which
``plan_window`` routes to for ``engine="batched"``).  The host engine
(``"host"``, alias ``"host_loop"``) plans a fleet as E independent runs
of the host planner (``core.planner._plan_window_host``) and returns the
sites' payloads, samples drawn; it is the oracle the batched engine
replaces.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.api.registry import ENGINES, MODELS
from repro_torch.core import samplers
from repro_torch.core.planner import (ModelSpec, PlanDiagnostics,
                                      _plan_window_host)
from repro_torch.core.types import (Allocation, CompactModel, EdgePayload,
                                    PlannerConfig, WindowBatch)


class UnsupportedPlanConfig(ValueError):
    """A PlannerConfig the selected engine cannot honor (raised instead of
    silently running another code path)."""

    def __init__(self, engine: str, reason: str):
        self.engine = engine
        self.reason = reason
        super().__init__(f"plan engine {engine!r} cannot run this "
                         f"PlannerConfig: {reason}")


def assemble_payload(spec: ModelSpec, plan: dict, s: int, window_id: int,
                     real_values: list) -> EdgePayload:
    """One site's plan arrays (host numpy) + drawn real samples -> payload.

    Caps n_s at what actually shipped (constraint 1d, post-draw):
    imputation is keyed to the front of the predictor's real sample (of
    both predictors' under the multi model).  Mean imputation ships no
    model; the multi model ships as a dict.
    """
    real_values = [np.asarray(v, np.float32) for v in real_values]
    pred = np.asarray(plan["predictor"][s], np.int64)
    ns = np.asarray(plan["n_imputed"][s], np.int64).copy()
    for i in range(len(ns)):
        if spec.multi:
            ns[i] = min(ns[i], len(real_values[int(pred[i, 0])]),
                        len(real_values[int(pred[i, 1])]))
        else:
            ns[i] = min(ns[i], len(real_values[int(pred[i])]))
    if spec.mean:
        model = None
    elif spec.multi:
        model = {f: np.asarray(plan[f][s])
                 for f in ("coeffs", "loc", "scale", "explained_var")}
        model["predictor"] = pred
    else:
        model = CompactModel(coeffs=plan["coeffs"][s], loc=plan["loc"][s],
                             scale=plan["scale"][s],
                             explained_var=plan["explained_var"][s],
                             predictor=pred)
    return EdgePayload(
        window_id=int(window_id),
        n_real=np.asarray([len(v) for v in real_values], np.int64),
        n_imputed=ns,
        real_values=real_values,
        model=model,
        mean_imputation=spec.mean,
        predictor=pred,
        stats_digest={"mean": np.asarray(plan["mean"][s]),
                      "var": np.asarray(plan["var"][s])})


class PlanEngine:
    """Interface every registered plan engine implements."""

    name: str = "?"

    def check(self, cfg: PlannerConfig) -> None:
        """Raise :class:`UnsupportedPlanConfig` if ``cfg`` needs a feature
        this engine does not implement."""

    def plan_fleet(self, values, counts, budgets, cfg: PlannerConfig, *,
                   window_id: int = 0, use_kernel=None, device=None) -> dict:
        """(E, k, N) windows + per-site budgets -> host numpy plan arrays."""
        raise NotImplementedError

    def plan_one(self, batch: WindowBatch, budget: float, cfg: PlannerConfig,
                 key: Optional[tuple] = None, device=None
                 ) -> tuple[EdgePayload, PlanDiagnostics]:
        """One window through the engine — the degenerate E = 1 fleet;
        the samples are drawn as the host planner draws them."""
        self.check(cfg)
        if key is None:
            from repro_torch.runtime.threefry import prng_key
            key = prng_key(cfg.seed ^ int(batch.window_id))
        values = np.asarray(batch.values)
        counts = np.asarray(batch.counts)
        plan = self.plan_fleet(values[None], counts[None],
                               np.asarray([budget], np.float32), cfg,
                               window_id=int(batch.window_id), device=device)
        spec = MODELS.get(cfg.model)
        real_values = samplers.draw_samples(key, values, counts,
                                            plan["n_real"][0], device=device)
        payload = assemble_payload(spec, plan, 0, int(batch.window_id),
                                   real_values)
        # feasibility as the host closed form reports it: spend within the
        # model-upload-net budget (the >=1-sample floor can overshoot it)
        spent = float(np.sum(plan["n_real"][0]))
        budget_net = spec.budget_net(float(budget), len(counts))
        alloc = Allocation(
            n_real=np.asarray(plan["n_real"][0], np.int32),
            n_imputed=np.asarray(plan["n_imputed"][0], np.int32),
            objective=np.float32(plan["objective"][0]),
            feasible=bool(spent <= budget_net + 1e-6),
            eps_used=np.asarray(plan["eps"][0], np.float32))
        diag = PlanDiagnostics(stats=None, allocation=alloc,
                               eps=np.asarray(plan["eps"][0]), strides=None,
                               predictor=payload.predictor,
                               solver_feasible=alloc.feasible)
        return payload, diag


class HostEngine(PlanEngine):
    """E independent host-planner round trips — the oracle and baseline.

    Every site of a window draws with the planner's default key,
    ``prng_key(cfg.seed ^ window_id)``, as the reference's does.  Each
    site's window is uploaded to ``device`` and read back once."""

    name = "host"

    def plan_fleet(self, values, counts, budgets, cfg, *, window_id=0,
                   use_kernel=None, device=None) -> dict:
        """``{"payloads": [E payloads], "r2": (E,)}``: each site's mean
        explained-variance share (0 under mean imputation)."""
        values = np.asarray(values, np.float32)
        e = values.shape[0]
        payloads, r2 = [], np.zeros(e)
        for s in range(e):
            batch = WindowBatch.from_numpy(values[s], counts[s], window_id)
            payload, _ = _plan_window_host(batch, float(budgets[s]), cfg,
                                           device=device)
            payloads.append(payload)
            if payload.model is not None:
                ev = np.asarray(payload.model["explained_var"]
                                if isinstance(payload.model, dict)
                                else payload.model.explained_var)
                var = np.maximum(payload.stats_digest["var"], 1e-12)
                r2[s] = float(np.mean(np.clip(ev / var, 0.0, 1.0)))
        return {"payloads": payloads, "r2": r2}

    def plan_one(self, batch, budget, cfg, key=None, device=None):
        return _plan_window_host(batch, budget, cfg, key, device)


HOST_ENGINE = HostEngine()
ENGINES.register("host", HOST_ENGINE, aliases=("host_loop",))


def host_loop_plan(values: np.ndarray, counts: np.ndarray,
                   budgets: np.ndarray, cfg: PlannerConfig, device=None):
    """The path the batched engine replaces, as stacked (E, k) arrays:
    (n_real, n_imputed, predictor)."""
    out = HOST_ENGINE.plan_fleet(values, counts, budgets, cfg,
                                 device=device)
    payloads = out["payloads"]
    return (np.stack([p.n_real for p in payloads]),
            np.stack([p.n_imputed for p in payloads]),
            np.stack([p.predictor for p in payloads]))
