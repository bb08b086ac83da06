"""Batched Algorithm-1 planning for a whole fleet — port of
``repro.planning.batched``.

The fleet's windows are one ``(E, k, N)`` tensor and every stage runs on
all sites at once: window statistics from one ``stream_stats_fleet`` pass
over the values (and one over the ranks under Spearman), predictor
selection, the compact-model fit (one ``polyfit`` launch over all E·k rows
under ``use_kernel=True``), the epsilon policy and the closed-form solver.
Where the reference vmaps over sites, the port writes the batch dimension
out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import repro_torch.core.planner  # noqa: F401  — fills the MODELS registry
from repro_torch import resolve_device
from repro_torch.api.registry import DEPENDENCE, ENGINES, EPSILON_POLICIES, MODELS
from repro_torch.core import epsilon as eps_mod
from repro_torch.core import solver as solver_mod
from repro_torch.core import stats as stats_mod
from repro_torch.core.stats import ipow
from repro_torch.core.types import PlannerConfig, Tensor
from repro_torch.kernels.stream_stats.ops import fleet_window_moments_xxt
from repro_torch.planning.engine import PlanEngine, UnsupportedPlanConfig

_INT_FIELDS = ("n_real", "n_imputed")


@dataclasses.dataclass
class FleetPlan:
    """One window's plan for all E sites (every tensor leads with E).

    ``predictor`` is int64 (torch's gather index type); the reference
    carries int32.  The other integer fields are int32 as there.
    """

    n_real: Tensor          # (E, k) i32
    n_imputed: Tensor       # (E, k) i32
    predictor: Tensor       # (E, k) i64
    coeffs: Tensor          # (E, k, 4) compact-model coefficients
    loc: Tensor             # (E, k)
    scale: Tensor           # (E, k)
    explained_var: Tensor   # (E, k) V_i
    mean: Tensor            # (E, k) stats digest
    var: Tensor             # (E, k)
    eps: Tensor             # (E, k) bias tolerance used
    objective: Tensor       # (E,) relaxed eq.-2 value at the allocation
    r2: Tensor              # (E,) mean V_i / sigma_i^2

    @classmethod
    def from_numpy(cls, arrays: dict, device=None) -> "FleetPlan":
        """A reference plan (``BatchedEngine.plan_fleet``'s dict, or
        ``np.asarray`` of a reference ``FleetPlan``'s fields) as tensors."""
        dev = resolve_device(device)
        out = {}
        for f in dataclasses.fields(cls):
            a = np.array(arrays[f.name])     # a writable host copy
            if f.name in _INT_FIELDS:
                dt = torch.int32
            elif f.name == "predictor":
                dt = torch.int64
            else:
                dt = torch.float32
            out[f.name] = torch.as_tensor(a, dtype=dt, device=dev)
        return cls(**out)

    def to_numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}


def fleet_plan(values: Tensor, counts: Tensor, budgets: Tensor,
               epsilon_scale: float = 1.0, *, dependence: str = "spearman",
               model: str = "cubic", epsilon_policy: str = "k_se",
               use_kernel=None, n_static=None) -> FleetPlan:
    """values (E, k, N) f32, counts (E, k) int, budgets (E,) f32.

    ``use_kernel``: None runs the stream_stats kernel for CUDA tensors and
    keeps the fit on the legacy path; True also routes the fit through the
    polyfit kernel; False keeps the plain versions everywhere.  CPU
    tensors always take the plain versions.

    ``n_static``: every count equals this window length, fixed when the
    caller was built (the scan runtime).  The reference compiles such
    counts as constants, which changes how its statistics round; see
    :func:`~repro_torch.core.stats.stats_from_sums`.
    """
    spec = MODELS.get(model)
    EPSILON_POLICIES.get(epsilon_policy)
    DEPENDENCE.get(dependence)
    e, k, n_max = values.shape
    cf = counts.to(values.dtype)
    mask = (torch.arange(n_max, device=values.device)
            < cf[..., None]).to(values.dtype)
    xm = values * mask

    mom, xxt = fleet_window_moments_xxt(xm, use_kernel=use_kernel)
    stats = stats_mod.stats_from_sums(mom, xxt, counts, n_static=n_static)
    if dependence == "spearman":
        ranks = stats_mod.rank_transform(values, counts)
        rmom, rxxt = fleet_window_moments_xxt(ranks * mask,
                                              use_kernel=use_kernel)
        corr = stats_mod.corr_from_sums(rmom, rxxt, counts)
    else:
        corr = stats.corr

    # predictor selection + compact models (§IV-A/B) for every site at once
    predictor = spec.select(corr)
    fitted = spec.fit(values, counts, predictor, use_kernel=use_kernel,
                      n_static=n_static)

    # epsilon policy (§IV-C)
    eps = eps_mod.make_epsilon(epsilon_policy, stats, epsilon_scale)

    weights = 1.0 / torch.clamp(torch.abs(stats.mean), min=1e-6)
    sigma2 = torch.clamp(stats.var, min=1e-12)
    v_exp = torch.minimum(torch.clamp(fitted.explained_var, min=0.0),
                          sigma2 * (1.0 - 1e-9))
    q = ipow(weights, 2) * sigma2
    budget_net = spec.budget_net(budgets, k).to(values.dtype)
    cost = torch.ones_like(q)

    nr, ns, obj = solver_mod.closed_form_alloc(q, cost, cf, sigma2, v_exp,
                                               eps, budget_net, predictor)

    if epsilon_policy == "exact_mse":
        # appendix-B post-hoc cap, closed form (epsilon.exact_mse_shrink)
        nrf, nsf = nr.to(values.dtype), ns.to(values.dtype)
        cap = eps_mod.exact_mse_cap(stats, nrf, nsf, nrf + nsf)
        ns = eps_mod.exact_mse_shrink(nrf, nsf, sigma2, v_exp,
                                      cap).to(ns.dtype)

    return FleetPlan(n_real=nr, n_imputed=ns, predictor=predictor,
                     coeffs=fitted.coeffs, loc=fitted.loc, scale=fitted.scale,
                     explained_var=fitted.explained_var,
                     mean=stats.mean, var=stats.var, eps=eps,
                     objective=obj, r2=(v_exp / sigma2).mean(-1))


class BatchedEngine(PlanEngine):
    """One batched (E, k, N) pass; the fleet production path."""

    name = "batched"

    def check(self, cfg: PlannerConfig) -> None:
        MODELS.get(cfg.model)
        EPSILON_POLICIES.get(cfg.epsilon_policy)
        DEPENDENCE.get(cfg.dependence)
        if cfg.solver != "closed_form":
            raise NotImplementedError(
                f"solver {cfg.solver!r} is host-only; the batched pass "
                f"implements 'closed_form', and the host engine is not "
                f"ported to repro_torch yet (ROADMAP.md: queue 1, "
                f"'Event path')")
        if cfg.iid_mode not in ("none", "iid"):
            raise UnsupportedPlanConfig(
                self.name, f"iid_mode {cfg.iid_mode!r} is host-only "
                f"(per-stream thinning / autocovariance scans)")
        if cfg.fixed_predictors is not None:
            raise UnsupportedPlanConfig(
                self.name, "fixed_predictors is host-only")
        if cfg.cost_per_sample is not None:
            raise UnsupportedPlanConfig(
                self.name, "heterogeneous cost_per_sample is host-only")

    def plan_fleet(self, values, counts, budgets, cfg, *, use_kernel=None,
                   device=None) -> dict:
        self.check(cfg)
        dev = resolve_device(device)
        plan = self.run(torch.as_tensor(np.asarray(values, np.float32),
                                        device=dev),
                        torch.as_tensor(np.asarray(counts, np.int32),
                                        device=dev),
                        torch.as_tensor(np.asarray(budgets, np.float32),
                                        device=dev),
                        cfg, use_kernel=use_kernel)
        return plan.to_numpy()

    def run(self, values, counts, budgets, cfg, *, use_kernel=None,
            n_static=None):
        return fleet_plan(values, counts, budgets, cfg.epsilon_scale,
                          dependence=cfg.dependence, model=cfg.model,
                          epsilon_policy=cfg.epsilon_policy,
                          use_kernel=use_kernel, n_static=n_static)


ENGINES.register("batched", BatchedEngine())
ENGINES.defer("host", "queue 1, 'Event path'")
ENGINES.defer("host_loop", "queue 1, 'Event path'")
ENGINES.defer("sharded", "queue 1, 'Sharding'")
