"""Algorithm 1, the edge-side stream sampling planner — port of
``repro.core.planner``.

    estimate sigma_i^2 (and dependence)
    heuristic predictor selection
    solve eq. 1 for n_r, n_s
    forward samples + compact models to the cloud

:func:`plan_window` plans one window of one edge and returns the
:class:`EdgePayload` that crosses the WAN plus :class:`PlanDiagnostics`.
The imputation-model registry (:class:`ModelSpec`, ``MODELS``) is shared
with the batched engine.  :func:`plan_with_baseline` plans a window with
one of the paper's baseline samplers (``BASELINES``): sampling only, no
imputation, behind the same payload.

Placement of the host planner (``engine`` None, ``"host"`` or
``"host_loop"``): the window is uploaded to ``device`` once; its
statistics, predictor choice, fit and epsilon, and the sampler's
permutations, run there and come back in one read.  The program is then
built, solved (f64), rounded and, under ``exact_mse``, capped on the host
(:mod:`repro_torch.core.solver` says why), and the samples are taken from
the host window by the permutations.  The statistics and the fit are the
plain versions on every device, as in the reference's host path: no CUDA
kernel runs here.  Under ``iid_mode="thinning"`` the strides come
first, from the window's autocovariances on ``device`` (one more upload
and read), and the thinned window is planned; under ``"m_dependence"``
the objective's variance (eq. 9) is computed with the statistics and
read with them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

import repro_torch.core.epsilon  # noqa: F401  — fills EPSILON_POLICIES
import repro_torch.core.stats  # noqa: F401  — fills DEPENDENCE
from repro_torch import resolve_device
from repro_torch.api.registry import BASELINES, MODELS
from repro_torch.core import epsilon as eps_mod
from repro_torch.core import models as models_mod
from repro_torch.core import predictor as pred_mod
from repro_torch.core import samplers
from repro_torch.core import solver as solver_mod
from repro_torch.core import stats as stats_mod
from repro_torch.core import thinning
from repro_torch.core.types import (Allocation, CompactModel, EdgePayload,
                                    PlannerConfig, StreamStats, WindowBatch,
                                    host_arrays)


@dataclasses.dataclass
class PlanDiagnostics:
    """What the planner decided besides the payload.  ``device_seconds``
    and ``solve_seconds`` split the host planner's time: the window's
    upload, statistics, fit, epsilon, permutations and read on the
    device, then the program's build, solve, rounding and cap on the
    host (both 0 for an engine's plan)."""

    stats: object
    allocation: Allocation
    eps: np.ndarray
    strides: Optional[np.ndarray]
    predictor: np.ndarray
    solver_feasible: bool
    device_seconds: float = 0.0
    solve_seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One registered imputation-model family (``PlannerConfig.model``)."""

    name: str
    select: Callable        # (corr) -> (..., k[, 2]) predictor assignment
    fit: Callable           # (values, counts, predictor) -> compact model
                            # (a dict model for multi)
    per_model_bytes: float  # WAN upload per imputing stream (constraint 1f)
    multi: bool = False     # two predictor streams per target (§V-G)
    mean: bool = False      # degenerate mean-imputation model

    def budget_net(self, budget, k: int):
        """Constraint-1f accounting: the model upload is reserved for every
        stream up front.  Budget is in 4-byte sample units; a float or a
        tensor of per-site budgets; never less than 2 samples."""
        overhead = self.per_model_bytes / 4.0 * k
        if isinstance(budget, (int, float)):
            return max(float(budget) - overhead, 2.0)
        return torch.clamp(budget - overhead, min=2.0)


MODELS.register("linear", ModelSpec(
    name="linear", select=pred_mod.heuristic_predictors,
    fit=lambda v, c, p, **kw: models_mod.fit_models(v, c, p, degree=1, **kw),
    per_model_bytes=float(CompactModel.param_bytes())))
MODELS.register("cubic", ModelSpec(
    name="cubic", select=pred_mod.heuristic_predictors,
    fit=lambda v, c, p, **kw: models_mod.fit_models(v, c, p, degree=3, **kw),
    per_model_bytes=float(CompactModel.param_bytes())))
MODELS.register("mean", ModelSpec(
    name="mean", select=pred_mod.heuristic_predictors,
    fit=models_mod.mean_model, per_model_bytes=4.0, mean=True))
MODELS.register("multi", ModelSpec(
    name="multi", select=pred_mod.heuristic_predictors_multi,
    fit=models_mod.fit_models_multi,
    per_model_bytes=float(4 * 4 + 4 * 4 + 8), multi=True))


def apply_exact_mse_cap(p: solver_mod.ProblemData, stats, nr: np.ndarray,
                        ns: np.ndarray) -> np.ndarray:
    """Appendix-B post-hoc cap on the host: shrink n_s until the eq.-7
    bias fits under the exact-MSE bound (``epsilon.exact_mse_shrink``, the
    closed-form fixed point of the decrement loop), in f32 on the CPU, op
    by op as the reference calls it."""
    f32 = torch.float32
    host = StreamStats(**{f: torch.as_tensor(np.asarray(getattr(stats, f)))
                          for f in ("count", "mean", "var", "m4",
                                    "var_of_var", "cov", "corr")})
    nr_t, ns_t = torch.as_tensor(nr), torch.as_tensor(ns)
    cap = eps_mod.exact_mse_cap(host, nr_t, ns_t, nr_t + ns_t)
    out = eps_mod.exact_mse_shrink(nr_t, ns_t,
                                   torch.as_tensor(p.sigma2, dtype=f32),
                                   torch.as_tensor(p.explained_var,
                                                   dtype=f32), cap)
    return out.numpy().astype(np.int64)


def plan_window(batch: WindowBatch, budget: float, cfg: PlannerConfig,
                key: Optional[tuple] = None, device=None
                ) -> tuple[EdgePayload, PlanDiagnostics]:
    """Algorithm 1 for one window — the planning front door.

    ``cfg.engine`` None, ``"host"`` and ``"host_loop"`` run the host
    planner below; another engine plans the window as its E = 1 case
    (``plan_one``).  ``key`` is a threefry key, by default
    ``prng_key(cfg.seed ^ window_id)``; ``device=None`` is the GPU.
    """
    if cfg.engine not in (None, "host", "host_loop"):
        from repro_torch.api.registry import ENGINES
        import repro_torch.planning  # noqa: F401  — fills ENGINES
        return ENGINES.get(cfg.engine).plan_one(batch, budget, cfg, key=key,
                                                device=device)
    return _plan_window_host(batch, budget, cfg, key, device)


def _plan_window_host(batch: WindowBatch, budget: float, cfg: PlannerConfig,
                      key: Optional[tuple] = None, device=None
                      ) -> tuple[EdgePayload, PlanDiagnostics]:
    """The host Algorithm-1 body (the ``"host"`` engine's), one upload and
    one read of the window."""
    dev = resolve_device(device)
    if key is None:
        from repro_torch.runtime.threefry import prng_key
        key = prng_key(cfg.seed ^ int(batch.window_id))
    values = np.asarray(batch.values, np.float32)
    counts = np.asarray(batch.counts)
    spec = MODELS.get(cfg.model)

    t0 = time.perf_counter()
    strides = None
    if cfg.iid_mode == "thinning":
        values, counts, strides = thinning.thin_window(values, counts,
                                                       device=dev)
    v = torch.as_tensor(values, device=dev)
    c = torch.as_tensor(counts.astype(np.int32), device=dev)
    stats = stats_mod.window_stats(v, c, dependence=cfg.dependence)
    # predictor selection (§IV-A, or caller-fixed) and the compact model
    if cfg.fixed_predictors is not None:
        predictor = torch.as_tensor(np.asarray(cfg.fixed_predictors,
                                               np.int64), device=dev)
    else:
        predictor = spec.select(stats.corr)
    model = spec.fit(v, c, predictor)
    fields = (dict(model) if spec.multi else
              {f.name: getattr(model, f.name)
               for f in dataclasses.fields(model)})
    fields["predictor"] = predictor.to(torch.int64)
    eps = eps_mod.make_epsilon(cfg.epsilon_policy, stats, cfg.epsilon_scale)
    md = {}                 # the objective's variance under m-dependence
    if cfg.iid_mode == "m_dependence":
        md["md_var"], md["md_gamma"] = thinning.m_dependence_terms(
            v, c, cfg.m_lags)
    perms = samplers.stream_permutations(key, counts, device=dev)
    host = host_arrays({**{f"stats_{f.name}": getattr(stats, f.name)
                           for f in dataclasses.fields(stats)},
                        **fields, **md, "eps": eps, "perms": perms})
    t1 = time.perf_counter()

    stats_h = StreamStats(**{f.name: host[f"stats_{f.name}"]
                             for f in dataclasses.fields(StreamStats)})
    model_h = {f: host[f] for f in fields}
    if not spec.multi:                  # the multi model ships as a dict
        model_h = CompactModel(**model_h)
    predictor = host["predictor"]
    # the model upload comes out of the budget (constraint 1f)
    budget_net = spec.budget_net(budget, len(counts))
    sigma2_obj = (thinning.m_dependence_from_terms(host["md_var"],
                                                   host["md_gamma"])
                  if md else None)
    problem = solver_mod.build_problem(stats_h, model_h, host["eps"],
                                       budget_net,
                                       cost_real=cfg.cost_per_sample,
                                       sigma2_obj=sigma2_obj)
    alloc = solver_mod.solve(problem, method=cfg.solver)
    nr = np.asarray(alloc.n_real, np.int64)
    ns = np.asarray(alloc.n_imputed, np.int64)
    if cfg.epsilon_policy == "exact_mse":
        ns = apply_exact_mse_cap(problem, stats_h, nr, ns)
    t2 = time.perf_counter()

    real_values = samplers.take_samples(values, counts, nr, host["perms"])
    # imputation is keyed to the front of the predictor's real sample, so
    # cap n_s at what actually shipped
    for i in range(len(ns)):
        if spec.multi:
            ns[i] = min(ns[i], len(real_values[int(predictor[i, 0])]),
                        len(real_values[int(predictor[i, 1])]))
        else:
            ns[i] = min(ns[i], len(real_values[int(predictor[i])]))
    payload = EdgePayload(
        window_id=int(batch.window_id),
        n_real=np.asarray([len(r) for r in real_values], np.int64),
        n_imputed=ns,
        real_values=real_values,
        model=None if spec.mean else model_h,
        mean_imputation=spec.mean,
        predictor=predictor,
        stats_digest={"mean": stats_h.mean, "var": stats_h.var})
    diag = PlanDiagnostics(stats=stats_h, allocation=alloc,
                           eps=np.asarray(alloc.eps_used), strides=strides,
                           predictor=predictor,
                           solver_feasible=bool(alloc.feasible),
                           device_seconds=t1 - t0, solve_seconds=t2 - t1)
    return payload, diag


# --------------------------------------------------------------------------
# baseline planners (§V-A3, appendix C): sampling only, no imputation,
# behind the same EdgePayload.  Each entry maps (counts, sigma, budget,
# cost) -> integer allocation.
# --------------------------------------------------------------------------

BASELINES.register("srs",
                   lambda counts, sigma, budget, cost: samplers.srs_allocation(
                       counts, int(budget)))
BASELINES.register("approx_iot",
                   lambda counts, sigma, budget, cost:
                   samplers.stratified_allocation(counts, int(budget)))
BASELINES.register("s_voila",
                   lambda counts, sigma, budget, cost:
                   samplers.svoila_allocation(counts.astype(np.float64),
                                              sigma, int(budget)))
BASELINES.register("neyman_cost",
                   lambda counts, sigma, budget, cost:
                   samplers.neyman_cost_allocation(
                       counts.astype(np.float64), sigma,
                       np.ones(len(counts)) if cost is None
                       else np.asarray(cost, np.float64), float(budget)))


def plan_with_baseline(batch: WindowBatch, budget: float, method: str,
                       key: Optional[tuple] = None, seed: int = 0,
                       cost: Optional[np.ndarray] = None,
                       device=None) -> EdgePayload:
    """Plan one window with a baseline sampler (``BASELINES``: 'srs' |
    'approx_iot' | 's_voila' | 'neyman_cost'): sampling only, no
    imputation.  ``budget`` is in sample units (the allocators round);
    ``cost`` is the optional (k,) per-stream sampling cost of the
    cost-aware baseline.  ``key`` is a threefry key, by default
    ``prng_key(seed ^ (window_id * 9176))``.

    The window is uploaded to ``device`` once; its means and variances
    and the sampler's permutations come back in one read; the allocation
    is host numpy."""
    allocate = BASELINES.get(method)
    dev = resolve_device(device)
    if key is None:
        from repro_torch.runtime.threefry import prng_key
        key = prng_key(seed ^ (int(batch.window_id) * 9176))
    values = np.asarray(batch.values, np.float32)
    counts = np.asarray(batch.counts)
    v = torch.as_tensor(values, device=dev)
    c = torch.as_tensor(counts.astype(np.int32), device=dev)
    mean, var, _, _ = stats_mod.masked_central_moments(v, c)
    host = host_arrays({"mean": mean, "var": var,
                        "perms": samplers.stream_permutations(key, counts,
                                                              device=dev)})
    sigma = np.sqrt(np.maximum(host["var"], 0.0))
    alloc = allocate(counts, sigma, budget, cost)
    real_values = samplers.take_samples(values, counts, alloc,
                                        host["perms"])
    k = len(counts)
    return EdgePayload(
        window_id=int(batch.window_id),
        n_real=np.asarray([len(r) for r in real_values], np.int64),
        n_imputed=np.zeros(k, np.int64),
        real_values=real_values,
        model=None,
        mean_imputation=True,
        predictor=np.zeros(k, np.int64),
        stats_digest={"mean": host["mean"], "var": host["var"]})
