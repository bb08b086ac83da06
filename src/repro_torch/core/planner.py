"""Imputation-model registry — the ``ModelSpec`` part of
``repro.core.planner``.

The host planner body (``plan_window``) belongs to the event path and is
not ported yet; the batched engine reads only these registry entries.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

import repro_torch.core.epsilon  # noqa: F401  — fills EPSILON_POLICIES
import repro_torch.core.stats  # noqa: F401  — fills DEPENDENCE
from repro_torch.api.registry import MODELS
from repro_torch.core import models as models_mod
from repro_torch.core import predictor as pred_mod
from repro_torch.core.types import CompactModel


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
