"""The PlanEngine interface and payload assembly — port of
``repro.planning.engine`` (the host engine comes with the event path)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.planner import ModelSpec
from repro_torch.core.types import CompactModel, EdgePayload, PlannerConfig


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
    imputation is keyed to the front of the predictor's real sample.
    """
    real_values = [np.asarray(v, np.float32) for v in real_values]
    pred = np.asarray(plan["predictor"][s], np.int64)
    ns = np.asarray(plan["n_imputed"][s], np.int64).copy()
    for i in range(len(ns)):
        ns[i] = min(ns[i], len(real_values[int(pred[i])]))
    if spec.mean:
        model = None
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
                   use_kernel=None, device=None) -> dict:
        """(E, k, N) windows + per-site budgets -> host numpy plan arrays."""
        raise NotImplementedError
