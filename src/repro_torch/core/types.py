"""Core datatypes — the port of ``repro.core.types``.

Windows are dense ``(..., k, N)`` f32 tensors with per-stream valid counts.
The statistics and model dataclasses hold tensors with any leading batch
dimensions (the batched engine carries a leading fleet axis E).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """Per-window sufficient statistics (masked, unbiased where standard).

    All fields are (..., k) except ``corr``/``cov`` which are (..., k, k).
    ``var_of_var`` is eq. 8: Var[sigma_hat^2] = (mu4 - (N-3)/(N-1) sigma^4)/N.
    """

    count: Tensor
    mean: Tensor
    var: Tensor          # unbiased sample variance
    m4: Tensor           # fourth central moment (biased/plug-in)
    var_of_var: Tensor   # eq. 8
    cov: Tensor          # (..., k, k) sample covariance (pairwise, unbiased)
    corr: Tensor         # (..., k, k) dependence matrix (Pearson or Spearman)


@dataclasses.dataclass(frozen=True)
class CompactModel:
    """Compact representation of E[X_i | X_{p_i}] for all k streams.

    coeffs: (..., k, 4) polynomial coefficients (c0 + c1 u + c2 u^2 + c3 u^3)
        in standardized predictor units u = (x_p - loc) / scale.
    loc/scale: (..., k) standardization of the predictor column.
    explained_var: (..., k) Var[E[X_i|X_{p_i}]], the V_i of eqs. 3, 7, 11.
    predictor: (..., k) int — p_i.

    The host payload path stores numpy arrays in the same fields.
    """

    coeffs: Any
    loc: Any
    scale: Any
    explained_var: Any
    predictor: Any

    @staticmethod
    def param_bytes() -> int:
        """WAN footprint of one stream's model (f32 coeffs + loc/scale + idx)."""
        return 4 * 4 + 2 * 4 + 4


@dataclasses.dataclass(frozen=True)
class EdgePayload:
    """What actually crosses the WAN for one window (host-side container)."""

    window_id: int
    n_real: np.ndarray                 # (k,) int
    n_imputed: np.ndarray              # (k,) int
    real_values: list                  # per stream, the sampled tuples (f32)
    model: Optional[CompactModel]      # None => mean imputation
    mean_imputation: bool
    predictor: np.ndarray              # (k,) int
    stats_digest: dict                 # small header: per-stream mean/var
    sent_at_ms: float = 0.0

    def wan_bytes(self, sample_bytes: int = 4) -> int:
        data = int(sum(int(n) * sample_bytes for n in self.n_real))
        header = 8 + 2 * len(self.n_real)  # window id + per-stream counts
        if self.model is None:
            per = 4                        # mean imputation ships one float
        elif isinstance(self.model, dict):  # multi-predictor (§V-G)
            per = 4 * 4 + 4 * 4 + 8
        else:
            per = self.model.param_bytes()
        model_bytes = per * int(np.sum(self.n_imputed > 0))
        return data + header + model_bytes


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Tunables for the Algorithm-1 planner (defaults as in the reference)."""

    dependence: str = "spearman"          # "pearson" | "spearman"  (§IV-B)
    model: str = "cubic"                  # "linear" | "cubic" | "mean" | "multi"
    epsilon_policy: str = "k_se"          # "k_se" | "alpha" | "exact_mse"
    epsilon_scale: float = 1.0            # k in k·SE, or alpha
    iid_mode: str = "none"                # "none" ("iid") | "thinning" | "m_dependence"
    m_lags: int = 1                       # for m_dependence
    cost_per_sample: Optional[Any] = None  # (k,) heterogeneous costs; None => 1
    weight_mode: str = "inv_mean"         # footnote 3: coefficient of variation
    solver: str = "ipm"                   # "ipm" | "slsqp" | "closed_form"
    seed: int = 0
    fixed_predictors: Optional[Any] = None  # override the §IV-A heuristic
    engine: Optional[str] = None          # plan engine; None = batched for fleets
