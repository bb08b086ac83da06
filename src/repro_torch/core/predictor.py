"""Predictor-stream selection (§IV-A) — port of ``repro.core.predictor``."""
from __future__ import annotations

import torch

from repro_torch.core.types import Tensor


def heuristic_predictors(corr: Tensor) -> Tensor:
    """(..., k, k) dependence -> (..., k) argmax |corr| off the diagonal.

    Ties go to the lowest index, as ``jnp.argmax`` breaks them.
    """
    k = corr.shape[-1]
    a = torch.abs(corr)
    a = a - 2.0 * torch.eye(k, dtype=corr.dtype, device=corr.device)
    a = torch.where(torch.isnan(a), torch.full_like(a, -2.0), a)
    return torch.argmax(a, dim=-1)
