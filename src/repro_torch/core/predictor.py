"""Predictor-stream selection (§IV-A, and §V-G's two predictors) — port
of ``repro.core.predictor``."""
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


def heuristic_predictors_multi(corr: Tensor, n: int = 2) -> Tensor:
    """(..., k, k) dependence -> (..., k, n) top-n |corr| partners (§V-G).

    ``jax.lax.top_k`` takes the lower index on ties and ``torch.topk``
    promises no order there, so the top n come from a stable descending
    sort.  For k == 2 the second predictor repeats the first, as in the
    reference.
    """
    k = corr.shape[-1]
    a = torch.abs(corr) - 2.0 * torch.eye(k, dtype=corr.dtype,
                                          device=corr.device)
    a = torch.where(torch.isnan(a), torch.full_like(a, -2.0), a)
    idx = torch.sort(a, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :min(n, max(k - 1, 1))]
    if idx.shape[-1] < n:
        idx = torch.cat([idx] + [idx[..., -1:]] * (n - idx.shape[-1]), dim=-1)
    return idx
