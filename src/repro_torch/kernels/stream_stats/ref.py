"""Plain PyTorch versions of the ``stream_stats`` kernels."""
from __future__ import annotations

import torch

from repro_torch.core.stats import blocked_sum


def fleet_stats_ref(x: torch.Tensor):
    """x (E, k, N) -> (moments (E, k, 4) [S1..S4], xxt (E, k, k)), f32.

    The power sums are taken in the reference's order
    (:func:`~repro_torch.core.stats.blocked_sum`); the cross products are
    one batched matmul.
    """
    x = x.to(torch.float32)
    x2 = x * x
    mom = torch.stack([blocked_sum(x), blocked_sum(x2), blocked_sum(x2 * x),
                       blocked_sum(x2 * x2)], dim=-1)
    return mom, x @ x.transpose(-1, -2)


def stream_stats_ref(x: torch.Tensor):
    """x (k, N) -> (moments (k, 4) [S1..S4], xxt (k, k)), f32.

    Counterpart of ``repro.kernels.stream_stats.ref.stream_stats_ref``.
    Nothing on the planning path reads it, so it sums in PyTorch's own
    order.
    """
    x = x.to(torch.float32)
    x2 = x * x
    mom = torch.stack([x.sum(1), x2.sum(1), (x2 * x).sum(1),
                       (x2 * x2).sum(1)], dim=1)
    return mom, x @ x.T
