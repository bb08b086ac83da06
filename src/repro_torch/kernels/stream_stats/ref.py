"""Plain PyTorch versions of the ``stream_stats`` kernels."""
from __future__ import annotations

import torch

from repro_torch.core.stats import blocked_sum, lane_sum, product_sum


def fleet_stats_ref(x: torch.Tensor, fused: bool = False):
    """x (E, k, N) -> (moments (E, k, 4) [S1..S4], xxt (E, k, k)), f32.

    Everything is summed in the reference's order: the power sums in
    XLA:CPU's 32-wide windows (:func:`~repro_torch.core.stats.
    blocked_sum`), or for rows of 32 or fewer with ``fused`` S2..S4 as
    chains of fused multiply-adds (:func:`~repro_torch.core.stats.
    product_sum`: the caller knows which its reduction gets); the cross
    products as its compiled ``x @ x.T`` sums them (four multiply-add
    chains, :func:`~repro_torch.core.stats.lane_sum`), so the plan's and
    the adaptive gate's statistics are bitwise the reference's on the
    CPU.
    """
    x = x.to(torch.float32)
    x2 = x * x
    mom = torch.stack([blocked_sum(x), product_sum(x, x, fused),
                       product_sum(x2, x, fused), product_sum(x2, x2, fused)],
                      dim=-1)
    return mom, lane_sum(x[..., :, None, :], x[..., None, :, :], 4)


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
