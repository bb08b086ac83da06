"""Plain PyTorch version of the ``polyfit`` kernel."""
from __future__ import annotations

import torch

from repro_torch.core.stats import blocked_sum, ipow


def polyfit_ref(y: torch.Tensor, u: torch.Tensor):
    """(R, N), (R, N) -> (pu (R, 7) [sum u^0..u^6], py (R, 4) [sum y u^0..u^3]).

    Sums are taken in the reference's order
    (:func:`~repro_torch.core.stats.blocked_sum`).
    """
    y = y.to(torch.float32)
    u = u.to(torch.float32)
    powers = [torch.ones_like(u)] + [ipow(u, m) for m in range(1, 7)]
    pu = torch.stack([blocked_sum(p) for p in powers], dim=-1)
    py = torch.stack([blocked_sum(y * powers[m]) for m in range(4)], dim=-1)
    return pu, py
