"""Exponentially-weighted streaming covariance/correlation for a fleet.

Port of ``repro.adaptive.stats``.  Per window the same (count, S1, S2,
X·Xᵀ) sums the batched planner reads are computed by the fleet
statistics pass (:func:`repro_torch.kernels.stream_stats.ops.
fleet_window_moments_xxt`: on a CUDA tensor the ``stream_stats_fleet``
kernel, row 1 of the port's kernel table) and folded into
:class:`EWStats` under a per-window decay

    acc' = decay * acc + window_sums,        decay = 0.5 ** (1 / halflife)

so ``halflife=None`` (decay 1) keeps the plain running sums.  The
correlation is read out through the same
:func:`repro_torch.core.stats.corr_from_sums` the planner uses, so at
decay 1 the EW estimate equals the batch estimate over the ingested
prefix by function reuse.

The reference's compiler contracts ``decay * acc + sums`` into one fused
multiply-add; the port rounds it the same way (:func:`ew_update`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import stats as stats_mod
from repro_torch.core.stats import fma
from repro_torch.core.types import Tensor
from repro_torch.kernels.stream_stats.ops import fleet_window_moments_xxt


@dataclasses.dataclass
class EWStats:
    """Decayed ``stream_stats`` sums over everything ingested so far.

    ``weight`` plays the role of the count in the batch estimator: the
    decayed mass of tuples behind each stream's sums.
    """

    weight: Tensor       # (E, k) f32 decayed tuple mass
    s1: Tensor           # (E, k) f32 decayed sum
    s2: Tensor           # (E, k) f32 decayed sum of squares
    xxt: Tensor          # (E, k, k) f32 decayed cross products


def ew_decay(halflife: Optional[float]) -> float:
    """Per-window decay factor; ``None`` means no forgetting (decay 1)."""
    if halflife is None:
        return 1.0
    if not halflife > 0.0:
        raise ValueError(f"halflife must be > 0 (or None), got {halflife!r}")
    return float(0.5 ** (1.0 / float(halflife)))


def ew_init(n_sites: int, k: int, device=None) -> EWStats:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return EWStats(weight=z(n_sites, k), s1=z(n_sites, k), s2=z(n_sites, k),
                   xxt=z(n_sites, k, k))


def window_sums(values: Tensor, counts: Tensor, *, use_kernel=None):
    """One window's (count, s1, s2, xxt) through the fleet statistics pass.

    values (E, k, N) f32, counts (E, k) int.  Invalid tail positions are
    zero-masked exactly as the batched planner masks them.
    """
    n_max = values.shape[-1]
    cf = counts.to(values.dtype)
    mask = (torch.arange(n_max, device=values.device)
            < cf[..., None]).to(values.dtype)
    mom, xxt = fleet_window_moments_xxt((values * mask).contiguous(),
                                        use_kernel=use_kernel)
    return cf, mom[..., 0], mom[..., 1], xxt


def ew_update(state: EWStats, values: Tensor, counts: Tensor, decay: float,
              *, use_kernel=None) -> EWStats:
    """Fold one window into the carry: ``decay * acc + window_sums``, each
    rounded once (one fused multiply-add, as the reference's compiler
    emits it)."""
    cf, s1, s2, xxt = window_sums(values, counts, use_kernel=use_kernel)
    d = float(np.float32(decay))
    return EWStats(weight=fma(d, state.weight, cf),
                   s1=fma(d, state.s1, s1),
                   s2=fma(d, state.s2, s2),
                   xxt=fma(d, state.xxt, xxt))


def _as_mom(state: EWStats) -> Tensor:
    """EW sums in the (..., k, 4) moment layout stats_from_sums reads
    (S3/S4 are not maintained — zero-filled; cov/corr only read S1)."""
    z = torch.zeros_like(state.s1)
    return torch.stack([state.s1, state.s2, z, z], dim=-1)


def ew_cov(state: EWStats) -> Tensor:
    """(E, k, k) EW pairwise covariance (unbiased, same formula as the
    per-window batch estimator)."""
    return stats_mod._cov_corr_from_sums(_as_mom(state), state.xxt,
                                         state.weight)[0]


def ew_corr(state: EWStats) -> Tensor:
    """(E, k, k) EW Pearson correlation, clipped to [-1, 1]:
    :func:`repro_torch.core.stats.corr_from_sums` on the decayed sums."""
    return stats_mod.corr_from_sums(_as_mom(state), state.xxt, state.weight)


def ew_mean_var(state: EWStats):
    """(mean, unbiased var) per stream from the decayed sums."""
    n = torch.clamp(state.weight, min=1.0)
    mean = state.s1 / n
    m2 = state.s2 / n - mean * mean
    var = m2 * n / torch.clamp(n - 1.0, min=1.0)
    return mean, var


# ------------------------------------------------------------- round trip

def ew_to_dict(state: EWStats) -> dict:
    """JSON-ready nested lists (f32 values survive the round trip)."""
    return {f.name: getattr(state, f.name).cpu().numpy().tolist()
            for f in dataclasses.fields(state)}


def ew_from_dict(d: dict, device=None) -> EWStats:
    return EWStats(**{f.name: torch.as_tensor(np.asarray(d[f.name],
                                                         np.float32),
                                              device=device)
                      for f in dataclasses.fields(EWStats)})
