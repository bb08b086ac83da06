"""Compact conditional-expectation models E[X_i | X_{p_i}] (§IV-B).

Port of ``repro.core.models`` for the linear and cubic families.  The
reference vmaps the per-stream fit over k and the batched engine vmaps it
again over sites; here both axes are written out, so ``fit_models`` takes
``(..., k, N)`` values and fits every (site, stream) row at once.

Two paths, selected as in the reference: ``use_kernel=True`` assembles the
normal equations from the fused Vandermonde moments (the ``polyfit``
kernel, all E·k rows in one launch); any other value keeps the legacy
least-squares path.
"""
from __future__ import annotations

import torch

from repro_torch.core.stats import blocked_sum, fma, ipow, recip
from repro_torch.core.types import CompactModel, Tensor

_RIDGE = 1e-6


def _features(u: Tensor, degree: int) -> Tensor:
    """(..., N) -> (..., N, 4) Vandermonde; degrees above ``degree`` zeroed."""
    feats = torch.stack([torch.ones_like(u), u, ipow(u, 2), ipow(u, 3)],
                        dim=-1)
    keep = (torch.arange(4, device=u.device) <= degree).to(u.dtype)
    return feats * keep


def _unbiased(total: Tensor, n: Tensor, n_static) -> Tensor:
    """total / max(n - 1, 1); with a static window length the reference
    multiplies by the folded reciprocal instead of dividing."""
    if n_static is not None:
        return total * recip(max(int(n_static) - 1, 1))
    return total / torch.clamp(n - 1.0, min=1.0)


def _fit_one(y: Tensor, x_pred: Tensor, pair_mask: Tensor, degree: int,
             n_static=None):
    """LSQ fit of y ~ poly(x_pred) over co-valid positions, batched over
    leading dims.  Returns (coeffs (..., 4), loc, scale, explained_var)."""
    w = pair_mask
    n = torch.clamp(blocked_sum(w), min=1.0)
    loc = blocked_sum(x_pred * w) / n
    var_p = blocked_sum(ipow(x_pred - loc[..., None], 2) * w) / n
    scale = torch.sqrt(torch.clamp(var_p, min=1e-12))
    u = (x_pred - loc[..., None]) / scale[..., None]
    f = _features(u, degree) * w[..., None]
    ft = f.transpose(-1, -2)
    eye = torch.eye(4, dtype=f.dtype, device=f.device)
    xtx = ft @ f + _RIDGE * eye
    xty = (ft @ (y * w)[..., None])[..., 0]
    coeffs = torch.linalg.solve(xtx, xty)
    fitted = (f @ coeffs[..., None])[..., 0]
    mean_fit = blocked_sum(fitted * w) / n
    # Var[E[X|Xp]] — unbiased over co-valid samples (the V_i of eqs. 3/7/11)
    ev = _unbiased(blocked_sum(ipow(fitted - mean_fit[..., None], 2) * w),
                   n, n_static)
    return coeffs, loc, scale, ev


def fit_models(values: Tensor, counts: Tensor, predictor: Tensor,
               degree: int = 3, use_kernel=None,
               n_static=None) -> CompactModel:
    """Fit E[X_i | X_{p_i}] for every stream of every site.

    values (..., k, N) f32, counts (..., k), predictor (..., k) int64.
    ``n_static``: all counts equal this window length (see
    :func:`~repro_torch.core.stats.stats_from_sums`).
    """
    n_max = values.shape[-1]
    idx = torch.arange(n_max, device=values.device)
    mask = (idx < counts[..., None]).to(values.dtype)
    gather_idx = predictor[..., None].expand(*predictor.shape, n_max)
    xp = torch.gather(values, -2, gather_idx)      # (..., k, N)
    mp = torch.gather(mask, -2, gather_idx)        # predictor validity
    pair = mask * mp
    if use_kernel is True:
        coeffs, loc, scale, ev = _fit_fused(values, xp, pair, degree,
                                            n_static)
    else:
        coeffs, loc, scale, ev = _fit_one(values, xp, pair, degree, n_static)
    return CompactModel(coeffs=coeffs, loc=loc, scale=scale,
                        explained_var=ev, predictor=predictor)


def _dot4(a: Tensor, b: Tensor) -> Tensor:
    """Length-4 dot product over the last axis as the reference's compiler
    emits it: a chain of fused multiply-adds from zero, in index order."""
    acc = torch.zeros_like(a[..., 0])
    for i in range(a.shape[-1]):
        acc = fma(a[..., i], b[..., i], acc)
    return acc


def _fit_fused(values: Tensor, xp: Tensor, pair: Tensor, degree: int,
               n_static=None):
    """The `_fit_one` system assembled from fused Vandermonde moments.

    With the 0/1 pair mask w folded into the standardized predictor,
    ``(u*w)**m == (u**m)*w`` for m >= 1, so one kernel pass over
    ``(y*w, u*w)`` yields every masked power sum; only the m=0 count is
    fed in explicitly.  All rows go through the kernel in one launch.
    """
    from repro_torch.kernels.polyfit.ops import (solve_normal_equations,
                                                 vandermonde_moments)
    lead = values.shape[:-1]
    n_max = values.shape[-1]
    pair_n = blocked_sum(pair)                      # true pair counts
    n = torch.clamp(pair_n, min=1.0)
    loc = blocked_sum(xp * pair) / n
    var_p = blocked_sum(ipow(xp - loc[..., None], 2) * pair) / n
    scale = torch.sqrt(torch.clamp(var_p, min=1e-12))
    uw = ((xp - loc[..., None]) / scale[..., None]) * pair
    pu, py = vandermonde_moments((values * pair).reshape(-1, n_max),
                                 uw.reshape(-1, n_max), use_kernel=True,
                                 counts=pair_n.reshape(-1))
    pu = pu.reshape(*lead, 7)
    py = py.reshape(*lead, 4)
    coeffs = solve_normal_equations(pu, py, degree=degree, ridge=_RIDGE)
    idx4 = torch.arange(4, device=pu.device)
    keep = (idx4 <= degree).to(pu.dtype)
    c = coeffs * keep
    gram = pu[..., idx4[:, None] + idx4[None, :]]   # (..., 4, 4) Hankel
    s = _dot4(c, pu[..., :4])                       # sum of fitted*w
    ss = _dot4(torch.stack([_dot4(c, gram[..., :, j]) for j in range(4)],
                           dim=-1), c)              # sum of fitted^2*w
    ev = _unbiased(torch.clamp(ss - s * s / n, min=0.0), n, n_static)
    return coeffs, loc, scale, ev


def evaluate_model(model: CompactModel, x_pred: Tensor) -> Tensor:
    """Impute every stream from its predictor's observations.

    x_pred: (..., k, M) — per stream, M observations of its predictor.
    """
    u = (x_pred - model.loc[..., None]) / model.scale[..., None]
    c = model.coeffs
    return (c[..., 0:1] + c[..., 1:2] * u + c[..., 2:3] * ipow(u, 2)
            + c[..., 3:4] * ipow(u, 3))
