"""Compact conditional-expectation models E[X_i | X_{p_i}] (§IV-B).

Port of ``repro.core.models``: the linear and cubic families, mean
imputation, and the two-predictor multi model (§V-G).  The reference
vmaps the per-stream fit over k and the batched engine vmaps it again over
sites; here both axes are written out, so every fit takes ``(..., k, N)``
values and fits every (site, stream) row at once.

Two paths, selected as in the reference: ``use_kernel=True`` assembles the
normal equations from the fused Vandermonde moments (the ``polyfit``
kernel, all E·k rows in one launch); any other value keeps the legacy
least-squares path.
"""
from __future__ import annotations

import torch

from repro_torch.core.stats import (blocked_sum, fma_chain, ipow,
                                    lane_sum, lu_solve4, recip, sqrt)
from repro_torch.core.types import CompactModel, Tensor

_RIDGE = 1e-6


def _features(u: Tensor, degree: int) -> Tensor:
    """(..., N) -> (..., N, 4) Vandermonde; degrees above ``degree`` zeroed."""
    feats = torch.stack([torch.ones_like(u), u, ipow(u, 2), ipow(u, 3)],
                        dim=-1)
    keep = (torch.arange(4, device=u.device) <= degree).to(u.dtype)
    return feats * keep


def _unbiased(total: Tensor, n: Tensor) -> Tensor:
    """total / max(n - 1, 1).  n counts a gathered pair mask, which is data
    to the reference's compiler even when the window length is static, so
    the division stays a division."""
    return total / torch.clamp(n - 1.0, min=1.0)


# the longest contraction the compiled X^T X of a window (or a fleet)
# sums as one chain; a longer one is split in halves until every part is
# at most this long, each part one chain, the parts added left to right
# (checked at N = 400, 448, 500, 512, 800 and 1024; not reproduced at
# 1000, 2000 or 4096)
XTX_CHAIN = 384


def _one_site(y: Tensor, n_sites) -> bool:
    """Whether ``y`` (E, k, N) is one site's fit: the fleet's site count
    decides, not the leading shape of a shard."""
    return y.dim() == 3 and (y.shape[0] if n_sites is None else n_sites) == 1


def _normal_equations(ft: Tensor, yw: Tensor, one: bool):
    """X^T X + ridge and X^T y of (..., 4, N) features in the order the
    reference's compiled dots sum them: one site's (the site axis
    squeezed away) in four chains and eight; otherwise one chain each,
    X^T X split as :data:`XTX_CHAIN` says."""
    eye = torch.eye(4, dtype=ft.dtype, device=ft.device)
    n = ft.shape[-1]
    if one:
        xtx = lane_sum(ft[..., :, None, :], ft[..., None, :, :], 4)
    else:
        parts = 1
        while -(-n // parts) > XTX_CHAIN:
            parts *= 2
        step = -(-n // parts)
        # the parts' chains run side by side; zeros padded to the end of
        # the last one leave its sum as it is
        fp = torch.nn.functional.pad(ft, (0, parts * step - n))
        fp = fp.reshape(*ft.shape[:-1], parts, step).movedim(-2, 0)
        sums = lane_sum(fp[..., :, None, :], fp[..., None, :, :], 1)
        xtx = sums[0]
        for part in sums[1:]:
            xtx = xtx + part
    return xtx + _RIDGE * eye, lane_sum(ft, yw[..., None, :], 8 if one else 1)


def _fit_one(y: Tensor, x_pred: Tensor, pair_mask: Tensor, degree: int,
             n_sites=None):
    """LSQ fit of y ~ poly(x_pred) over co-valid positions, batched over
    leading dims.  Returns (coeffs (..., 4), loc, scale, explained_var).

    The normal equations are summed in the order the reference's compiled
    dots sum them (:func:`~repro_torch.core.stats.lane_sum`): a fleet's in
    one multiply-add chain, one site's (leading shape (1, k), the site
    axis squeezed away, so the operands lie differently) in four chains
    for X^T X and eight for X^T y.  Every system is solved in LAPACK's
    order (:func:`~repro_torch.core.stats.lu_solve4`) and the fitted
    values are 4-term multiply-add chains (:func:`~repro_torch.core.stats.
    fma_chain`, the reference's compiled length-4 dot), so on the CPU the
    fit is bitwise the reference's.  ``n_sites`` is the fleet's site count
    when ``y`` holds a shard of it (a one-site shard of a fleet sums as a
    fleet does); None reads it from ``y``.
    """
    w = pair_mask
    n = torch.clamp(blocked_sum(w), min=1.0)
    loc = blocked_sum(x_pred * w) / n
    var_p = blocked_sum(ipow(x_pred - loc[..., None], 2) * w) / n
    scale = sqrt(torch.clamp(var_p, min=1e-12))
    u = (x_pred - loc[..., None]) / scale[..., None]
    f = _features(u, degree) * w[..., None]
    one = _one_site(y, n_sites)
    xtx, xty = _normal_equations(f.transpose(-1, -2), y * w, one)
    coeffs = lu_solve4(xtx, xty)
    fitted = fma_chain(f, coeffs[..., None, :])
    mean_fit = blocked_sum(fitted * w) / n
    # Var[E[X|Xp]] — unbiased over co-valid samples (the V_i of eqs. 3/7/11)
    ev = _unbiased(blocked_sum(ipow(fitted - mean_fit[..., None], 2) * w), n)
    return coeffs, loc, scale, ev


def fit_models(values: Tensor, counts: Tensor, predictor: Tensor,
               degree: int = 3, use_kernel=None,
               n_static=None, n_sites=None) -> CompactModel:
    """Fit E[X_i | X_{p_i}] for every stream of every site.

    values (..., k, N) f32, counts (..., k), predictor (..., k) int64.
    ``n_static`` is accepted for the families' fit signature: the fit
    counts a gathered pair mask, which the reference never folds.
    ``n_sites``: the fleet's site count when ``values`` holds a shard of
    it (see :func:`_fit_one`).
    """
    n_max = values.shape[-1]
    idx = torch.arange(n_max, device=values.device)
    mask = (idx < counts[..., None]).to(values.dtype)
    gather_idx = predictor[..., None].expand(*predictor.shape, n_max)
    xp = torch.gather(values, -2, gather_idx)      # (..., k, N)
    mp = torch.gather(mask, -2, gather_idx)        # predictor validity
    pair = mask * mp
    if use_kernel is True:
        coeffs, loc, scale, ev = _fit_fused(values, xp, pair, degree)
    else:
        coeffs, loc, scale, ev = _fit_one(values, xp, pair, degree,
                                          n_sites)
    return CompactModel(coeffs=coeffs, loc=loc, scale=scale,
                        explained_var=ev, predictor=predictor)


def _fit_fused(values: Tensor, xp: Tensor, pair: Tensor, degree: int):
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
    scale = sqrt(torch.clamp(var_p, min=1e-12))
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
    s = fma_chain(c, pu[..., :4])                   # sum of fitted*w
    ss = fma_chain(torch.stack([fma_chain(c, gram[..., :, j])
                                for j in range(4)], dim=-1),
                   c)                               # sum of fitted^2*w
    ev = _unbiased(torch.clamp(ss - s * s / n, min=0.0), n)
    return coeffs, loc, scale, ev


def evaluate_model(model: CompactModel, x_pred: Tensor) -> Tensor:
    """Impute every stream from its predictor's observations.

    x_pred: (..., k, M) — per stream, M observations of its predictor.
    """
    u = (x_pred - model.loc[..., None]) / model.scale[..., None]
    c = model.coeffs
    return (c[..., 0:1] + c[..., 1:2] * u + c[..., 2:3] * ipow(u, 2)
            + c[..., 3:4] * ipow(u, 3))


def mean_model(values: Tensor, counts: Tensor, predictor: Tensor,
               use_kernel=None, n_static=None, n_sites=None) -> CompactModel:
    """Mean imputation: E[X_i|X_p] := mu_i, explained variance exactly 0
    (paper §III-B2).  ``use_kernel`` and ``n_sites`` are accepted for the
    registry's fit signature; no kernel serves this family."""
    n_max = values.shape[-1]
    mask = (torch.arange(n_max, device=values.device)
            < counts[..., None]).to(values.dtype)
    total = blocked_sum(values * mask)
    if n_static is not None:
        mean = total * recip(max(int(n_static), 1))
    else:
        mean = total / torch.clamp(counts.to(values.dtype), min=1.0)
    zeros = torch.zeros_like(mean)
    coeffs = torch.stack([mean, zeros, zeros, zeros], dim=-1)
    return CompactModel(coeffs=coeffs, loc=zeros, scale=torch.ones_like(mean),
                        explained_var=zeros, predictor=predictor)


# Beyond the paper (§V-G): TWO predictor streams per target,
# E[X_i | X_p, X_q] ~ c0 + c1 u + c2 v + c3 uv — still 4 coefficients;
# constraint 1d becomes n_s,i <= min(n_r,p, n_r,q).

def _fit_one_multi(y: Tensor, xp: Tensor, xq: Tensor, pair_mask: Tensor,
                   n_sites=None):
    """LSQ fit of y ~ (1, u, v, uv) over co-valid positions, batched over
    leading dims.  Returns (coeffs (..., 4), loc (..., 2), scale (..., 2),
    explained_var); ``n_sites`` as in :func:`_fit_one`."""
    w = pair_mask
    n = torch.clamp(blocked_sum(w), min=1.0)

    def std(x):
        loc = blocked_sum(x * w) / n
        var = blocked_sum(ipow(x - loc[..., None], 2) * w) / n
        scale = sqrt(torch.clamp(var, min=1e-12))
        return (x - loc[..., None]) / scale[..., None], loc, scale

    u, loc_u, sc_u = std(xp)
    v, loc_v, sc_v = std(xq)
    f = torch.stack([torch.ones_like(u), u, v, u * v], dim=-1) * w[..., None]
    one = _one_site(y, n_sites)
    xtx, xty = _normal_equations(f.transpose(-1, -2), y * w, one)
    coeffs = lu_solve4(xtx, xty)
    fitted = fma_chain(f, coeffs[..., None, :])
    mean_fit = blocked_sum(fitted * w) / n
    ev = _unbiased(blocked_sum(ipow(fitted - mean_fit[..., None], 2) * w), n)
    return (coeffs, torch.stack([loc_u, loc_v], dim=-1),
            torch.stack([sc_u, sc_v], dim=-1), ev)


def fit_models_multi(values: Tensor, counts: Tensor, predictors: Tensor,
                     use_kernel=None, n_static=None, n_sites=None) -> dict:
    """predictors (..., k, 2): two predictor streams per target.

    Returns the reference's dict model {coeffs (..., k, 4), loc and scale
    (..., k, 2), explained_var (..., k), predictor (..., k, 2)}.  No
    kernel serves this family, and nothing folds (``use_kernel`` and
    ``n_static`` are accepted for the families' fit signature).
    ``n_sites`` as in :func:`fit_models`.
    """
    n_max = values.shape[-1]
    mask = (torch.arange(n_max, device=values.device)
            < counts[..., None]).to(values.dtype)

    def take(x, p):
        return torch.gather(x, -2, p[..., None].expand(*p.shape, n_max))

    p0, p1 = predictors[..., 0], predictors[..., 1]
    pair = mask * take(mask, p0) * take(mask, p1)
    coeffs, loc, scale, ev = _fit_one_multi(values, take(values, p0),
                                            take(values, p1), pair, n_sites)
    return {"coeffs": coeffs, "loc": loc, "scale": scale,
            "explained_var": ev, "predictor": predictors}


def evaluate_model_multi(model: dict, xp: Tensor, xq: Tensor) -> Tensor:
    """(..., k, M) observations of both predictors -> (..., k, M) imputed."""
    u = (xp - model["loc"][..., 0:1]) / model["scale"][..., 0:1]
    v = (xq - model["loc"][..., 1:2]) / model["scale"][..., 1:2]
    c = model["coeffs"]
    return c[..., 0:1] + c[..., 1:2] * u + c[..., 2:3] * v + c[..., 3:4] * u * v
