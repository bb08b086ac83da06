"""Windowed stream statistics from raw sums — port of ``repro.core.stats``.

The fleet path derives every statistic from the power sums S1..S4 and the
cross products X·Xᵀ of zero-masked values, which one pass of the
``stream_stats_fleet`` kernel produces for the whole fleet.  All formulas
broadcast over leading batch dimensions.

Integer powers are written as the products XLA's ``integer_pow`` expands
them to (:func:`ipow`), so the port rounds like the reference.

The card runs the same arithmetic as the CPU (one code path), so it also
pays for :func:`blocked_sum`'s and :func:`fma`'s many small launches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api.registry import DEPENDENCE
from repro_torch.core.types import StreamStats, Tensor

_EPS = 1e-12


def fma(a, b, c) -> Tensor:
    """a*b + c rounded once to f32, as a fused multiply-add rounds it.

    The reference's compiler contracts ``x ± y*z`` inside a fused loop
    into one FMA; where the raw-sum statistics cancel, that single
    rounding decides the result, so the port rounds the same way there.

    The product of two f32 values is exact in f64.  The f64 sum ``s`` is
    rounded, but TwoSum recovers its error exactly, and rounding ``s`` to
    f32 can only go the wrong way when ``s`` lies exactly halfway between
    two f32 values; there the error's sign picks the side.
    """
    ref = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))

    def f64(v):
        if isinstance(v, torch.Tensor):
            return v.double()
        return torch.tensor(float(v), dtype=torch.float64, device=ref.device)

    p = f64(a) * f64(b)
    c64 = f64(c)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    r64 = r.double()
    inf = torch.tensor(float("inf"), device=ref.device)
    up = torch.nextafter(r, inf).double()
    dn = torch.nextafter(r, -inf).double()
    tie = (s == (r64 + up) * 0.5) | (s == (r64 + dn) * 0.5)
    fix = tie & (err != 0)
    nudged = torch.nextafter(s, s + err).float()
    return torch.where(fix, nudged, r)


def ipow(x: Tensor, n: int) -> Tensor:
    """x**n by binary exponentiation, in the reference's product order."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


REDUCE_BLOCK = 32


def _sequential_sum(x: Tensor) -> Tensor:
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def blocked_sum(x: Tensor) -> Tensor:
    """Sum over the last axis in the order XLA:CPU sums a long f32 row.

    XLA's CPU tree-reduction rewrite splits a reduction longer than 32
    into windows of 32 (zero padding split evenly between the two ends,
    ``Padding::kSame``), sums each window left to right, then reduces the
    window sums the same way.  The window statistics cancel
    catastrophically (the raw-sum fourth moment behind the k-SE epsilon
    loses most of its digits in f32), so the reference's allocations
    depend on this order; summing in it keeps the port's allocations
    bitwise the reference's on the CPU.  Rows of 32 or fewer are summed
    left to right.
    """
    n = x.shape[-1]
    if n <= REDUCE_BLOCK:
        return _sequential_sum(x)
    nb = -(-n // REDUCE_BLOCK)
    total = nb * REDUCE_BLOCK - n
    lo = total // 2
    if total:
        x = torch.nn.functional.pad(x, (lo, total - lo))
    x = x.reshape(*x.shape[:-1], nb, REDUCE_BLOCK)
    return blocked_sum(_sequential_sum(x))


def _mask(values: Tensor, counts: Tensor) -> Tensor:
    n_max = values.shape[-1]
    idx = torch.arange(n_max, device=values.device)
    return (idx < counts[..., None]).to(values.dtype)


def var_of_var_estimator(var: Tensor, m4: Tensor, counts: Tensor) -> Tensor:
    """eq. 8:  Var[sigma_hat^2] = (mu4 - (N-3)/(N-1) sigma^4) / N, clipped at 0."""
    n = torch.clamp(counts.to(var.dtype), min=2.0)
    out = fma(-((n - 3.0) / (n - 1.0)), ipow(var, 2), m4) / n
    return torch.clamp(out, min=0.0)


def ordinal_ranks(keys: Tensor) -> Tensor:
    """Stable-sort ranks along the last axis: the stable double argsort.

    The reference counts pairwise comparisons below N = 512 to avoid
    XLA:CPU's serial sort; that form is bitwise this one and would build
    an (..., N, N) tensor, so the port sorts at every N.
    """
    order = torch.argsort(keys, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def rank_transform(values: Tensor, counts: Tensor) -> Tensor:
    """Per-stream ranks of the valid prefix, scaled to [0, 1].

    Continuous-data ranks (ties broken by position); invalid slots are
    pushed to the end and zeroed.  Batched over leading dimensions.
    """
    big = torch.finfo(values.dtype).max
    m = _mask(values, counts)
    masked = torch.where(m > 0, values, torch.full_like(values, big))
    ranks = ordinal_ranks(masked).to(values.dtype)
    denom = torch.clamp(counts.to(values.dtype) - 1.0, min=1.0)[..., None]
    return torch.where(m > 0, ranks / denom, torch.zeros_like(ranks))


def _cov_corr_from_sums(mom: Tensor, xxt: Tensor, counts: Tensor):
    """Shared pairwise (unbiased) covariance + clipped correlation."""
    c = counts.to(mom.dtype)
    n = torch.clamp(c, min=1.0)
    mean = mom[..., 0] / n
    n_pair = torch.minimum(c[..., :, None], c[..., None, :])
    n_pair_c = torch.clamp(n_pair, min=1.0)
    cov = xxt / n_pair_c - mean[..., :, None] * mean[..., None, :]
    cov = cov * n_pair_c / torch.clamp(n_pair_c - 1.0, min=1.0)
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1),
                               min=_EPS))
    corr = torch.clamp(cov / (d[..., :, None] * d[..., None, :]), -1.0, 1.0)
    return cov, corr


def corr_from_sums(mom: Tensor, xxt: Tensor, counts: Tensor) -> Tensor:
    """(..., k, 4) sums + (..., k, k) cross products -> (..., k, k) Pearson.

    Feed rank-transformed sums for Spearman.
    """
    return _cov_corr_from_sums(mom, xxt, counts)[1]


def f32_const(x: float) -> float:
    """``x`` rounded to the nearest f32 (a constant the reference folds)."""
    return float(np.float32(x))


def recip(n: int) -> float:
    """1/n as the reference's compiler folds a division by the constant n."""
    return float(np.float32(1.0) / np.float32(n))


def stats_from_sums(mom: Tensor, xxt: Tensor, counts: Tensor,
                    n_static: Optional[int] = None) -> StreamStats:
    """Raw sums of zero-masked values -> :class:`StreamStats`, batched.

    mom: (..., k, 4) holding S1..S4; xxt: (..., k, k); counts: (..., k).
    The returned ``corr`` is Pearson.

    ``n_static``: every count is this window length, known when the step
    is built (the scan runtime's full windows).  The reference then
    compiles the counts as a constant and its compiler folds them: a
    division by N becomes a multiplication by 1/N, N/(N-1) and 3N become
    constants, and the fused multiply-adds fall differently.  The catastrophic
    cancellation in these raw-sum moments makes their last bits decide
    allocations, so the port evaluates the same folded form.
    """
    s1, s2, s3, s4 = (mom[..., i] for i in range(4))
    if n_static is not None:
        n = int(n_static)
        n2 = max(n, 2)
        inv = recip(max(n, 1))
        mean = s1 * inv
        m2p = mean * mean
        var = (s2 * inv - m2p) * float(np.float32(max(n, 1))
                                       * np.float32(recip(max(n - 1, 1))))
        m4 = fma(-(s1 * f32_const(4.0 * inv)), s3, s4)
        m4 = fma(m2p * 6.0, s2, m4)
        m4 = fma(-(m2p * m2p), f32_const(3.0 * n), m4) * inv
        m4 = torch.clamp(m4, min=0.0)
        c_vov = float(np.float32(n2 - 3) / np.float32(n2 - 1))
        vov = torch.clamp(fma(-c_vov, var * var, m4) * recip(n2), min=0.0)
    else:
        c = counts.to(mom.dtype)
        n = torch.clamp(c, min=1.0)
        mean = s1 / n
        m2 = fma(-mean, mean, s2 / n)
        var = m2 * n / torch.clamp(n - 1.0, min=1.0)
        # (s4 - 4 mean s3 + 6 mean^2 s2 - 3 mean^4 n) / n, contracted as
        # the reference's compiler contracts it
        m4 = fma(-(4.0 * mean), s3, s4)
        m4 = fma(6.0 * ipow(mean, 2), s2, m4)
        m4 = fma(-(3.0 * ipow(mean, 4)), n, m4) / n
        m4 = torch.clamp(m4, min=0.0)
        vov = var_of_var_estimator(var, m4, counts)
    cov, corr = _cov_corr_from_sums(mom, xxt, counts)
    return StreamStats(count=counts, mean=mean, var=var, m4=m4,
                       var_of_var=vov, cov=cov, corr=corr)


# The fleet engine computes dependence from kernel sums (corr_from_sums on
# values or ranks); these entries name the two measures it understands.
DEPENDENCE.register("pearson", "pearson")
DEPENDENCE.register("spearman", "spearman")
