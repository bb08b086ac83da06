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
    rounded once, and TwoSum recovers its error exactly; moving an inexact
    ``s`` whose last bit is even one unit toward the error rounds the
    exact sum to odd, and a value rounded to odd in f64 (53 bits, more
    than 24 + 2) rounds to f32 as the exact value would.
    """
    ref = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))

    def f64(v):
        if isinstance(v, torch.Tensor):
            return v.double()
        return torch.tensor(float(v), dtype=torch.float64, device=ref.device)

    return _round_sum(f64(a) * f64(b), f64(c))


def _round_sum(p: Tensor, c: Tensor) -> Tensor:
    """p + c rounded once to f32, for f64 tensors holding an exact product
    of two f32 values and an f32 value (:func:`fma`'s second half)."""
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    to_odd = ((err != 0) & torch.isfinite(err)
              & ((s.view(torch.int64) & 1) == 0))
    # err * inf is +-inf toward the error (NaN only where err is 0,
    # which to_odd leaves out)
    s = torch.where(to_odd, torch.nextafter(s, err * float("inf")), s)
    return s.float()


def sqrt(x: Tensor) -> Tensor:
    """Square root rounded correctly to ``x``'s type, as the reference's
    compiler (and the card's ``sqrtf``) rounds it.  PyTorch's vectorized
    f32 square root on the CPU can miss by one unit in the last place;
    the root of the f64 value, rounded once to f32, cannot."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


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


def lane_sum(a: Tensor, b: Tensor, lanes: int) -> Tensor:
    """sum(a * b) over the last axis in the order of XLA:CPU's dot.

    The first N - N % lanes products go into ``lanes`` chains of fused
    multiply-adds (product p into chain p % lanes), which are then added:
    4 chains pairwise, 8 by halves.  The other N % lanes products are
    summed apart and added last: with 4 lanes as rounded products added
    left to right, with 8 as one more chain of fused multiply-adds from
    zero.  ``lanes=1`` is one chain throughout.  Which ``lanes`` a dot
    takes depends on its operands' layout (the callers say which).
    Checked bitwise against the compiled dots at every N from 12 to 31
    and at 100 to 103: a fleet's Gram block and one site's X^T X (4
    lanes), one site's X^T y (8 lanes).
    """
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    m = n - n % lanes
    acc = torch.zeros((*a.shape[:-1], lanes), dtype=a.dtype,
                      device=a.device)
    # every product is exact in f64: take them all at once
    prods = (a[..., :m].double() * b[..., :m].double()).reshape(
        *a.shape[:-1], m // lanes, lanes)
    for p in prods.unbind(-2):
        acc = _round_sum(p, acc.double())
    if lanes == 4:
        out = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    else:
        while acc.shape[-1] > 1:
            h = acc.shape[-1] // 2
            acc = acc[..., :h] + acc[..., h:]
        out = acc[..., 0]
    if m < n:
        if lanes == 4:
            tail = a[..., m] * b[..., m]
            for p in range(m + 1, n):
                tail = tail + a[..., p] * b[..., p]
        else:
            tail = fma_chain(a[..., m:], b[..., m:])
        out = out + tail
    return out


def fma_chain(a: Tensor, b: Tensor) -> Tensor:
    """sum(a * b) over the last axis as one chain of fused multiply-adds
    from zero, left to right."""
    a, b = torch.broadcast_tensors(a, b)
    acc = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    for p in (a.double() * b.double()).unbind(-1):
        acc = _round_sum(p, acc.double())
    return acc


def product_sum(a: Tensor, b: Tensor, fused: bool = False) -> Tensor:
    """sum(a * b) over the last axis, in the order the caller's reduction
    gets in the reference.

    A row longer than ``REDUCE_BLOCK`` is summed in :func:`blocked_sum`'s
    order of rounded products.  For a shorter row XLA:CPU keeps the
    product in the reduction's loop, and the compiler may contract the
    two into fused multiply-adds: ``fused=True`` sums such a row as one
    chain of them (:func:`fma_chain`), ``fused=False`` adds the rounded
    products left to right.  Which one a reduction gets depends on the
    fusion around it, so the caller says: the plan's power sums of
    values and ranks are contracted (S2..S4 from the scan's compiled
    step at N = 16 and 32), the adaptive gate's are not.
    """
    if fused and a.shape[-1] <= REDUCE_BLOCK:
        return fma_chain(a, b)
    return blocked_sum(a * b)


def lu_solve4(a: Tensor, b: Tensor) -> Tensor:
    """Solve a x = b for batched 4 x 4 systems in LAPACK's f32 order.

    The reference solves through the LAPACK ``getrf`` / ``trsm`` that its
    CPU build links: a left-looking factorization with partial pivoting
    (column j takes the earlier pivots, then its upper part by dot
    products summed from the last term, its lower part by multiply-add
    chains subtracted at once; below the pivot it is scaled by the
    pivot's reciprocal), then the two triangular solves by fused
    multiply-adds, dividing by the diagonal as a multiply by its
    reciprocal.  Checked bitwise against ``jnp.linalg.solve`` on 500 of
    the fit's normal-equation systems and 200 random ones.
    """
    lu = a.clone()
    n = lu.shape[-1]
    rows = torch.arange(n, device=a.device).expand(lu.shape[:-1])
    perm = rows.clone()
    for j in range(n):
        # whole rows are swapped at each pivot, so column j already holds
        # the earlier pivots; the arithmetic is getf2's, element by element
        col = lu[..., j].clone()
        # rows < j of U: col[i] -= sum_{t < i} L[i, t] col[t], from t = i-1
        for i in range(1, j):
            d = lu[..., i, i - 1] * col[..., i - 1]
            for t in range(i - 2, -1, -1):
                d = fma(lu[..., i, t], col[..., t], d)
            col[..., i] = col[..., i] - d
        # rows >= j: col[i] -= sum_{t < j} L[i, t] col[t], one chain from 0
        if j:
            d = lu[..., j:, 0] * col[..., 0:1]
            for t in range(1, j):
                d = fma(lu[..., j:, t], col[..., t:t + 1], d)
            col[..., j:] = col[..., j:] - d
        lu[..., j] = col
        # partial pivoting (the first largest |col[i]|, i >= j): swap rows
        # j and jp, then scale below the pivot by its reciprocal
        jp = j + torch.argmax(torch.abs(col[..., j:]), dim=-1, keepdim=True)
        swap = rows.clone()
        swap[..., j:j + 1] = jp
        swap.scatter_(-1, jp, j)
        lu = torch.gather(lu, -2, swap[..., None].expand(lu.shape))
        perm = torch.gather(perm, -1, swap)
        # an exact zero pivot leaves the column unscaled (getf2 skips it)
        piv = lu[..., j, j:j + 1]
        lu[..., j + 1:, j] = torch.where(piv != 0,
                                         lu[..., j + 1:, j] * (1.0 / piv),
                                         lu[..., j + 1:, j])
    x = torch.gather(b, -1, perm)
    for j in range(n - 1):                   # unit lower, forward
        x[..., j + 1:] = fma(-lu[..., j + 1:, j], x[..., j:j + 1],
                             x[..., j + 1:])
    for j in range(n - 1, -1, -1):           # upper, backward
        x[..., j] = x[..., j] * (1.0 / lu[..., j, j])
        if j:
            x[..., :j] = fma(-lu[..., :j, j], x[..., j:j + 1], x[..., :j])
    return x


REDUCE_BLOCK = 32


def _sequential_sum(x: Tensor) -> Tensor:
    acc = x.new_zeros(x.shape[:-1])
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
    left to right (an empty row sums to 0).
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


def host_blocked_sum(x: np.ndarray) -> np.float32:
    """:func:`blocked_sum` of a 1-D f32 host array, as an f32 scalar: the
    same windows, each summed left to right (``np.cumsum`` accumulates in
    order, in the array's type)."""
    n = x.shape[-1]
    if n <= REDUCE_BLOCK:
        return np.cumsum(x, dtype=np.float32)[-1] if n else np.float32(0)
    nb = -(-n // REDUCE_BLOCK)
    total = nb * REDUCE_BLOCK - n
    x = np.pad(x, (total // 2, total - total // 2))
    windows = np.cumsum(x.reshape(nb, REDUCE_BLOCK), axis=1,
                        dtype=np.float32)[:, -1]
    return host_blocked_sum(windows)


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


def _cov_corr_from_sums(mom: Tensor, xxt: Tensor, counts: Tensor,
                        n_static: Optional[int] = None):
    """Shared pairwise (unbiased) covariance + clipped correlation.

    With counts that are data (``n_static`` None: a standalone plan, the
    plan inside the adaptive gate's branch, the gate's decayed weights)
    the port evaluates the form the reference's compiler emits: ``xxt /
    n`` materialized, ``- mean_i mean_j`` contracted into it as one fused
    multiply-add, and ``cov / (d_i d_j)`` merged with the unbiasing
    division into ``(a n) / (max(n - 1, 1) (d_i d_j))``.  With a static
    window length it keeps the plain form the scan's folded plan matches.
    """
    c = counts.to(mom.dtype)
    n = torch.clamp(c, min=1.0)
    mean = mom[..., 0] / n
    n_pair = torch.minimum(c[..., :, None], c[..., None, :])
    n_pair_c = torch.clamp(n_pair, min=1.0)
    den = torch.clamp(n_pair_c - 1.0, min=1.0)
    if n_static is None:
        a = fma(-mean[..., :, None], mean[..., None, :], xxt / n_pair_c)
        cov = a * n_pair_c / den
        d = sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1),
                             min=_EPS))
        corr = (a * n_pair_c) / (den * (d[..., :, None] * d[..., None, :]))
        return cov, torch.clamp(corr, -1.0, 1.0)
    cov = xxt / n_pair_c - mean[..., :, None] * mean[..., None, :]
    cov = cov * n_pair_c / den
    d = sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=_EPS))
    corr = torch.clamp(cov / (d[..., :, None] * d[..., None, :]), -1.0, 1.0)
    return cov, corr


def corr_from_sums(mom: Tensor, xxt: Tensor, counts: Tensor,
                   n_static: Optional[int] = None) -> Tensor:
    """(..., k, 4) sums + (..., k, k) cross products -> (..., k, k) Pearson.

    Feed rank-transformed sums for Spearman.  ``n_static`` as in
    :func:`stats_from_sums`.
    """
    return _cov_corr_from_sums(mom, xxt, counts, n_static)[1]


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
        # s2 / n - mean^2 contracted as one fused multiply-add, then the
        # folded n / (n - 1)
        var = fma(s2, inv, -m2p) * float(np.float32(max(n, 1))
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
    cov, corr = _cov_corr_from_sums(mom, xxt, counts, n_static)
    return StreamStats(count=counts, mean=mean, var=var, m4=m4,
                       var_of_var=vov, cov=cov, corr=corr)


# ---------------------------------------------------------------------------
# One window of one edge, the host planner's statistics (reference lines
# 21-141).  The reference compiles ``window_stats`` on a single (k, N)
# window with its counts as data: central moments by two passes of
# blocked sums, the pairwise covariance by three dots a pair (masks,
# masked values, both), and every ``a - b*c`` of the covariance
# contracted into one fused multiply-add.  These follow that compilation.
# ---------------------------------------------------------------------------

def gram_lanes(k: int) -> int:
    """The chains of the reference's compiled (k, N) x (N, k) dot: one
    below four streams, four from four on.  Checked bitwise for k in 2..8
    at N from 17 to 4096 (k >= 9 takes another order at large N)."""
    return 1 if k < 4 else 4


def _gram(a: Tensor, b: Tensor) -> Tensor:
    """a @ b^T of two (..., k, N) windows in the compiled dot's order."""
    return lane_sum(a[..., :, None, :], b[..., None, :, :],
                    gram_lanes(a.shape[-2]))


def masked_mean(values: Tensor, counts: Tensor) -> Tensor:
    m = _mask(values, counts)
    n = torch.clamp(counts.to(values.dtype), min=1.0)
    xm = torch.where(m > 0, values, torch.zeros_like(values))
    return blocked_sum(xm) / n


def masked_central_moments(values: Tensor, counts: Tensor):
    """Returns (mean, var_unbiased, m2_biased, m4) per stream: the mean,
    then the second and fourth powers of the masked deviations, each
    summed in :func:`blocked_sum`'s order."""
    m = _mask(values, counts)
    n = torch.clamp(counts.to(values.dtype), min=1.0)
    mean = masked_mean(values, counts)
    d = torch.where(m > 0, values - mean[..., None], torch.zeros_like(values))
    d2 = d * d
    m2 = blocked_sum(d2) / n
    m4 = blocked_sum(d2 * d2) / n
    var = m2 * n / torch.clamp(n - 1.0, min=1.0)
    return mean, var, m2, m4


def _pairwise(values: Tensor, counts: Tensor):
    """(E[xy] - mean_i mean_j over co-valid positions, max(n_pair, 1)).

    ``values`` may carry leading stacking dimensions beside the window's
    (k, N): all their dots go through one :func:`lane_sum` (the same
    chains, fewer launches)."""
    m = _mask(values, counts)
    xm = torch.where(m > 0, values, torch.zeros_like(values))
    # the mask's own dot counts min(N_i, N_j), exactly
    c = counts.to(values.dtype)
    n_pair_c = torch.clamp(torch.minimum(c[..., :, None], c[..., None, :]),
                           min=1.0)
    sums = _gram(torch.stack([xm, xm]), torch.stack([m.expand_as(xm), xm]))
    mean_i = sums[0] / n_pair_c
    return fma(-mean_i, mean_i.transpose(-1, -2),
               sums[1] / n_pair_c), n_pair_c


def _cov(a: Tensor, n_pair_c: Tensor) -> Tensor:
    return a * n_pair_c / torch.clamp(n_pair_c - 1.0, min=1.0)


def _corr(a: Tensor, n_pair_c: Tensor) -> Tensor:
    den = torch.clamp(n_pair_c - 1.0, min=1.0)
    d = sqrt(torch.clamp(torch.diagonal(a * n_pair_c / den, dim1=-2,
                                        dim2=-1), min=_EPS))
    # the unbiasing division merges into the normalization, as compiled
    corr = (a * n_pair_c) / (den * (d[..., :, None] * d[..., None, :]))
    return torch.clamp(corr, -1.0, 1.0)


def masked_cov(values: Tensor, counts: Tensor) -> Tensor:
    """Pairwise (k, k) covariance over positions valid in both streams,
    unbiased (n_pair - 1)."""
    return _cov(*_pairwise(values, counts))


def pearson_corr(values: Tensor, counts: Tensor) -> Tensor:
    return _corr(*_pairwise(values, counts))


def spearman_corr(values: Tensor, counts: Tensor) -> Tensor:
    return pearson_corr(rank_transform(values, counts), counts)


def window_stats(values: Tensor, counts: Tensor,
                 dependence: str = "pearson") -> StreamStats:
    """One (k, N) window -> :class:`StreamStats`, on the tensors' device
    (the host planner's statistics).  Bitwise the reference's jitted
    ``window_stats`` on the CPU for k in 2..8 (:func:`gram_lanes`).  The
    covariance's dots and the dependence's (of the values, or of their
    ranks under Spearman) are taken together."""
    DEPENDENCE.get(dependence)
    mean, var, _m2, m4 = masked_central_moments(values, counts)
    vov = var_of_var_estimator(var, m4, counts)
    dep = (rank_transform(values, counts) if dependence == "spearman"
           else values)
    a, n_pair_c = _pairwise(torch.stack([values, dep]), counts)
    return StreamStats(count=counts, mean=mean, var=var, m4=m4,
                       var_of_var=vov, cov=_cov(a[0], n_pair_c),
                       corr=_corr(a[1], n_pair_c))


# ---------------------------------------------------------------------------
# Serial dependence within a stream (thinning and m-dependence, §IV-D).  The
# reference calls these op by op, outside any compilation: each sum is a
# standalone reduction (:func:`blocked_sum`'s order) and each product is
# rounded on its own, so nothing here is contracted.
# ---------------------------------------------------------------------------

def _centred(x: Tensor, n_valid: Tensor):
    """(mask, max(N, 1), masked deviations from the masked mean)."""
    m = _mask(x, torch.as_tensor(n_valid, device=x.device))
    n = torch.clamp(blocked_sum(m), min=1.0)
    mean = blocked_sum(x * m) / n
    return m, n, (x - mean[..., None]) * m


def autocovariance(x: Tensor, n_valid, max_lag: int) -> Tensor:
    """Autocovariances gamma_1..gamma_max_lag of the masked stream(s) ``x``
    (..., N) with ``n_valid`` (...) valid tuples: (..., max_lag).  Used for
    the m-dependence penalty (eq. 9) and thinning's stride (§V-F)."""
    m, n, d = _centred(x, n_valid)
    return torch.stack([_gamma(d, m, n, lag)
                        for lag in range(1, max_lag + 1)], -1)


def _gamma(d: Tensor, m: Tensor, n: Tensor, lag: int) -> Tensor:
    n_max = d.shape[-1]
    pair = m[..., :n_max - lag] * m[..., lag:]
    return blocked_sum(d[..., :n_max - lag] * d[..., lag:] * pair) / n


def pacf(x: Tensor, n_valid, max_lag: int) -> Tensor:
    """Partial autocorrelations by Durbin–Levinson on the sample
    autocovariances: (..., max_lag), in the reference's op order."""
    m, n, d = _centred(x, n_valid)
    gamma0 = blocked_sum(d * d) / n
    gammas = [gamma0, *(_gamma(d, m, n, lag)
                        for lag in range(1, max_lag + 1))]
    phi_prev = [torch.zeros_like(gamma0) for _ in range(max_lag)]
    pacfs = []
    v = gamma0
    for kk in range(1, max_lag + 1):
        # phi_prev[:kk-1] . gammas[kk-1:0:-1], summed left to right
        dot = torch.zeros_like(gamma0)
        for j in range(kk - 1):
            dot = dot + phi_prev[j] * gammas[kk - 1 - j]
        phi_kk = (gammas[kk] - dot) / torch.clamp(v, min=_EPS)
        pacfs.append(phi_kk)
        if kk > 1:
            phi_prev[:kk - 1] = [phi_prev[j] - phi_kk * phi_prev[kk - 2 - j]
                                 for j in range(kk - 1)]
        phi_prev[kk - 1] = phi_kk
        v = v * (1.0 - phi_kk * phi_kk)
    return torch.stack(pacfs, -1)


# The fleet engine computes dependence from kernel sums (corr_from_sums on
# values or ranks) and reads only these names; the host planner calls the
# functions.
DEPENDENCE.register("pearson", pearson_corr)
DEPENDENCE.register("spearman", spearman_corr)
