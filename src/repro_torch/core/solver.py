"""The eq.-1 sample-allocation program (§III-B) and its solvers — port of
``repro.core.solver``.

Variables n = (n_r, n_s) in R^{2k}_{>=0}; minimize sum_i w_i^2 sigma_i^2 /
(n_{r,i} + n_{s,i}) under constraints 1c-1g (see the reference's module
docstring for the program and its feasibility notes).

Three solvers behind one registry (``SOLVERS``):

  * ``"ipm"`` — the f64 log-barrier Newton method, the single-edge default.
  * ``"slsqp"`` — scipy's SLSQP, the solver the paper used.
  * ``"closed_form"`` — the water-filling KKT solution of a relaxation in
    f32 (:func:`closed_form_alloc`); its inputs carry leading batch
    dimensions (E, k), so the fleet's batched pass solves every site at
    once, and the host entry solves one edge as a batch of 1.

Placement: the program is built, solved and rounded on the host, in f64
numpy, whatever the planner's device.  The reference places the solve
edge- and host-side itself; every Newton step ends in a data-dependent
loop decision (the backtracking line search, the decrement test), which
on the card would cost a host synchronization per step, and the program
is small (2k variables, 6k + 1 constraints).  This is where the solve
runs, not a fallback: no device version of it exists.

The IPM evaluates the reference's compiled f64 arithmetic in its order:
the constraint products in four fused multiply-add chains, the barrier
Hessian's products summed left to right, the Newton system solved by
LAPACK's ``dpotrf`` and two ``dtrsm`` (as ``jax.scipy.linalg.solve(...,
assume_a="pos")`` calls them), a failed factorization turned into NaNs as
there, and the logarithms from the C library.  Fused multiply-adds are
emulated exactly (:func:`fma64`).  Bitwise on every Newton step seen for
k = 2, 3, 5 and 8 (``tests/test_torch_host_solver.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.api.registry import SOLVERS
from repro_torch.core.stats import fma, sqrt
from repro_torch.core.types import Allocation, Tensor

_DELTA = 1e-2          # strict margin for constraint 1e
_RIDGE = 1e-9


def closed_form_alloc(q: Tensor, cost: Tensor, n_obs: Tensor, sigma2: Tensor,
                      explained_var: Tensor, eps: Tensor, budget: Tensor,
                      predictor: Tensor, predictor2: Optional[Tensor] = None,
                      bisect_iters: int = 48, fused: bool = True):
    """One-shot KKT solution of a relaxation of eq. 1, in f32.

    (a) n_r by water-filling the budget (constraint 1f): n_r,i =
    t·sqrt(q_i/c_i) clipped to [1, N_i], with the level t found by 48
    bisection steps; floor(+1e-4), then a largest-remainder top-up within
    the budget.  (b) n_s pushed to its eq.-11 bias cap and clipped by
    constraint 1d (n_s <= n_r of the predictor, and of ``predictor2``
    under the two-predictor model).

    Inputs (..., k) (budget (...,)); returns (n_r (..., k) i32,
    n_s (..., k) i32, objective (...,)).  ``fused=False`` rounds the bias
    cap's multiply-add in two steps, as the reference's eager call (the
    host entry's two-predictor model) does.
    """
    dt = q.dtype
    cost = torch.clamp(cost, min=1e-9)
    lo = torch.clamp(n_obs, max=1.0)          # 1e: >=1 where any exist
    r = sqrt(torch.clamp(q, min=0.0) / cost)
    budget = budget[..., None]

    def clipped(t):
        return torch.minimum(torch.maximum(t * r, lo), n_obs)

    inf = torch.full_like(r, float("inf"))
    r_min = torch.where(r > 0, r, inf).amin(-1, keepdim=True)
    t_hi = ((n_obs.amax(-1, keepdim=True) + 1.0)
            / torch.clamp(r_min, min=1e-9))
    t_lo = torch.zeros_like(t_hi)
    for _ in range(bisect_iters):
        mid = 0.5 * (t_lo + t_hi)
        over = (cost * clipped(mid)).sum(-1, keepdim=True) > budget
        t_lo, t_hi = torch.where(over, t_lo, mid), torch.where(over, mid, t_hi)
    nr_f = clipped(t_lo)

    # integer rounding: floor, then largest-remainder top-up within budget.
    # The order must be stable: streams without headroom tie at -inf and
    # keep their position order, as jnp.argsort leaves them.
    nr = torch.minimum(torch.floor(nr_f + 1e-4), n_obs)
    leftover = budget - (cost * nr).sum(-1, keepdim=True)
    headroom = nr < n_obs
    order = torch.argsort(-torch.where(headroom, nr_f - nr, -inf), dim=-1,
                          stable=True)
    head_o = torch.gather(headroom, -1, order)
    cost_o = torch.gather(cost, -1, order)
    spent = torch.cumsum(torch.where(head_o, cost_o, torch.zeros_like(cost_o)),
                         dim=-1)
    take = ((spent <= leftover) & head_o).to(dt)
    nr = nr + torch.zeros_like(nr).scatter(-1, order, take)

    # n_s: eq.-11 bias cap, then 1d (n_s <= n_r of every predictor)
    nr_pred = torch.gather(nr, -1, predictor)
    if predictor2 is not None:
        nr_pred = torch.minimum(nr_pred, torch.gather(nr, -1, predictor2))
    slope = sigma2 - explained_var - eps
    # (n_r - 1) eps - V is one fused multiply-add in the reference
    head = (fma(nr - 1.0, eps, -explained_var) if fused
            else (nr - 1.0) * eps - explained_var)
    cap = torch.where(slope > 0, head / torch.clamp(slope, min=1e-20), inf)
    cap = torch.clamp(cap, min=0.0)
    ns = torch.floor(torch.minimum(cap, nr_pred) + 1e-4)
    # 1e for unobserved (straggler) streams: at least one imputed sample
    ns = torch.where((nr < 0.5) & (nr_pred >= 1.0),
                     torch.clamp(ns, min=1.0), ns)

    obj = (q / torch.clamp(nr + ns, min=1.0)).sum(-1)
    return nr.to(torch.int32), ns.to(torch.int32), obj


# --------------------------------------------------------------------------
# the host program (numpy f64)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProblemData:
    """Numeric inputs of one eq.-1 instance (host-side, numpy)."""

    n_obs: np.ndarray          # (k,) N_i
    sigma2: np.ndarray         # (k,) unbiased window variance (bias rows)
    sigma2_obj: np.ndarray     # (k,) objective variance (m-dependence)
    explained_var: np.ndarray  # (k,) V_i = Var[E[X_i|X_p]]
    weights: np.ndarray        # (k,) w_i
    predictor: np.ndarray      # (k,) p_i
    eps: np.ndarray            # (k,) bias tolerance
    cost_real: np.ndarray      # (k,) cost per real sample
    budget: float              # C
    predictor2: Optional[np.ndarray] = None  # (k,) second predictor (§V-G)

    @property
    def k(self) -> int:
        return int(self.n_obs.shape[0])


def build_problem(stats, model, eps, budget, weights=None, cost_real=None,
                  sigma2_obj=None) -> ProblemData:
    """Window statistics, a fitted model (or the multi model's dict) and
    epsilon, as host arrays -> the f64 program."""
    n_obs = np.asarray(stats.count, np.float64)
    sigma2 = np.maximum(np.asarray(stats.var, np.float64), 1e-12)
    ev = model["explained_var"] if isinstance(model, dict) \
        else model.explained_var
    pred = model["predictor"] if isinstance(model, dict) else model.predictor
    V = np.clip(np.asarray(ev, np.float64), 0.0, sigma2 * (1.0 - 1e-9))
    k = n_obs.shape[0]
    if weights is None:
        mu = np.asarray(stats.mean, np.float64)
        weights = 1.0 / np.maximum(np.abs(mu), 1e-6)   # footnote 3: CoV
    if cost_real is None:
        cost_real = np.ones((k,))
    if sigma2_obj is None:
        sigma2_obj = sigma2
    pred = np.asarray(pred, np.int64)
    pred2 = None
    if pred.ndim == 2:                 # multi-predictor model (§V-G)
        pred, pred2 = pred[:, 0], pred[:, 1]
    return ProblemData(n_obs=n_obs, sigma2=sigma2,
                       sigma2_obj=np.maximum(
                           np.asarray(sigma2_obj, np.float64), 1e-12),
                       explained_var=V,
                       weights=np.asarray(weights, np.float64),
                       predictor=pred, predictor2=pred2,
                       eps=np.asarray(eps, np.float64),
                       cost_real=np.asarray(cost_real, np.float64),
                       budget=float(budget))


def assemble_constraints(p: ProblemData, eps: np.ndarray):
    """A n <= b, n = (n_r, n_s): rows 1c, the two sign rows, 1d (twice
    under two predictors), 1e, 1f and the eq.-11 bias rows."""
    k = p.k
    rows, rhs = [], []
    eye = np.eye(k)
    rows.append(np.hstack([eye, np.zeros((k, k))])); rhs.append(p.n_obs)
    rows.append(np.hstack([-eye, np.zeros((k, k))])); rhs.append(np.zeros(k))
    rows.append(np.hstack([np.zeros((k, k)), -eye])); rhs.append(np.zeros(k))
    P = np.zeros((k, k))
    P[np.arange(k), p.predictor] = -1.0
    rows.append(np.hstack([P, eye])); rhs.append(np.zeros(k))
    if p.predictor2 is not None:
        P2 = np.zeros((k, k))
        P2[np.arange(k), p.predictor2] = -1.0
        rows.append(np.hstack([P2, eye])); rhs.append(np.zeros(k))
    rows.append(np.hstack([-eye, -eye])); rhs.append(-np.full(k, 1.0 + _DELTA))
    rows.append(np.hstack([p.cost_real[None, :], np.zeros((1, k))]))
    rhs.append(np.array([p.budget]))
    # eq. 11: n_s sigma2 - (n_s - 1) V - (n_r + n_s - 1) eps <= 0
    rows.append(np.hstack([-np.diag(eps),
                           np.diag(p.sigma2 - p.explained_var - eps)]))
    rhs.append(-(p.explained_var + eps))
    return np.vstack(rows), np.concatenate(rhs)


def feasible_start(p: ProblemData):
    """Strictly feasible (n0, eps_used, restored).  Restores eps where
    eq. 11 admits no solution even at n_s = 0."""
    prop = p.n_obs / max(p.n_obs.sum(), 1.0)
    nr = 0.9 * p.budget * prop / np.maximum(p.cost_real, 1e-9)
    nr = np.clip(nr, 1.0 + _DELTA + 1e-3, 0.98 * np.maximum(p.n_obs, 1.2))
    # rescale down if cost still exceeds 0.95 C (after the lower clip)
    cost = float(p.cost_real @ nr)
    if cost > 0.95 * p.budget:
        scale = 0.95 * p.budget / cost
        nr = np.maximum(nr * scale, 1.0 + _DELTA + 1e-3)

    eps = p.eps.copy()
    # eq.-11 feasibility at n_s -> 0 requires eps >= V / (n_r - 1)
    min_eps = p.explained_var / np.maximum(nr - 1.0, 1e-3)
    restored = eps < min_eps * 1.05
    eps = np.where(restored, min_eps * 1.10 + 1e-12, eps)

    # headroom for n_s under eq. 11 at this n_r
    slope = p.sigma2 - p.explained_var - eps
    cap = np.where(slope > 0,
                   ((nr - 1.0) * eps - p.explained_var)
                   / np.maximum(slope, 1e-12),
                   np.inf)
    nr_pred = nr[p.predictor]
    if p.predictor2 is not None:
        nr_pred = np.minimum(nr_pred, nr[p.predictor2])
    ns = np.minimum(0.25 * np.maximum(cap, 0.0), 0.5 * nr_pred)
    ns = np.clip(ns, 1e-3, None)
    # keep strict: shrink ns if the bias row is tight
    lhs = ns * p.sigma2 - (ns - 1.0) * p.explained_var
    rhs = (nr + ns - 1.0) * eps
    ns = np.where(lhs >= rhs, 1e-3, ns)
    return np.concatenate([nr, ns]), eps, bool(restored.any())


# -------- f64 arithmetic in the reference's compiled order (host numpy)

_SPLIT = 134217729.0                    # 2**27 + 1, Veltkamp's constant


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    p = a * b
    t = _SPLIT * a
    ah = t - (t - a)
    t = _SPLIT * b
    bh = t - (t - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma64(a, b, c) -> np.ndarray:
    """a*b + c rounded once in f64, as a fused multiply-add rounds it.

    The product splits exactly into p + e (Dekker), p + c into s + t
    (Knuth); t + e rounded to odd, added to s, rounds as the exact sum
    would (Boldo and Melquiond's emulation).  Inputs broadcast."""
    a, b, c = np.broadcast_arrays(np.asarray(a, np.float64),
                                  np.asarray(b, np.float64),
                                  np.asarray(c, np.float64))
    with np.errstate(all="ignore"):
        p, e = _two_prod(a, b)
        s, t = _two_sum(c, p)
        v, w = _two_sum(t, e)
        even = (v.view(np.int64) & 1) == 0
        bump = (w != 0) & even & np.isfinite(w)
        v = np.where(bump, np.nextafter(v, np.copysign(np.inf, w)), v)
        out = s + v
        return np.where(np.isfinite(out), out, a * b + c)


def _seq_sum(x) -> float:
    acc = 0.0
    for v in x:
        acc = acc + v
    return acc


def _blocked_log_sum(s: np.ndarray) -> float:
    """sum(log(s)): the C library's logarithm (XLA's f64 log calls it;
    numpy's vectorized one differs in the last bit), summed in windows of
    32 with the padding split evenly between the ends, as the reference's
    reduction is rewritten."""
    logs = np.asarray([math.log(v) for v in s], np.float64)
    n = logs.shape[0]
    if n <= 32:
        return _seq_sum(logs)
    nb = -(-n // 32)
    pad = nb * 32 - n
    logs = np.pad(logs, (pad // 2, pad - pad // 2))
    return _seq_sum([_seq_sum(w) for w in logs.reshape(nb, 32)])


def _dot4(a: np.ndarray, b: np.ndarray, addend=None) -> np.ndarray:
    """sum(a * b) over the last axis (plus ``addend``) as the compiled
    matrix-vector dot: four fused multiply-add chains (product p into
    chain p % 4), added (0 + 2) + (1 + 3); the other n % 4 rounded
    products added left to right, then to that; the addend (the output
    fusion's) last.  A four-row matrix (k = 2) adds its chains
    (0 + 1) + (2 + 3) and the addend before the leftover products."""
    a, b = np.broadcast_arrays(a, b)
    n = a.shape[-1]
    m = n - n % 4
    four_rows = addend is not None and a.shape[-2] == 4
    acc = np.zeros(a.shape[:-1] + (4,))
    for j in range(0, m, 4):
        acc = fma64(a[..., j:j + 4], b[..., j:j + 4], acc)
    if four_rows:
        out = addend + ((acc[..., 0] + acc[..., 1])
                        + (acc[..., 2] + acc[..., 3]))
    else:
        out = (acc[..., 0] + acc[..., 2]) + (acc[..., 1] + acc[..., 3])
    if m < n:
        tail = a[..., m] * b[..., m]
        for j in range(m + 1, n):
            tail = tail + a[..., j] * b[..., j]
        out = out + tail
    if addend is not None and not four_rows:
        out = addend + out
    return out


def _chain(a: np.ndarray, b: np.ndarray, fused: bool = True) -> np.ndarray:
    """sum(a * b) over the last axis as one chain from zero, left to
    right: of fused multiply-adds, or of rounded products."""
    a, b = np.broadcast_arrays(a, b)
    acc = np.zeros(a.shape[:-1])
    for j in range(a.shape[-1]):
        acc = (fma64(a[..., j], b[..., j], acc) if fused
               else acc + a[..., j] * b[..., j])
    return acc


def _gram_vec(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The Hessian's (2k, 2k) sum over the constraints as compiled for
    2k <= 6: two-wide fused multiply-add vectors in four accumulators
    (products 8j..8j+7), the accumulators added from the last, the pair
    added; the leftover products in one chain of rounded products."""
    a, b = np.broadcast_arrays(a, b)
    n = a.shape[-1]
    m = n - n % 8
    if m == 0:
        return _chain(a, b, fused=False)
    accs = [np.zeros(a.shape[:-1] + (2,)) for _ in range(4)]
    for j in range(0, m, 8):
        for i in range(4):
            lo = j + 2 * i
            accs[i] = fma64(a[..., lo:lo + 2], b[..., lo:lo + 2], accs[i])
    r = accs[0]
    for i in range(1, 4):
        r = accs[i] + r
    out = r[..., 0] + r[..., 1]
    for j in range(m, n):
        out = out + a[..., j] * b[..., j]
    return out


def _ipm(q: np.ndarray, A: np.ndarray, b: np.ndarray, n0: np.ndarray,
         outer_iters: int = 12, inner_iters: int = 40, mu: float = 12.0,
         tau0: float = 1.0):
    """Log-barrier Newton in f64: q = w^2 sigma2_obj per stream; f =
    sum q / (n_r + n_s).  ``outer_iters`` rounds, each of Newton steps
    while half the squared decrement exceeds 1e-10 (at most
    ``inner_iters``), the barrier weight times ``mu`` after each round.
    Returns (n, f(n), max violation, duality-gap bound, Newton steps)."""
    m, two_k = A.shape
    k = two_k // 2
    AT = np.ascontiguousarray(A.T)
    negq, twoq = -q, 2.0 * q
    idx = np.arange(k)
    blocks = ((idx, idx), (idx + k, idx + k), (idx, idx + k), (idx + k, idx))
    gram = _gram_vec if two_k <= 6 else (
        lambda x, y: _chain(x, y, fused=False))

    def totals(n):
        return n[:k] + n[k:]

    def f(n):
        return _seq_sum(q / totals(n))

    def merit(n, tau):
        s = b - _dot4(A, n[None, :])
        if not (np.all(s > 0) and np.all(totals(n) > 0)):
            return math.inf
        return float(fma64(tau, f(n), -_blocked_log_sum(s)))

    def newton_step(n, tau):
        s = b - _dot4(A, n[None, :])
        with np.errstate(all="ignore"):
            d = 1.0 / s
            t = totals(n)
            gq = negq / (t * t)
            g = _dot4(AT, d[None, :], addend=tau * np.concatenate([gq, gq]))
            psi = twoq / ((t * t) * t)
            G = gram((A * (d * d)[:, None]).T[:, None, :], AT[None, :, :])
        H = G.copy()
        for r, c in blocks:
            H[r, c] = fma64(tau, psi, G[r, c])
        tr = _seq_sum(np.diagonal(H))
        H = H + np.eye(two_k) * (tr * (_RIDGE / two_k))
        from scipy.linalg import blas, lapack
        # jax.scipy.linalg.solve(H, g, assume_a="pos"): the lower factor of
        # H^T, used as the upper factor of H; NaN where it fails
        c, info = lapack.dpotrf(H.T, lower=1)
        u = c.T if info == 0 else np.full_like(c, np.nan)
        x = blas.dtrsm(1.0, u, blas.dtrsm(1.0, u, g[:, None], trans_a=1),
                       trans_a=0)
        delta = -x[:, 0]
        lam2 = float(_chain(-g, delta))
        Ad = _dot4(A, delta[None, :])
        with np.errstate(all="ignore"):
            ratios = np.where(Ad > 0, s / Ad, np.inf)
        alpha = float(np.minimum(0.99 * np.min(ratios), 1.0))
        m0 = merit(n, tau)
        gd = float(_chain(g, delta))
        mval = merit(fma64(alpha, delta, n), tau)
        while mval > fma64(alpha * 1e-4, gd, m0) and alpha > 1e-12:
            alpha = alpha * 0.5
            mval = merit(fma64(alpha, delta, n), tau)
        return fma64(alpha, delta, n), lam2

    n = np.asarray(n0, np.float64)
    tau = tau0
    steps = 0
    for _ in range(outer_iters):
        lam2, it = math.inf, 0
        while lam2 * 0.5 > 1e-10 and it < inner_iters:
            n, lam2 = newton_step(n, tau)
            it += 1
        steps += it
        tau = tau * mu
    gap = m / (tau0 * mu ** (outer_iters - 1))
    with np.errstate(all="ignore"):
        viol = float(np.max(_dot4(A, n[None, :]) - b))
    return n, f(n), viol, gap, steps


def solve_ipm(p: ProblemData):
    """(n, f(n), eps_used, ok, Newton steps): the IPM from
    :func:`feasible_start`, on the host in f64; a non-finite result falls
    back to the start."""
    n0, eps, _restored = feasible_start(p)
    A, b = assemble_constraints(p, eps)
    q = p.weights ** 2 * p.sigma2_obj
    n, fval, viol, _gap, steps = _ipm(q, A, b, n0)
    ok = bool(viol <= 1e-6)
    if not np.all(np.isfinite(n)):       # last-ditch: fall back to the start
        n, ok = n0, False
    return n, float(fval), eps, ok, steps


def solve_slsqp(p: ProblemData):
    """scipy's SLSQP (the paper's solver) from the same start."""
    from scipy.optimize import minimize

    n0, eps, _ = feasible_start(p)
    A, b = assemble_constraints(p, eps)
    q = p.weights ** 2 * p.sigma2_obj
    k = p.k

    def f(n):
        return float(np.sum(q / (n[:k] + n[k:])))

    def grad(n):
        g = -q / (n[:k] + n[k:]) ** 2
        return np.concatenate([g, g])

    cons = [{"type": "ineq", "fun": lambda n: b - A @ n, "jac": lambda n: -A}]
    res = minimize(f, n0, jac=grad, constraints=cons, method="SLSQP",
                   options={"maxiter": 300, "ftol": 1e-12})
    return np.asarray(res.x), float(res.fun), eps, bool(res.success)


def solve_closed_form(p: ProblemData) -> Allocation:
    """Host entry of :func:`closed_form_alloc`: one edge as a batch of 1,
    in f32 on the CPU."""
    f32 = torch.float32

    def t(x, dt=f32):
        return torch.as_tensor(np.asarray(x), dtype=dt)[None]

    args = (t(p.weights ** 2 * p.sigma2_obj), t(p.cost_real), t(p.n_obs),
            t(p.sigma2), t(p.explained_var), t(p.eps),
            torch.tensor([p.budget], dtype=f32), t(p.predictor, torch.int64))
    if p.predictor2 is not None:
        # the reference calls its two-predictor solve eagerly: no fused
        # multiply-add in the bias cap
        nr, ns, obj = closed_form_alloc(*args, t(p.predictor2, torch.int64),
                                        fused=False)
    else:
        nr, ns, obj = closed_form_alloc(*args)
    nr, ns = nr[0].numpy(), ns[0].numpy()
    # the >=1-sample floor (1e) can overshoot C when C < sum(cost)
    spent = float(np.asarray(p.cost_real) @ nr)
    return Allocation(n_real=nr, n_imputed=ns,
                      objective=np.float32(obj[0].item()),
                      feasible=bool(spent <= p.budget + 1e-6),
                      eps_used=np.asarray(p.eps, np.float32))


def round_allocation(p: ProblemData, n: np.ndarray, eps: np.ndarray):
    """Integer (n_r, n_s) from the continuous solution, conservative in
    every constraint: floor, re-impose 1d and the bias rows, top up n_r
    greedily within the budget, then at least one sample a stream."""
    k = p.k
    nr = np.floor(n[:k] + 1e-9).astype(np.int64)
    ns = np.floor(n[k:] + 1e-9).astype(np.int64)
    nr = np.clip(nr, 0, p.n_obs.astype(np.int64))

    def bias_ok(nr_i, ns_i, i):
        if ns_i == 0:
            return True          # no imputation => estimator unbiased
        lhs = ns_i * p.sigma2[i] - (ns_i - 1) * p.explained_var[i]
        return lhs <= (nr_i + ns_i - 1) * eps[i] + 1e-9

    for i in range(k):
        ns[i] = min(ns[i], nr[p.predictor[i]])
        if p.predictor2 is not None:
            ns[i] = min(ns[i], nr[p.predictor2[i]])
        while ns[i] > 0 and not bias_ok(nr[i], ns[i], i):
            ns[i] -= 1

    # greedy top-up of n_r with leftover budget (largest marginal gain / cost)
    budget_left = p.budget - float(p.cost_real @ nr)
    q = p.weights ** 2 * p.sigma2_obj
    for _ in range(8 * k):
        tot = np.maximum(nr + ns, 1)
        gain = q / tot - q / (tot + 1)
        gain = np.where(nr < p.n_obs, gain / p.cost_real, -np.inf)
        j = int(np.argmax(gain))
        if gain[j] <= 0 or p.cost_real[j] > budget_left + 1e-12:
            break
        nr[j] += 1
        budget_left -= p.cost_real[j]

    # guarantee >=1 sample per stream (1e) wherever we still can
    for i in range(k):
        if nr[i] + ns[i] == 0:
            if budget_left >= p.cost_real[i] and p.n_obs[i] >= 1:
                nr[i] += 1
                budget_left -= p.cost_real[i]
            elif nr[p.predictor[i]] > 0 and bias_ok(0, 1, i):
                ns[i] = 1
    return nr, ns


def _rounded(p: ProblemData, n: np.ndarray, fval: float, eps: np.ndarray,
             ok: bool, newton_steps: int = 0) -> Allocation:
    nr, ns = round_allocation(p, n, eps)
    return Allocation(n_real=nr.astype(np.int32),
                      n_imputed=ns.astype(np.int32),
                      objective=np.float32(fval), feasible=bool(ok),
                      eps_used=np.asarray(eps, np.float32),
                      newton_steps=newton_steps)


@SOLVERS.register("ipm")
def _ipm_allocation(p: ProblemData) -> Allocation:
    return _rounded(p, *solve_ipm(p))


@SOLVERS.register("slsqp")
def _slsqp_allocation(p: ProblemData) -> Allocation:
    return _rounded(p, *solve_slsqp(p))


SOLVERS.register("closed_form", solve_closed_form)  # does its own rounding


def solve(p: ProblemData, method: str = "ipm") -> Allocation:
    """Solve one eq.-1 instance; ``method`` resolves through ``SOLVERS``."""
    return SOLVERS.get(method)(p)
