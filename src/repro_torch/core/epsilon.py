"""Bias-tolerance (epsilon_i) policies (§IV-C, appendix B).

Port of ``repro.core.epsilon``: elementwise f32 formulas that broadcast
over the leading fleet axis.
"""
from __future__ import annotations

import torch

from repro_torch.api.registry import EPSILON_POLICIES
from repro_torch.core.stats import ipow, sqrt
from repro_torch.core.types import StreamStats, Tensor


def alpha_fraction(stats: StreamStats, alpha: float = 0.05) -> Tensor:
    """eps_i = alpha * sigma_i^2 — tolerate biasing VAR by a fixed fraction."""
    return alpha * torch.clamp(stats.var, min=1e-12)


def k_standard_errors(stats: StreamStats, k_se: float = 1.0) -> Tensor:
    """eps_i = k * sqrt(Var[sigma_hat^2])  (eq. 8, the paper's default)."""
    se = sqrt(torch.clamp(stats.var_of_var, min=0.0))
    return k_se * torch.clamp(se, min=1e-12)


def exact_mse_cap(stats: StreamStats, n_real: Tensor, n_imp: Tensor,
                  n_std: Tensor) -> Tensor:
    """Appendix B: |Bias| <= sqrt(Var_std[s^2] - Var_new[s^2]), the bound
    that keeps the imputing estimator's MSE no worse than an n_std-sample
    scheme (used as a post-hoc cap, see :func:`exact_mse_shrink`)."""
    var = stats.var
    m4 = stats.m4

    def var_of_s2(n):
        n = torch.clamp(n, min=2.0)
        return torch.clamp((m4 - (n - 3.0) / (n - 1.0) * ipow(var, 2)) / n,
                           min=0.0)

    v_std = var_of_s2(n_std.to(var.dtype))
    nr = torch.clamp(n_real.to(var.dtype), min=2.0)
    ns = torch.clamp(n_imp.to(var.dtype), min=0.0)
    tot = torch.clamp(nr + ns - 1.0, min=1.0)
    v_new = (ipow(nr - 1.0, 2) * var_of_s2(nr)) / ipow(tot, 2)
    return sqrt(torch.clamp(v_std - v_new, min=0.0))


def exact_mse_shrink(n_real: Tensor, n_imp: Tensor, sigma2: Tensor,
                     explained_var: Tensor, cap: Tensor,
                     tol: float = 1e-12) -> Tensor:
    """Closed-form appendix-B shrink: the largest n_s' <= n_s whose eq.-7
    bias fits under ``cap`` with n_r held fixed (the fixed point of the
    host path's decrement loop)."""
    ns = n_imp.to(sigma2.dtype)
    nr = n_real.to(sigma2.dtype)
    a = sigma2 - explained_var - cap
    c = cap * (nr - 1.0) - explained_var
    tot0 = nr + ns - 1.0
    one = torch.ones_like(tot0)
    bias0 = ((ns * sigma2 - (ns - 1.0) * explained_var)
             / torch.where(tot0 > 0, tot0, one))
    fits0 = bias0 <= cap + tol
    ns_max = torch.floor(c / torch.where(a > 0, a, one) + tol)
    shrunk = torch.where(a > 0,
                         torch.minimum(torch.clamp(ns_max, min=0.0), ns),
                         torch.zeros_like(ns))
    out = torch.where(fits0, ns, shrunk)
    # a stream with no real samples halts the decrement at n_s = 1
    floor = torch.where(nr < 0.5, torch.clamp(ns, max=1.0),
                        torch.zeros_like(ns))
    out = torch.maximum(out, floor)
    return torch.where((tot0 <= 0) | (ns <= 0), ns, out)


EPSILON_POLICIES.register(
    "alpha", lambda stats, scale: alpha_fraction(stats, alpha=scale))
EPSILON_POLICIES.register(
    "k_se", lambda stats, scale: k_standard_errors(stats, k_se=scale))
# exact_mse starts from the k-SE default and is capped post-solve
EPSILON_POLICIES.register(
    "exact_mse", lambda stats, scale: k_standard_errors(stats, k_se=scale))


def make_epsilon(policy: str, stats: StreamStats, scale: float) -> Tensor:
    """Resolve ``policy`` through the epsilon-policy registry and apply it."""
    return EPSILON_POLICIES.get(policy)(stats, scale)
