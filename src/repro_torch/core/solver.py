"""Closed-form water-filling solver — port of
``repro.core.solver.closed_form_alloc``.

The reference vmaps the (k,) solver across sites; here the fleet axis is
written out: every input carries leading batch dimensions (E, k), the
budget (E,).  The IPM and SLSQP solvers belong to the host path and are
not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.stats import fma
from repro_torch.core.types import Tensor


def closed_form_alloc(q: Tensor, cost: Tensor, n_obs: Tensor, sigma2: Tensor,
                      explained_var: Tensor, eps: Tensor, budget: Tensor,
                      predictor: Tensor, bisect_iters: int = 48):
    """One-shot KKT solution of a relaxation of eq. 1, in f32.

    (a) n_r by water-filling the budget (constraint 1f): n_r,i =
    t·sqrt(q_i/c_i) clipped to [1, N_i], with the level t found by 48
    bisection steps; floor(+1e-4), then a largest-remainder top-up within
    the budget.  (b) n_s pushed to its eq.-11 bias cap and clipped by
    constraint 1d (n_s <= n_r of the predictor).

    Inputs (..., k) (budget (...,)); returns (n_r (..., k) i32,
    n_s (..., k) i32, objective (...,)).
    """
    dt = q.dtype
    cost = torch.clamp(cost, min=1e-9)
    lo = torch.clamp(n_obs, max=1.0)          # 1e: >=1 where any exist
    r = torch.sqrt(torch.clamp(q, min=0.0) / cost)
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

    # n_s: eq.-11 bias cap, then 1d (n_s <= n_r of the predictor)
    nr_pred = torch.gather(nr, -1, predictor)
    slope = sigma2 - explained_var - eps
    # (n_r - 1) eps - V is one fused multiply-add in the reference
    cap = torch.where(slope > 0,
                      fma(nr - 1.0, eps, -explained_var)
                      / torch.clamp(slope, min=1e-20),
                      inf)
    cap = torch.clamp(cap, min=0.0)
    ns = torch.floor(torch.minimum(cap, nr_pred) + 1e-4)
    # 1e for unobserved (straggler) streams: at least one imputed sample
    ns = torch.where((nr < 0.5) & (nr_pred >= 1.0),
                     torch.clamp(ns, min=1.0), ns)

    obj = (q / torch.clamp(nr + ns, min=1.0)).sum(-1)
    return nr.to(torch.int32), ns.to(torch.int32), obj
