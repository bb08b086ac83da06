"""The fleet budget controller on tensors — port of
``repro.runtime.controller`` (single device, no chaos masks).

``water_fill`` is the clip-and-redistribute allocator with the host
version's early ``break`` written as a ``where`` guard;
``controller_budgets`` / ``controller_update`` are the budgets()/update()
pair, with the demand signal routed statically.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime.state import ControllerState


@dataclasses.dataclass(frozen=True)
class CtrlParams:
    """Static controller configuration."""

    total_budget: float
    n_sites: int
    mode: str = "rebalance"          # "rebalance" | "static"
    floor_mult: float = 0.3
    ceil_mult: float = 3.0
    ewma: float = 0.5
    demand_signal: str = "obs_err"   # "obs_err" | "pred_err" | "max_err"
    cost_discount: Optional[tuple] = None   # sqrt-normalized link cost

    @property
    def equal_share(self) -> float:
        return self.total_budget / self.n_sites

    @staticmethod
    def make_cost_discount(link_cost) -> tuple:
        """Host-side cost-aware discount normalization."""
        c = np.asarray(link_cost, np.float64)
        c = np.maximum(c / max(float(c.mean()), 1e-12), 1e-6)
        return tuple(np.sqrt(c).tolist())


def water_fill(demand, total: float, lo, hi, iters: int = 8):
    """Budgets proportional to demand, clipped to [lo, hi] and summing to
    ``total`` (8 redistribution passes)."""
    d = torch.where(torch.isfinite(demand), demand, torch.zeros_like(demand))
    # no usable signal: uniform in the box instead of NaN-poisoning the carry
    d = torch.where((d > 0).any(), d, torch.ones_like(d))
    d = torch.clamp(d, min=1e-12)
    b = torch.minimum(torch.maximum(total * d / d.sum(), lo), hi)
    for _ in range(iters):
        excess = total - b.sum()
        movable = torch.where(excess > 0, b < hi, b > lo)
        w = d * movable
        wsum = w.sum()
        moved = torch.minimum(torch.maximum(
            b + excess * w / torch.where(wsum > 0, wsum, torch.ones_like(wsum)),
            lo), hi)
        b = torch.where((torch.abs(excess) >= 1e-9) & (wsum > 0), moved, b)
    return b


def controller_budgets(state: ControllerState, p: CtrlParams):
    """(E,) raw per-window budgets."""
    eq = p.equal_share
    e = state.demand.shape[0]
    dev = state.demand.device
    hi = torch.full((e,), p.ceil_mult * eq, dtype=torch.float32, device=dev)
    static_b = torch.minimum(
        torch.full((e,), eq, dtype=torch.float32, device=dev), hi)
    if p.mode == "static":
        return static_b
    lo = torch.minimum(torch.full((e,), p.floor_mult * eq,
                                  dtype=torch.float32, device=dev), hi)
    demand = state.demand
    if p.cost_discount is not None:
        demand = demand / torch.as_tensor(p.cost_discount,
                                          dtype=torch.float32, device=dev)
    reb = water_fill(demand, p.total_budget, lo, hi)
    return torch.where(state.seen, reb, static_b)


def _signal(name: str, obs, pred):
    if name == "obs_err":
        return torch.where(torch.isfinite(obs) & (obs > 0), obs, pred)
    if name == "pred_err":
        return pred
    if name == "max_err":
        return torch.maximum(
            torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs)), pred)
    raise ValueError(f"demand signal {name!r} has no on-device mirror")


def controller_update(state: ControllerState, p: CtrlParams, raw_budgets,
                      obs_err, r2, objective) -> None:
    """``BudgetController.update`` with ``last_budgets = raw_budgets``, at
    zero WAN latency.  Updates ``state`` in place."""
    a = p.ewma
    lag_obs = torch.zeros_like(state.lag)      # zero latency: every lag is 0
    state.lag = torch.where(state.lag_seen,
                            (1 - a) * state.lag + a * lag_obs, lag_obs)
    state.lag_seen = torch.ones_like(state.lag_seen)

    b = torch.clamp(raw_budgets, min=1.0)
    pred_err = torch.sqrt(torch.clamp(objective, min=0.0))
    err = torch.nan_to_num(_signal(p.demand_signal, obs_err, pred_err),
                           nan=1.0)
    demand_new = torch.sqrt(torch.clamp(err, min=1e-9) * b)
    r2_new = torch.clamp(torch.nan_to_num(r2), 0.0, 1.0)
    state.demand = torch.where(state.seen,
                               (1 - a) * state.demand + a * demand_new,
                               demand_new)
    state.r2 = torch.where(state.seen, (1 - a) * state.r2 + a * r2_new, r2_new)
    state.seen = torch.ones_like(state.seen)
    state.last_budgets = raw_budgets
