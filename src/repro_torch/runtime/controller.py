"""The fleet budget controller on tensors — port of
``repro.runtime.controller``.

``water_fill`` is the clip-and-redistribute allocator with the host
version's early ``break`` written as a ``where`` guard;
``controller_budgets`` / ``controller_update`` are the budgets()/update()
pair, with the demand signal routed statically.  On a chaos run both take
the window's (E,) liveness mask: dead sites get no budget, their share is
water-filled over the live fleet, and their EWMAs hold.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.stats import host_blocked_sum, sqrt
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


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def water_fill(demand, total: float, lo, hi, iters: int = 8) -> np.ndarray:
    """Budgets proportional to demand, clipped to [lo, hi] and summing to
    ``total`` (8 redistribution passes), on (E,) f32 host arrays.

    Every operation is f32, as the reference's compiled graph has it, and
    the fleet sums are in its reduction order (:func:`~repro_torch.core.
    stats.host_blocked_sum`): their last bits reach the controller's
    EWMAs, which a checkpoint carries.  The host runs it because each of
    the ~17 sums would be ~60 launches on the card.
    """
    f32 = np.float32
    total = f32(total)
    d = np.where(np.isfinite(demand), demand, f32(0.0))
    # no usable signal: uniform in the box instead of NaN-poisoning the carry
    if not (d > 0).any():
        d = np.ones_like(d)
    d = np.maximum(d, f32(1e-12))
    b = np.minimum(np.maximum(total * d / host_blocked_sum(d), lo), hi)
    for _ in range(iters):
        excess = total - host_blocked_sum(b)
        movable = np.where(excess > 0, b < hi, b > lo)
        w = d * movable
        wsum = host_blocked_sum(w)
        moved = np.minimum(np.maximum(
            b + excess * w / (wsum if wsum > 0 else f32(1.0)), lo), hi)
        if abs(excess) >= f32(1e-9) and wsum > 0:
            b = moved
    return b


def controller_budgets(state: ControllerState, p: CtrlParams, live=None,
                       shard=None):
    """(E,) raw per-window budgets, on the state's device (computed on the
    host: :func:`water_fill`).

    ``live``: the window's (E,) bool membership mask on a chaos run.
    Dead sites' ceiling, floor and demand collapse to 0, so the water-fill
    spreads their share over the live fleet, and they get 0.  None (no
    chaos) skips the masking; an all-live mask gives the same budgets
    bitwise.

    ``shard`` (the sharded scan runtime, a
    :class:`~repro_torch.parallel.SiteShard`): ``state`` and ``live`` hold
    this rank's rows.  The water-fill's sums follow the reduction order of
    exactly E sites, so the demand and liveness rows are gathered to the
    unpadded fleet (one gather a window), filled there, and this rank's
    rows kept; ``p.n_sites`` stays the fleet's count.
    """
    f32 = np.float32
    eq = p.equal_share
    dev = state.demand.device
    livf = None if live is None else _host(live).astype(f32)
    if p.mode == "static" or not bool(state.seen):
        e = state.demand.shape[0]
        static_b = np.minimum(np.full(e, eq, f32),
                              np.full(e, p.ceil_mult * eq, f32))
        if livf is not None:
            static_b = static_b * livf
        return torch.as_tensor(static_b, device=dev)
    demand = _host(state.demand)
    if shard is not None:
        demand, livf = shard.gather_sites(demand, livf)
    e = demand.shape[0]
    hi = np.full(e, p.ceil_mult * eq, f32)
    if livf is not None:
        hi = hi * livf
        demand = demand * livf
    lo = np.minimum(np.full(e, p.floor_mult * eq, f32), hi)
    if p.cost_discount is not None:
        demand = demand / np.asarray(p.cost_discount, f32)
    reb = water_fill(demand, p.total_budget, lo, hi)
    if livf is not None:
        # an all-dead window fills a [0, 0] box; ship 0 all the same
        reb = reb * livf
    if shard is not None:
        reb = shard.local_rows(reb)
    return torch.as_tensor(reb, device=dev)


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
                      obs_err, r2, objective, live=None) -> None:
    """``BudgetController.update`` with ``last_budgets = raw_budgets``, at
    zero WAN latency.  Updates ``state`` in place.

    ``live`` (chaos runs): dead sites' demand and r2 EWMAs hold their
    value, so a site that rejoins resumes from its last known demand.
    """
    a = p.ewma
    lag_obs = torch.zeros_like(state.lag)      # zero latency: every lag is 0
    state.lag = torch.where(state.lag_seen,
                            (1 - a) * state.lag + a * lag_obs, lag_obs)
    state.lag_seen = torch.ones_like(state.lag_seen)

    b = torch.clamp(raw_budgets, min=1.0)
    pred_err = sqrt(torch.clamp(objective, min=0.0))
    err = torch.nan_to_num(_signal(p.demand_signal, obs_err, pred_err),
                           nan=1.0)
    demand_new = sqrt(torch.clamp(err, min=1e-9) * b)
    r2_new = torch.clamp(torch.nan_to_num(r2), 0.0, 1.0)
    demand = torch.where(state.seen, (1 - a) * state.demand + a * demand_new,
                         demand_new)
    r2_mix = torch.where(state.seen, (1 - a) * state.r2 + a * r2_new, r2_new)
    if live is not None:
        demand = torch.where(live, demand, state.demand)
        r2_mix = torch.where(live, r2_mix, state.r2)
    state.demand = demand
    state.r2 = r2_mix
    state.seen = torch.ones_like(state.seen)
    state.last_budgets = raw_budgets
