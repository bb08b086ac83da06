"""Cross-edge WAN budget rebalancing (the fleet-wide resource controller) —
port of ``repro.fleet.controller`` for the event loop (host numpy, f64,
bitwise the reference's).

The paper fixes one sampling budget per edge.  With E sites sharing one WAN
budget the equal split is wasteful: a strongly-correlated site reconstructs
accurately from few real samples (imputation covers the rest for free),
while a weakly-correlated site is starved.  Each window the controller
water-fills the fleet budget across sites proportionally to a demand signal.

Demand model: empirically (and in the eq.-2 relaxation) a site's
reconstruction error decays like err_s(b) ~ A_s / b, where A_s folds
together the site's stream volatility (CoV) AND how much free imputation its
correlation structure yields — strongly-correlated sites have small A_s.
Minimizing the fleet error sum(A_s / b_s) subject to sum(b_s) = B equalizes
the marginal values A_s / b_s^2, i.e. b*_s ∝ sqrt(A_s).  A_s is observable
at the edge for free as err_s · b_s (err_s: the edge-local reconstruction
error of its own payload against its own cached window), so the controller
tracks

    demand_s = EWMA[ sqrt(obs_err_s · b_s) ]

whose water-filled fixed point is exactly b ∝ sqrt(A).  Before any error
observation exists (or for planners that do not report one) the fallback
demand uses the solver's predicted error sqrt(obj_s) in place of obs_err.
Budgets are clipped to [floor_mult, ceil_mult] x the equal share so no site
is ever starved or monopolizes the uplink, and renormalized so the fleet
total is conserved.

This is the event loop's controller.  The scan's
(:mod:`repro_torch.runtime.controller`) is a different function: it
mirrors the scan's compiled f32 arithmetic, this one the reference's host
f64 arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.api.registry import DEMAND_SIGNALS


# --------------------------------------------------------------------------
# demand-signal registry: how a window's per-site observations combine into
# the error estimate the sqrt(err · b) demand tracks.  Each entry maps
# (obs_err (E,), pred_err (E,) or None) -> (E,) error.  ScenarioConfig
# validates ControllerSpec.demand_signal against these names at
# construction instead of failing deep in the runtime.
# --------------------------------------------------------------------------

def _obs_err(obs: np.ndarray, pred: Optional[np.ndarray]) -> np.ndarray:
    """Edge-local observed error; solver-predicted error fills the gaps
    (sites with no finite observation yet).  The default — bit-for-bit the
    pre-registry controller."""
    if pred is None:
        return obs
    return np.where(np.isfinite(obs) & (obs > 0), obs, pred)


def _pred_err(obs: np.ndarray, pred: Optional[np.ndarray]) -> np.ndarray:
    """Solver-predicted error (sqrt of the relaxed eq.-2 objective) alone —
    the planner's own forecast, useful when the edge-local proxy is noisy.
    Falls back to the observed error when no objective is reported (the
    host engine's payload path carries none)."""
    return obs if pred is None else pred


def _max_err(obs: np.ndarray, pred: Optional[np.ndarray]) -> np.ndarray:
    """Pessimistic max of observed and predicted error — the conservative
    signal for deployments dominated by tail-sensitive queries (VAR/MAX
    care about a different budget than AVG)."""
    if pred is None:
        return obs
    return np.maximum(np.where(np.isfinite(obs), obs, 0.0), pred)


DEMAND_SIGNALS.register("obs_err", _obs_err)
DEMAND_SIGNALS.register("pred_err", _pred_err)
DEMAND_SIGNALS.register("max_err", _max_err)


def water_fill(demand: np.ndarray, total: float, lo: np.ndarray,
               hi: np.ndarray, iters: int = 8) -> np.ndarray:
    """Allocate ``total`` proportionally to ``demand`` within [lo, hi].

    Iterative clip-and-redistribute; exact when the box constraints leave
    slack, best-effort (total preserved up to the feasible box) otherwise.

    Degenerate demand is guarded here rather than NaN-poisoning the fleet:
    non-finite entries (an edge reporting inf error) are treated as absent,
    and when no site reports positive demand at all the split falls back to
    uniform within the box.  Positive finite demand takes the exact legacy
    arithmetic path.
    """
    d = np.asarray(demand, np.float64)
    d = np.where(np.isfinite(d), d, 0.0)
    if not (d > 0).any():
        d = np.ones_like(d)          # no usable signal: uniform in the box
    d = np.maximum(d, 1e-12)
    lo = np.broadcast_to(np.asarray(lo, np.float64), d.shape)
    hi = np.broadcast_to(np.asarray(hi, np.float64), d.shape)
    b = np.clip(total * d / d.sum(), lo, hi)
    for _ in range(iters):
        excess = total - b.sum()
        if abs(excess) < 1e-9:
            break
        movable = (b < hi) if excess > 0 else (b > lo)
        if not movable.any():
            break
        w = d * movable
        b = np.clip(b + excess * w / w.sum(), lo, hi)
    return b


@dataclasses.dataclass
class BudgetController:
    """Per-window fleet budget allocator with EWMA demand tracking."""

    total_budget: float            # fleet-wide real-sample budget per window
    n_sites: int
    mode: str = "rebalance"        # "rebalance" | "static"
    floor_mult: float = 0.3        # min share, x equal split
    ceil_mult: float = 3.0         # max share, x equal split
    ewma: float = 0.5              # weight of the newest observation
    site_capacity: Optional[np.ndarray] = None   # (E,) tuples cached/window
    link_cost: Optional[np.ndarray] = None       # (E,) relative $/byte/uplink
    cost_aware: bool = False       # weight demand by link cost (see budgets)
    demand_signal: str = "obs_err"  # DEMAND_SIGNALS registry name
    query_split: Optional[float] = None    # tail tranche fraction in (0, 1)
    tail_demand_signal: str = "max_err"    # DEMAND_SIGNALS name for the tail

    def __post_init__(self):
        self._signal = DEMAND_SIGNALS.get(self.demand_signal)
        self._tail_signal = DEMAND_SIGNALS.get(self.tail_demand_signal)
        if (self.query_split is not None
                and not 0.0 < self.query_split < 1.0):
            raise ValueError(f"query_split must lie in (0, 1), got "
                             f"{self.query_split!r}")
        self._demand = np.ones(self.n_sites)
        self._demand_tail = np.ones(self.n_sites)
        self._r2 = np.zeros(self.n_sites)
        self._lag = np.zeros(self.n_sites)
        self._lag_seen = np.zeros(self.n_sites, bool)
        self._last_budgets = np.full(self.n_sites, self.equal_share)
        self._seen = False

    @property
    def correlation_strength(self) -> np.ndarray:
        """(E,) EWMA of observed per-site explained-variance fraction."""
        return self._r2.copy()

    @property
    def arrival_lag_ms(self) -> np.ndarray:
        """(E,) EWMA of observed per-site WAN delivery lag (send -> cloud
        arrival, ms) — async-transport telemetry.  A laggy site's payloads
        answer queries stale; operators read this next to ``demand`` to
        decide whether bytes or the link itself are the bottleneck."""
        return self._lag.copy()

    @property
    def equal_share(self) -> float:
        return self.total_budget / self.n_sites

    def budgets(self, live: Optional[np.ndarray] = None) -> np.ndarray:
        """(E,) per-site budgets for the next window (floats; callers floor).

        With ``cost_aware`` on, demand is discounted by the uplink's
        relative $/byte before water-filling: the Lagrangian of
        min sum_s A_s / b_s + lambda sum_s c_s b_s gives b*_s ∝
        sqrt(A_s / c_s), i.e. demand_s / sqrt(c_s) — expensive uplinks
        yield budget first at equal error pressure, cutting fleet WAN $
        while conserving the fleet-wide sample total.  Off (the default)
        this is bit-for-bit the cost-blind controller.

        ``live`` (chaos/membership, repro_torch.chaos): an (E,) bool mask.  Dead
        sites get budget 0 and their share water-fills over the live ones
        (their floor/ceiling collapse to 0 so the redistribution happens
        inside the same allocator).  ``None`` — and an all-True mask — is
        the legacy fixed-membership arithmetic, bitwise.  The equal share
        stays ``total/n_sites`` (the membership-invariant reference the
        floors, ceilings and recovery metrics are defined against).
        """
        liv = None
        if live is not None:
            liv = np.asarray(live, bool)
            if liv.shape != (self.n_sites,):
                raise ValueError(f"live mask shape {liv.shape} != "
                                 f"({self.n_sites},)")
            if liv.all():
                liv = None               # all-live == legacy, bitwise
        eq = self.equal_share
        hi = np.full(self.n_sites, self.ceil_mult * eq)
        if self.site_capacity is not None:
            hi = np.minimum(hi, np.asarray(self.site_capacity, np.float64))
        if self.mode == "static" or not self._seen:
            b = np.minimum(np.full(self.n_sites, eq), hi)
            if liv is not None:          # static never redistributes
                b = b * liv
        elif liv is not None and not liv.any():
            b = np.zeros(self.n_sites)   # an all-dead fleet ships nothing
        else:
            lo = np.minimum(np.full(self.n_sites, self.floor_mult * eq), hi)
            demand = self._demand
            if liv is not None:
                lo, hi = lo * liv, hi * liv
                demand = demand * liv
            discount = None
            if self.cost_aware and self.link_cost is not None:
                c = np.asarray(self.link_cost, np.float64)
                c = np.maximum(c / max(float(c.mean()), 1e-12), 1e-6)
                discount = np.sqrt(c)
                demand = demand / discount
            if self.query_split is None:
                b = water_fill(demand, self.total_budget, lo, hi)
            else:
                # two-tranche split: the tail tranche (fraction w) follows
                # the tail demand signal, the rest the primary one; each
                # tranche water-fills its scaled box so the sum respects
                # [lo, hi] and the fleet total is conserved
                w = self.query_split
                tail = self._demand_tail
                if liv is not None:
                    tail = tail * liv
                if discount is not None:
                    tail = tail / discount
                b = (water_fill(demand, (1 - w) * self.total_budget,
                                (1 - w) * lo, (1 - w) * hi)
                     + water_fill(tail, w * self.total_budget,
                                  w * lo, w * hi))
        self._last_budgets = b
        return b

    def update(self, obs_err: np.ndarray, r2: np.ndarray,
               objective=None, arrival_lag=None,
               obs_err_tail=None, live=None) -> None:
        """Feed one window's per-site observations.

        obs_err: (E,) edge-local reconstruction error (any consistent scale).
            Already internalizes correlation strength: an imputable site
            reaches low error at low budget, shrinking its A_s estimate.
        r2: (E,) mean explained-variance fraction — tracked as the
            ``correlation_strength`` telemetry (reporting/diagnostics).
        objective: (E,) the solver's relaxed eq.-2 value — the predicted
            squared error, used in place of obs_err when that is missing.
        arrival_lag: (E,) mean WAN delivery lag (ms) of payloads the cloud
            drained this window; NaN where nothing arrived (the previous
            EWMA is kept).  Tracked as ``arrival_lag_ms`` telemetry.
        obs_err_tail: (E,) edge-local error of the tail queries (VAR/MAX),
            feeding the tail tranche when ``query_split`` is set; ``None``
            falls back to ``obs_err`` through the tail demand signal.
        live: (E,) bool membership mask (chaos runs).  Dead sites shipped
            nothing, so their demand/r2 EWMAs are frozen at the pre-outage
            value — a rejoining site restarts from its last known demand
            instead of the nan->1.0 default, which is what makes recovery
            fast.  ``None``/all-True is the legacy arithmetic, bitwise.
        """
        liv = None
        if live is not None:
            liv = np.asarray(live, bool)
            if liv.all():
                liv = None               # all-live == legacy, bitwise
        if arrival_lag is not None:
            lag = np.asarray(arrival_lag, np.float64)
            ok = np.isfinite(lag)
            # a site's first finite observation seeds its EWMA outright —
            # never blend with the synthetic 0.0 initializer
            mixed = np.where(self._lag_seen,
                             (1 - self.ewma) * self._lag
                             + self.ewma * np.where(ok, lag, 0.0),
                             np.where(ok, lag, 0.0))
            self._lag = np.where(ok, mixed, self._lag)
            self._lag_seen |= ok
        b = np.maximum(self._last_budgets, 1.0)
        pred_err = (None if objective is None
                    else np.sqrt(np.maximum(np.asarray(objective), 0.0)))
        err = self._signal(np.asarray(obs_err, np.float64), pred_err)
        err = np.nan_to_num(err, nan=1.0)
        demand = np.sqrt(np.maximum(err, 1e-9) * b)     # sqrt(A_s) estimate
        tail_obs = np.asarray(obs_err if obs_err_tail is None
                              else obs_err_tail, np.float64)
        tail_err = np.nan_to_num(self._tail_signal(tail_obs, pred_err),
                                 nan=1.0)
        demand_tail = np.sqrt(np.maximum(tail_err, 1e-9) * b)
        a = self.ewma
        r2c = np.clip(np.nan_to_num(np.asarray(r2, np.float64)), 0.0, 1.0)
        prev_demand, prev_tail, prev_r2 = (
            self._demand, self._demand_tail, self._r2)
        if not self._seen:
            self._demand, self._r2 = demand, r2c
            self._demand_tail = demand_tail
            self._seen = True
        else:
            self._demand = (1 - a) * self._demand + a * demand
            self._demand_tail = (1 - a) * self._demand_tail + a * demand_tail
            self._r2 = (1 - a) * self._r2 + a * r2c
        if liv is not None:              # dead sites: hold pre-outage EWMAs
            self._demand = np.where(liv, self._demand, prev_demand)
            self._demand_tail = np.where(liv, self._demand_tail, prev_tail)
            self._r2 = np.where(liv, self._r2, prev_r2)
