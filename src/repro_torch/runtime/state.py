"""The scan runtime's carry — port of ``repro.runtime.state``.

One :class:`RuntimeState` is the entire mutable state of the streaming
system: the controller's EWMAs, running per-stream moment sums and the
window cursor that keys the sampler, on an adaptive run the drift gate
and its cached plan, and on a chaos run the liveness mask and the
gap-serving memory.  The port updates it in place from window to
window (the reference's functional carry becomes a dataclass of tensors
the step overwrites).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.types import Tensor


@dataclasses.dataclass
class ControllerState:
    """The fleet budget controller's mutable fields (f32)."""

    demand: Tensor        # (E,) EWMA sqrt(err * budget)
    r2: Tensor            # (E,) EWMA explained-variance fraction
    lag: Tensor           # (E,) EWMA WAN arrival lag (ms); 0 at zero latency
    lag_seen: Tensor      # (E,) bool — per-site lag EWMA seeded
    seen: Tensor          # () bool — any observation yet
    last_budgets: Tensor  # (E,) raw (un-floored) budgets of the last window


@dataclasses.dataclass
class StreamTotals:
    """Running per-stream moment sums across every ingested window."""

    count: Tensor         # (E, k) f32 tuples seen
    s1: Tensor            # (E, k) f32 running sum
    s2: Tensor            # (E, k) f32 running sum of squares


@dataclasses.dataclass
class RuntimeState:
    """Everything the streaming engine carries window to window."""

    window_id: int        # next window to ingest (the RNG cursor)
    controller: ControllerState
    totals: StreamTotals
    # adaptive re-planning carry (repro_torch.adaptive.AdaptiveCarry: the
    # EW gate + the cached FleetPlan); None when every window plans
    adaptive: Optional["AdaptiveCarry"] = None
    # chaos carry (repro_torch.chaos.ChaosCarry: the last liveness mask +
    # the gap-serving estimate memory); None outside chaos runs
    chaos: Optional["ChaosCarry"] = None


def init_state(n_sites: int, k: int, equal_share: float,
               device=None) -> RuntimeState:
    """Fresh state, as ``BudgetController`` starts."""
    dev = resolve_device(device)
    e = n_sites

    def f32(*shape, fill=0.0):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    return RuntimeState(
        window_id=0,
        controller=ControllerState(
            demand=f32(e, fill=1.0), r2=f32(e), lag=f32(e),
            lag_seen=torch.zeros(e, dtype=torch.bool, device=dev),
            seen=torch.zeros((), dtype=torch.bool, device=dev),
            last_budgets=f32(e, fill=equal_share)),
        totals=StreamTotals(count=f32(e, k), s1=f32(e, k), s2=f32(e, k)))


def state_from_numpy(tree, device=None) -> RuntimeState:
    """A reference ``RuntimeState`` (``jax.tree.map(np.asarray, state)``,
    or any object with the same attribute layout) as a port state.

    An adaptive carry (the gate, its ``EWStats`` and the cached
    ``FleetPlan``) and a chaos carry (the liveness mask and the served
    tables) come across.
    """
    dev = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    c, tot = tree.controller, tree.totals
    return RuntimeState(
        window_id=int(np.asarray(tree.window_id)),
        controller=ControllerState(
            demand=t(c.demand), r2=t(c.r2), lag=t(c.lag),
            lag_seen=t(c.lag_seen, torch.bool), seen=t(c.seen, torch.bool),
            last_budgets=t(c.last_budgets)),
        totals=StreamTotals(count=t(tot.count), s1=t(tot.s1), s2=t(tot.s2)),
        adaptive=_adaptive_from_numpy(getattr(tree, "adaptive", None), t,
                                      dev),
        chaos=_chaos_from_numpy(getattr(tree, "chaos", None), t))


def _chaos_from_numpy(carry, t):
    """A reference ``ChaosCarry`` as the port's (None stays None)."""
    if carry is None:
        return None
    from repro_torch.chaos import ChaosCarry
    return ChaosCarry(live=t(carry.live, torch.bool),
                      served={q: t(v) for q, v in carry.served.items()})


def _adaptive_from_numpy(carry, t, dev):
    """A reference ``AdaptiveCarry`` as the port's (None stays None)."""
    if carry is None:
        return None
    from repro_torch.adaptive import AdaptiveCarry, EWStats, GateState
    from repro_torch.planning.batched import FleetPlan
    g = carry.gate
    ew = EWStats(**{f.name: t(getattr(g.ew, f.name))
                    for f in dataclasses.fields(EWStats)})
    ints = {"det_age", "windows_since", "replans", "reuses", "fires",
            "lag_sum", "lag_events"}
    gate = GateState(ew=ew, **{
        f.name: t(getattr(g, f.name),
                  torch.int32 if f.name in ints else torch.float32)
        for f in dataclasses.fields(GateState) if f.name != "ew"})
    plan = FleetPlan.from_numpy(
        {f.name: getattr(carry.plan, f.name)
         for f in dataclasses.fields(FleetPlan)}, device=dev)
    return AdaptiveCarry(gate=gate, plan=plan)


def state_to_numpy(state: RuntimeState) -> RuntimeState:
    """The same state with the controller's and the totals' tensors moved
    to host numpy (the adaptive and chaos carries stay where they are)."""
    def host(obj):
        return type(obj)(**{f.name: getattr(obj, f.name).cpu().numpy()
                            for f in dataclasses.fields(obj)})

    return RuntimeState(window_id=state.window_id,
                        controller=host(state.controller),
                        totals=host(state.totals), adaptive=state.adaptive,
                        chaos=state.chaos)
