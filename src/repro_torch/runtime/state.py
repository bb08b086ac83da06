"""The scan runtime's carry — port of ``repro.runtime.state``.

One :class:`RuntimeState` is the entire mutable state of the streaming
system: the controller's EWMAs, running per-stream moment sums and the
window cursor that keys the sampler.  The port updates it in place from
window to window (the reference's functional carry becomes a dataclass of
tensors the step overwrites).
"""
from __future__ import annotations

import dataclasses

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

    The adaptive and chaos carries are not ported yet: a tree that holds
    one raises.
    """
    if getattr(tree, "adaptive", None) is not None or \
            getattr(tree, "chaos", None) is not None:
        raise NotImplementedError(
            "adaptive and chaos carries are not ported to repro_torch yet "
            "(ROADMAP.md: queue 1, 'Adaptive' and 'Chaos')")
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
        totals=StreamTotals(count=t(tot.count), s1=t(tot.s1), s2=t(tot.s2)))


def state_to_numpy(state: RuntimeState) -> RuntimeState:
    """The same state with every tensor moved to host numpy."""
    def host(obj):
        return type(obj)(**{f.name: getattr(obj, f.name).cpu().numpy()
                            for f in dataclasses.fields(obj)})

    return RuntimeState(window_id=state.window_id,
                        controller=host(state.controller),
                        totals=host(state.totals))
