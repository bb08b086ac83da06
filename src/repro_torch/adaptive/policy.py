"""Re-plan policy: cache the last plan, reuse it until drift fires.

Port of ``repro.adaptive.policy`` for the scan runtime and the fleet
event loop:

* :class:`AdaptiveSpec` — the scenario-level knob block, validated at
  construction and JSON-round-trippable.
* :class:`GateState` — what the policy carries between windows: the EW
  sums, the correlation snapshot the cached plan assumed, the detector
  scalars, the cooldown clock and the re-plan counters.
* :func:`gate_update` — one window of the policy.
* :class:`AdaptivePolicy` — the fleet event loop's policy: the gate on
  the device, the cached plan and the planner callback on the host.

Decision rule per window (after folding the window into the EW sums)::

    dev    = max off-diagonal |ew_corr - assumed_corr|   over all E sites
    fire   = detector(dev)  AND  at least one plan exists already
    cool   = windows_since_replan + 1 >= min_replan_interval
    replan = first_window  OR  (fire AND cool)

On a sharded scan the max closes over the site group
(:meth:`~repro_torch.parallel.SiteShard.max_over_sites`); max is exact,
so the decision is bitwise the unsharded gate's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.adaptive import drift as drift_mod
from repro_torch.adaptive import stats as ew_mod
from repro_torch.api.registry import DRIFT_DETECTORS
from repro_torch.core.types import Tensor


@dataclasses.dataclass(frozen=True)
class AdaptiveSpec:
    """Adaptive re-planning knobs (``ScenarioConfig.adaptive``).

    ``adaptive=None`` is the legacy plan-every-window behaviour.  Fields
    beyond ``detector`` only matter to the detectors that read them.
    """

    detector: str = "threshold"          # DRIFT_DETECTORS name
    halflife: Optional[float] = 8.0      # EW halflife (windows); None = off
    threshold: float = 0.1               # max |corr dev| bound ('threshold')
    ph_delta: float = 0.01               # drift allowance ('page_hinkley')
    ph_lambda: float = 0.25              # evidence bound ('page_hinkley')
    min_replan_interval: int = 1         # cooldown: windows between re-plans

    def __post_init__(self):
        DRIFT_DETECTORS.get(self.detector)      # fail fast with alternatives
        if self.halflife is not None and not float(self.halflife) > 0.0:
            raise ValueError(f"halflife must be > 0 or None, "
                             f"got {self.halflife!r}")
        if not self.threshold > 0.0:
            raise ValueError(f"threshold must be > 0, got {self.threshold!r}")
        if self.ph_delta < 0.0:
            raise ValueError(f"ph_delta must be >= 0, got {self.ph_delta!r}")
        if not self.ph_lambda > 0.0:
            raise ValueError(f"ph_lambda must be > 0, got {self.ph_lambda!r}")
        if int(self.min_replan_interval) < 1:
            raise ValueError(f"min_replan_interval must be >= 1, "
                             f"got {self.min_replan_interval!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AdaptiveSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown AdaptiveSpec fields: {sorted(extra)}")
        return cls(**d)


@dataclasses.dataclass
class GateState:
    """Per-run adaptive carry (everything but the cached plan itself)."""

    ew: ew_mod.EWStats         # decayed stream sums, all E sites
    assumed_corr: Tensor       # (E, k, k) f32 corr snapshot behind the plan
    det_accum: Tensor          # () f32 detector accumulator
    det_age: Tensor            # () i32 detector elevated-age
    windows_since: Tensor      # () i32 windows since the last re-plan
    replans: Tensor            # () i32 planner invocations
    reuses: Tensor             # () i32 windows served from the cached plan
    fires: Tensor              # () i32 detector fires (post-cooldown or not)
    lag_sum: Tensor            # () i32 summed detection lag over fires
    lag_events: Tensor         # () i32 fires with a measurable lag


def gate_init(n_sites: int, k: int, device=None) -> GateState:
    def i0():
        return torch.zeros((), dtype=torch.int32, device=device)

    return GateState(ew=ew_mod.ew_init(n_sites, k, device=device),
                     assumed_corr=torch.zeros((n_sites, k, k),
                                              dtype=torch.float32,
                                              device=device),
                     det_accum=torch.zeros((), dtype=torch.float32,
                                           device=device),
                     det_age=i0(), windows_since=i0(), replans=i0(),
                     reuses=i0(), fires=i0(), lag_sum=i0(), lag_events=i0())


def gate_update(spec: AdaptiveSpec, gate: GateState, values: Tensor,
                counts: Tensor, *, use_kernel=None, shard=None
                ) -> Tuple[GateState, Tensor]:
    """One window of the re-plan policy; returns ``(gate', replan () bool)``.

    The caller produces a plan when ``replan`` is true and keeps it.
    ``shard`` (a :class:`~repro_torch.parallel.SiteShard`): ``gate`` and
    ``values`` hold this rank's rows, and the deviation max closes over
    the group, as the reference's ``pmax`` does; padded rows (zero values,
    zero assumed correlation) contribute 0.
    """
    ew = ew_mod.ew_update(gate.ew, values, counts,
                          ew_mod.ew_decay(spec.halflife),
                          use_kernel=use_kernel)
    corr = ew_mod.ew_corr(ew)
    k = corr.shape[-1]
    off = ~torch.eye(k, dtype=torch.bool, device=corr.device)
    dev = torch.amax(torch.abs(corr - gate.assumed_corr) * off) \
        .to(torch.float32)
    if shard is not None:
        dev = shard.max_over_sites(dev)

    det_state, fire, lag = drift_mod.detector_update(
        spec.detector, {"accum": gate.det_accum, "age": gate.det_age},
        dev, spec)
    first = gate.replans < 1
    fire = fire & ~first        # no plan yet -> nothing to be stale
    cool = (gate.windows_since + 1) >= int(spec.min_replan_interval)
    replan = first | (fire & cool)

    zero_i = torch.zeros_like(gate.det_age)
    return GateState(
        ew=ew,
        assumed_corr=torch.where(replan, corr, gate.assumed_corr),
        det_accum=torch.where(replan, torch.zeros_like(gate.det_accum),
                              det_state["accum"]).to(torch.float32),
        det_age=torch.where(replan, zero_i, det_state["age"])
        .to(torch.int32),
        windows_since=torch.where(replan, zero_i, gate.windows_since + 1)
        .to(torch.int32),
        replans=gate.replans + replan.to(torch.int32),
        reuses=gate.reuses + (~replan).to(torch.int32),
        fires=gate.fires + fire.to(torch.int32),
        lag_sum=gate.lag_sum + lag,
        lag_events=gate.lag_events + (lag > 0).to(torch.int32),
    ), replan


def gate_counters(gate: GateState) -> dict:
    """Host-side report fields from a (possibly device-resident) gate."""
    lag_events = int(gate.lag_events)
    return {
        "planner_invocations": int(gate.replans),
        "plans_reused": int(gate.reuses),
        "drift_fires": int(gate.fires),
        "detection_lag_windows": (float(int(gate.lag_sum)) / lag_events
                                  if lag_events else 0.0),
    }


@dataclasses.dataclass
class AdaptiveCarry:
    """Scan-runtime carry: the gate plus the cached plan (a ``FleetPlan``;
    kept generic so this module never imports the planning layer)."""

    gate: GateState
    plan: Any


def make_adaptive_carry(n_sites: int, k: int, device=None) -> AdaptiveCarry:
    """Initial carry.  The first window always plans, so there is no plan
    yet (the reference zero-fills one only so that both branches of its
    ``lax.cond`` agree in structure)."""
    return AdaptiveCarry(gate=gate_init(n_sites, k, device=device),
                         plan=None)


class AdaptivePolicy:
    """Event-loop wrapper around :func:`gate_update` with plan caching.

    The gate runs on the device (the scan's gate, with the counts as
    data); the cached plan and the planner callback stay on the host, so
    a re-plan window makes the event loop's exact calls in their order
    (an ``always`` detector replays the plain event loop bitwise).  One
    host read a window: the gate's ``replan``.
    """

    def __init__(self, spec: AdaptiveSpec, *, use_kernel=None, device=None):
        self.spec = spec
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self._gate: Optional[GateState] = None
        self._cached = None

    def step(self, values, counts, plan_cb):
        """Advance one window; call ``plan_cb()`` only when re-planning
        (or when nothing is cached yet).

        ``values`` (E, k, N) and ``counts`` (E, k): host arrays or tensors
        on the device.  Returns ``(plan, replanned)``, where ``plan`` is
        the fresh result or the cached object itself.
        """
        v = torch.as_tensor(values, dtype=torch.float32, device=self.device)
        c = torch.as_tensor(counts, dtype=torch.int32, device=self.device)
        if self._gate is None:
            self._gate = gate_init(v.shape[0], v.shape[1],
                                   device=self.device)
        self._gate, replan = gate_update(self.spec, self._gate, v, c,
                                         use_kernel=self.use_kernel)
        replan = bool(replan)
        if replan or self._cached is None:
            self._cached = plan_cb()
        return self._cached, replan

    def counters(self) -> dict:
        if self._gate is None:
            return {"planner_invocations": 0, "plans_reused": 0,
                    "drift_fires": 0, "detection_lag_windows": 0.0}
        return gate_counters(self._gate)
