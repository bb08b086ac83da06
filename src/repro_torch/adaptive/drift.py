"""Drift detectors: decide, per window, whether the cached plan is stale.

Port of ``repro.adaptive.drift``.  A detector looks at one scalar ``dev``
per window — the largest off-diagonal |EW correlation − the correlation
the current plan assumed| over all E sites — and answers "has the plan's
correlation assumption drifted?".  Detectors register in
:data:`repro_torch.api.registry.DRIFT_DETECTORS`.

Every detector shares one state layout, 0-d tensors:

    accum  () f32   detector-specific accumulator (0 for the degenerates)
    age    () i32   consecutive windows the detector has been "elevated"

so a fire after ``age'`` elevated windows has lag ``age' - 1``.  The
Python-float knobs enter the f32 arithmetic rounded to f32, as the
reference's compiler folds them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.api.registry import DRIFT_DETECTORS
from repro_torch.core.stats import f32_const
from repro_torch.core.types import Tensor


def det_init(device=None) -> dict:
    """Zero detector state (shared layout for every registered detector)."""
    return {"accum": torch.zeros((), dtype=torch.float32, device=device),
            "age": torch.zeros((), dtype=torch.int32, device=device)}


def _aged(fire: Tensor, elevated: Tensor, age: Tensor
          ) -> Tuple[Tensor, Tensor]:
    """Advance the elevated-age counter and derive this fire's lag."""
    age = torch.where(elevated, age + 1, torch.zeros_like(age)) \
        .to(torch.int32)
    lag = torch.clamp(age - 1, min=0) * fire.to(torch.int32)
    return age, lag


@DRIFT_DETECTORS.register("threshold")
def _threshold(state: dict, dev: Tensor, spec) -> Tuple[dict, Tensor, Tensor]:
    """Fire as soon as the deviation exceeds ``spec.threshold``."""
    fire = dev > f32_const(spec.threshold)
    age, lag = _aged(fire, fire, state["age"])
    accum = torch.where(fire, state["accum"] + dev,
                        torch.zeros_like(dev)).to(torch.float32)
    return {"accum": accum, "age": age}, fire, lag


@DRIFT_DETECTORS.register("page_hinkley")
def _page_hinkley(state: dict, dev: Tensor, spec
                  ) -> Tuple[dict, Tensor, Tensor]:
    """Page–Hinkley / one-sided CUSUM: sum the per-window excess over the
    drift allowance ``ph_delta`` (floored at zero) and fire when the
    evidence passes ``ph_lambda``."""
    accum = torch.clamp(state["accum"] + dev - f32_const(spec.ph_delta),
                        min=0.0).to(torch.float32)
    fire = accum > f32_const(spec.ph_lambda)
    age, lag = _aged(fire, accum > 0.0, state["age"])
    return {"accum": torch.where(fire, torch.zeros_like(accum), accum),
            "age": age}, fire, lag


@DRIFT_DETECTORS.register("always")
def _always(state: dict, dev: Tensor, spec) -> Tuple[dict, Tensor, Tensor]:
    """Fire every window → re-plan every window (the legacy-parity pin)."""
    del spec
    return ({"accum": torch.zeros_like(dev), "age": state["age"] * 0},
            torch.ones((), dtype=torch.bool, device=dev.device),
            torch.zeros((), dtype=torch.int32, device=dev.device))


@DRIFT_DETECTORS.register("never")
def _never(state: dict, dev: Tensor, spec) -> Tuple[dict, Tensor, Tensor]:
    """Never fire → plan once, reuse forever (the ablation floor)."""
    del spec
    return ({"accum": torch.zeros_like(dev), "age": state["age"] * 0},
            torch.zeros((), dtype=torch.bool, device=dev.device),
            torch.zeros((), dtype=torch.int32, device=dev.device))


def detector_update(name: str, state: dict, dev: Tensor, spec
                    ) -> Tuple[dict, Tensor, Tensor]:
    """Dispatch by name; returns ``(state', fire () bool, lag () i32)``.
    Unknown names raise ``UnknownComponentError`` listing the detectors."""
    return DRIFT_DETECTORS.get(name)(state, dev, spec)
