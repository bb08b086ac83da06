"""Adaptive planning: online correlation tracking + re-plan-on-drift.

Port of ``repro.adaptive`` for the scan runtime.  The EW estimator
(:mod:`repro_torch.adaptive.stats`, on the ``stream_stats_fleet``
kernel) tracks each site's cross-stream correlation, a detector
(:mod:`repro_torch.adaptive.drift`, the ``DRIFT_DETECTORS`` registry)
watches its drift from the correlation the cached plan assumed, and the
policy (:mod:`repro_torch.adaptive.policy`) re-plans only when the
detector fires.  Wired through ``ScenarioConfig.adaptive``; an absent
spec plans every window.  The scan runs the gate inside its step; the
fleet event loop through :class:`~repro_torch.adaptive.AdaptivePolicy`.
"""
from repro_torch.adaptive.drift import det_init, detector_update
from repro_torch.adaptive.policy import (AdaptiveCarry, AdaptivePolicy,
                                         AdaptiveSpec, GateState,
                                         gate_counters, gate_init,
                                         gate_update, make_adaptive_carry)
from repro_torch.adaptive.stats import (EWStats, ew_corr, ew_cov, ew_decay,
                                        ew_from_dict, ew_init, ew_mean_var,
                                        ew_to_dict, ew_update, window_sums)

__all__ = [
    "AdaptiveCarry", "AdaptivePolicy", "AdaptiveSpec", "EWStats",
    "GateState", "det_init", "detector_update", "ew_corr", "ew_cov",
    "ew_decay", "ew_from_dict", "ew_init", "ew_mean_var", "ew_to_dict",
    "ew_update", "gate_counters", "gate_init", "gate_update",
    "make_adaptive_carry", "window_sums",
]
