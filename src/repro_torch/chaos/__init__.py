"""Declarative fault injection and dynamic fleet membership — port of
``repro.chaos`` for the scan runtime.

A :class:`ChaosSpec` (``ScenarioConfig.chaos``) describes site flaps,
regional outages, mid-run joins and a deterministic random-flap process;
all of it reduces to one host-computed boolean liveness table
(:func:`liveness_table`, numpy, bitwise the reference's).  The scan step
masks dead sites end to end and gap-serves them from a
:class:`ChaosCarry`; :func:`chaos_metrics` rolls a run into recovery and
degradation numbers.  Chaos on the event loop is not ported yet
(ROADMAP.md: queue 1, 'Event path').
"""
from __future__ import annotations

from repro_torch.chaos.carry import ChaosCarry, make_chaos_carry
from repro_torch.chaos.metrics import (chaos_metrics, masked_nrmse,
                                       recovery_windows)
from repro_torch.chaos.spec import (FAULTS, ChaosSpec, liveness_table,
                                    padded_liveness_table)

__all__ = [
    "FAULTS", "ChaosCarry", "ChaosSpec", "chaos_metrics", "liveness_table",
    "make_chaos_carry", "masked_nrmse", "padded_liveness_table",
    "recovery_windows",
]
