"""Declarative fault injection and dynamic fleet membership — port of
``repro.chaos`` for the scan runtime and the fleet event loop.

A :class:`ChaosSpec` (``ScenarioConfig.chaos``) describes site flaps,
regional outages, mid-run joins and a deterministic random-flap process;
all of it reduces to one host-computed boolean liveness table
(:func:`liveness_table`, numpy, bitwise the reference's).  The scan step
masks dead sites end to end and gap-serves them from a
:class:`ChaosCarry`; the event loop gives a dead site no budget, sends
nothing for it and lets its cloud gap-serve (``api/experiment.py::
FleetRuntime``); :func:`chaos_metrics` rolls a run into recovery and
degradation numbers.
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
