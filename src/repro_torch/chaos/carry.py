"""ChaosCarry — the scan runtime's liveness and gap-serving state (port of
``repro.chaos.carry``).

While a site is dark the cloud keeps answering queries from the freshest
reconstruction that ever arrived.  On the device that memory is a
``{query: (E, k)}`` table carried from window to window: each step
overwrites the live rows with the window's fresh estimates and leaves the
dead rows as they are, so a served table holds NaN before a site's first
live window and the last estimate that arrived afterwards.

The carry rides in ``RuntimeState.chaos``; ``None`` outside chaos runs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.types import Tensor


@dataclasses.dataclass
class ChaosCarry:
    """Per-run chaos carry (membership mask + gap-serving memory)."""

    live: Tensor         # (E,) bool — membership of the last executed window
    served: dict         # {query: (E, k) f32} freshest served estimate


def make_chaos_carry(n_sites: int, k: int, qnames, device=None) -> ChaosCarry:
    """Everyone live, nothing served yet (NaN), on the run's device."""
    dev = resolve_device(device)
    return ChaosCarry(
        live=torch.ones(n_sites, dtype=torch.bool, device=dev),
        served={q: torch.full((n_sites, k), float("nan"),
                              dtype=torch.float32, device=dev)
                for q in qnames})
