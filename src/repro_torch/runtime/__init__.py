"""The scan runtime of the port (fleets and single edges): controller,
window step, scan loop.

Scenarios select a runtime through the RUNTIMES registry:

  * ``"scan"`` / ``"scan_steps"`` — :class:`~repro_torch.runtime.scan.ScanRuntime`
    (one Python loop over the windows; the two names run the same loop).
  * ``"event"`` — the fleet event loop,
    :class:`~repro_torch.api.experiment.FleetRuntime` (imported when
    built: it lives beside the front door, as in the reference).
  * ``"scan_sharded"`` — :class:`~repro_torch.runtime.sharded.ShardedScanRuntime`
    (the same loop on every rank of the site group, each over its own
    rows of the fleet; fleets only, bitwise the ``"scan"`` run).
"""
from __future__ import annotations

from repro_torch.api.registry import RUNTIMES
from repro_torch.runtime.controller import (CtrlParams, controller_budgets,
                                            controller_update, water_fill)
from repro_torch.runtime.report import aggregate_fleet
from repro_torch.runtime.scan import ScanRuntime
from repro_torch.runtime.sharded import ShardedScanRuntime
from repro_torch.runtime.state import (ControllerState, RuntimeState,
                                       StreamTotals, init_state,
                                       state_from_numpy, state_to_numpy)
from repro_torch.runtime.step import (SCAN_QUERIES, draw_fleet_samples,
                                      make_window_step, sample_fleet)

__all__ = [
    "CtrlParams", "ControllerState", "RuntimeState", "StreamTotals",
    "ScanRuntime", "SCAN_QUERIES", "ShardedScanRuntime", "aggregate_fleet",
    "controller_budgets", "controller_update", "draw_fleet_samples",
    "event_runtime", "init_state", "make_window_step", "sample_fleet",
    "state_from_numpy", "state_to_numpy", "water_fill",
]


def event_runtime(**kwargs):
    """``runtime="event"``: a :class:`~repro_torch.api.experiment.
    FleetRuntime` built from ``kwargs``."""
    from repro_torch.api.experiment import FleetRuntime
    return FleetRuntime(**kwargs)


RUNTIMES.register("event", event_runtime)
RUNTIMES.register("scan", ScanRuntime)
RUNTIMES.register("scan_steps", ScanRuntime)
RUNTIMES.register("scan_sharded", ShardedScanRuntime)
