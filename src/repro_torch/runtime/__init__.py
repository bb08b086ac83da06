"""The scan runtime of the port (fleets and single edges): controller,
window step, scan loop.

Scenarios select a runtime through the RUNTIMES registry:

  * ``"scan"`` / ``"scan_steps"`` — :class:`~repro_torch.runtime.scan.ScanRuntime`
    (one Python loop over the windows; the two names run the same loop).
  * ``"event"`` and ``"scan_sharded"`` are not ported yet.
"""
from __future__ import annotations

from repro_torch.api.registry import RUNTIMES
from repro_torch.runtime.controller import (CtrlParams, controller_budgets,
                                            controller_update, water_fill)
from repro_torch.runtime.report import aggregate_fleet
from repro_torch.runtime.scan import ScanRuntime
from repro_torch.runtime.state import (ControllerState, RuntimeState,
                                       StreamTotals, init_state,
                                       state_from_numpy, state_to_numpy)
from repro_torch.runtime.step import (SCAN_QUERIES, make_window_step,
                                      sample_fleet)

__all__ = [
    "CtrlParams", "ControllerState", "RuntimeState", "StreamTotals",
    "ScanRuntime", "SCAN_QUERIES", "aggregate_fleet", "controller_budgets",
    "controller_update", "init_state", "make_window_step", "sample_fleet",
    "state_from_numpy", "state_to_numpy", "water_fill",
]

RUNTIMES.register("scan", ScanRuntime)
RUNTIMES.register("scan_steps", ScanRuntime)
RUNTIMES.defer("event", "queue 1, 'Event path'")
RUNTIMES.defer("scan_sharded", "queue 1, 'Sharding'")
