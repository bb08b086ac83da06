"""Edge-cloud streaming building blocks — port of ``repro.streaming`` for
the fleet event loop: the WAN links (``Transport``, ``AsyncTransport`` on
a virtual clock) and the clouds (``CloudNode``, ``ReorderCloudNode``).

The single-edge ``EdgeNode`` plans through the host planner, which is not
ported yet (ROADMAP.md: queue 1, 'Event path').
"""
from repro_torch.runtime.report import freshness_percentiles
from repro_torch.streaming.events import (AsyncTransport, DeliveryEvent,
                                          EventQueue, IngestOutcome,
                                          ReorderCloudNode)
from repro_torch.streaming.runtime import CloudNode, Transport

__all__ = ["AsyncTransport", "CloudNode", "DeliveryEvent", "EventQueue",
           "IngestOutcome", "ReorderCloudNode", "Transport",
           "freshness_percentiles"]
