"""Edge-cloud streaming building blocks — port of ``repro.streaming``:
one edge's planner (``EdgeNode``), the WAN links (``Transport``,
``AsyncTransport`` on a virtual clock) and the clouds (``CloudNode``,
``ReorderCloudNode``)."""
from repro_torch.runtime.report import freshness_percentiles
from repro_torch.streaming.events import (AsyncTransport, DeliveryEvent,
                                          EventQueue, IngestOutcome,
                                          ReorderCloudNode)
from repro_torch.streaming.runtime import CloudNode, EdgeNode, Transport

__all__ = ["AsyncTransport", "CloudNode", "DeliveryEvent", "EdgeNode",
           "EventQueue",
           "IngestOutcome", "ReorderCloudNode", "Transport",
           "freshness_percentiles"]
