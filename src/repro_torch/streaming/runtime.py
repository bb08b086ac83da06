"""WAN link and cloud of the event loop — port of
``repro.streaming.runtime`` (host numpy, bitwise the reference's).

* :class:`Transport` — byte and cost accounting and an injectable drop
  probability, drawn from its own ``default_rng(seed)``.
* :class:`CloudNode` — reconstructs windows, counts sequence gaps and
  serves the previous reconstruction for a dropped window.

The reference's ``EdgeNode`` plans one edge through the host planner and
comes with the single-edge half of the event path (ROADMAP.md: queue 1,
'Event path'); the fleet event loop plans through the batched engine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import queries as Q
from repro_torch.core.reconstruct import reconstruct_window
from repro_torch.core.types import EdgePayload


@dataclasses.dataclass
class Transport:
    """WAN link with byte/cost accounting and injectable faults.

    ``cost_per_byte``/``latency_ms`` model heterogeneous uplinks (fleet
    topology links).
    """

    drop_prob: float = 0.0
    seed: int = 0
    cost_per_byte: float = 1.0
    latency_ms: float = 0.0
    bytes_sent: int = 0
    bytes_cost: float = 0.0
    latency_total_ms: float = 0.0
    payloads_sent: int = 0
    payloads_dropped: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def send(self, payload: EdgePayload) -> Optional[EdgePayload]:
        nbytes = payload.wan_bytes()
        self.payloads_sent += 1
        # the drop is drawn before anything else, every send
        if self._rng.random() < self.drop_prob:
            self.payloads_dropped += 1
            return None
        self.bytes_sent += nbytes
        self.bytes_cost += nbytes * self.cost_per_byte
        self.latency_total_ms += self.latency_ms
        return payload


@dataclasses.dataclass
class CloudNode:
    """Reconstructs windows and evaluates aggregate queries."""

    query_names: tuple = ("AVG", "VAR", "MIN", "MAX")
    last_reconstruction: Optional[list] = None
    windows_seen: int = 0
    gaps: int = 0
    _expected_wid: int = 0

    def ingest(self, payload: Optional[EdgePayload]) -> list:
        if payload is None:          # dropped on the WAN -> serve stale window
            self.gaps += 1
            self._expected_wid += 1
            return self.last_reconstruction or []
        if payload.window_id != self._expected_wid:
            self.gaps += abs(payload.window_id - self._expected_wid)
        self._expected_wid = payload.window_id + 1
        rec = reconstruct_window(payload)
        self.last_reconstruction = rec
        self.windows_seen += 1
        return rec

    def query(self, rec: list) -> dict:
        out = {}
        for qn in self.query_names:
            fn = Q.QUERIES[qn]
            out[qn] = np.asarray([fn(r) for r in rec]) if rec else np.asarray([])
        return out
