"""Event-driven WAN transport and out-of-order cloud ingestion — port of
``repro.streaming.events`` (host numpy, bitwise the reference's).

* :class:`EventQueue` — a deterministic min-heap of delivery events keyed
  by (virtual time, send sequence); ties resolve in send order, so the
  zero-latency schedule is the lock-step schedule.
* :class:`AsyncTransport` — ``Transport``'s accounting, plus delivery at
  ``now_ms + latency_ms [+ bytes / bandwidth] + U(0, jitter_ms)`` and
  retransmit-on-timeout.
* :class:`ReorderCloudNode` — a ``CloudNode`` with a reorder buffer and a
  staleness deadline: a payload that lands after its window's query was
  answered, but within the deadline, revises the answer; past it, it is
  a late drop and the cloud keeps gap-serving.  Duplicates are
  idempotent.

Timing model (the fleet event loop's)::

    t_sent(wid)  = wid * window_period_ms          # edge closes the window
    t_due(wid)   = t_sent(wid) + window_period_ms  # query is answered here
    t_arrive     = t_sent + latency_ms + jitter    # delivery event
    staleness    = t_arrive - t_due(wid)           # >0 means late

``freshness_percentiles`` lives in :mod:`repro_torch.runtime.report`.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional

import numpy as np

from repro_torch.core.reconstruct import reconstruct_window
from repro_torch.core.types import EdgePayload
from repro_torch.streaming.runtime import CloudNode, Transport


@dataclasses.dataclass(frozen=True)
class DeliveryEvent:
    """One payload materializing at the cloud at virtual time ``at_ms``."""

    at_ms: float
    seq: int                       # send order; deterministic tie-break
    payload: EdgePayload


class EventQueue:
    """Min-heap of :class:`DeliveryEvent` ordered by (at_ms, seq)."""

    def __init__(self):
        self._heap: list = []

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, at_ms: float, seq: int, payload: EdgePayload) -> None:
        heapq.heappush(self._heap, (float(at_ms), int(seq), payload))

    def pop_until(self, until_ms: float) -> list:
        """Pop every event with ``at_ms <= until_ms`` in delivery order."""
        out = []
        while self._heap and self._heap[0][0] <= until_ms:
            t, seq, p = heapq.heappop(self._heap)
            out.append(DeliveryEvent(at_ms=t, seq=seq, payload=p))
        return out


@dataclasses.dataclass
class AsyncTransport(Transport):
    """WAN link whose deliveries are events on a virtual clock.

    ``jitter_ms`` adds U(0, jitter_ms) per delivered copy from a second
    generator (seed + 0x5EED), so jitter never perturbs the drop sequence.
    ``bandwidth_bytes_per_ms`` adds the serialization delay
    ``bytes / bandwidth`` before propagation (``None``: instantaneous).

    ``retransmit_timeout_ms`` + ``max_retries`` arm retransmit-on-timeout:
    attempt ``a`` fires at ``now + a * timeout`` unless an earlier copy
    has been delivered by then (instant ACK).  Every attempt draws its
    drop again and, when transmitted, its own jitter; bytes and cost count
    per transmitted copy.  Unarmed, the send path is the fire-and-forget
    link.
    """

    jitter_ms: float = 0.0
    bandwidth_bytes_per_ms: Optional[float] = None
    retransmit_timeout_ms: Optional[float] = None
    max_retries: int = 0
    retransmits: int = 0               # retry attempts fired (not deliveries)

    def __post_init__(self):
        super().__post_init__()
        self._jitter_rng = np.random.default_rng(self.seed + 0x5EED)
        self._queue = EventQueue()
        self._seq = 0

    @classmethod
    def from_transport(cls, t: Transport) -> "AsyncTransport":
        """A plain link upgraded to the event clock (its drop probability,
        seed, cost and latency); an ``AsyncTransport`` is returned as is."""
        if isinstance(t, AsyncTransport):
            return t
        return cls(drop_prob=t.drop_prob, seed=t.seed,
                   cost_per_byte=t.cost_per_byte, latency_ms=t.latency_ms)

    @property
    def in_flight(self) -> int:
        return len(self._queue)

    def send(self, payload: EdgePayload,
             now_ms: float = 0.0) -> Optional[EdgePayload]:
        attempts = 1
        if self.retransmit_timeout_ms is not None and self.max_retries > 0:
            attempts += self.max_retries
        first = None
        earliest = math.inf                    # earliest delivery so far
        for a in range(attempts):
            t_a = now_ms + a * (self.retransmit_timeout_ms or 0.0)
            if a > 0:
                if earliest <= t_a:            # instant-ACK beat the timer
                    break
                self.retransmits += 1
            sent = Transport.send(self, payload)
            if sent is None:                   # dropped: no delivery event
                continue
            delay = self.latency_ms
            if self.bandwidth_bytes_per_ms is not None:
                delay += sent.wan_bytes() / self.bandwidth_bytes_per_ms
            if self.jitter_ms > 0.0:
                delay += float(self._jitter_rng.uniform(0.0, self.jitter_ms))
            self._queue.push(t_a + delay, self._seq, sent)
            self._seq += 1
            earliest = min(earliest, t_a + delay)
            if first is None:
                first = sent
        return first

    def drain(self, until_ms: float) -> list:
        """All deliveries due by ``until_ms``, in (time, send-order)."""
        return self._queue.pop_until(until_ms)


@dataclasses.dataclass(frozen=True)
class IngestOutcome:
    """What the cloud did with one delivery."""

    kind: str                       # "fresh" | "revised" | "late_dropped" | "duplicate"
    window_id: int
    staleness_ms: float             # arrival - due; <= 0 means on time
    reconstruction: Optional[list] = None


@dataclasses.dataclass
class ReorderCloudNode(CloudNode):
    """CloudNode with an out-of-order reorder buffer and staleness deadline.

    ``ingest_event`` takes one delivery; ``serve(wid, now_ms)`` answers a
    query with the freshest arrived window ``<= wid`` (gap-serving when
    ``wid`` itself is missing).
    """

    window_period_ms: float = 1000.0
    deadline_ms: float = math.inf   # staleness allowance past the due time
    revisions: int = 0
    late_drops: int = 0
    duplicates: int = 0
    stale_serves: int = 0           # queries answered from an older window

    def __post_init__(self):
        # queries come in non-decreasing wid and a delivery's wid never
        # exceeds the current query's, so only the freshest arrived window
        # is ever served; integer sets cover duplicates and end-of-run gaps
        self._best_wid: int = -1
        self._best_rec: Optional[list] = None
        self._best_sent_at: float = 0.0
        self._rec_wids: set = set()
        self._ingested: set = set()
        self._frontier: int = -1    # highest wid whose query was answered

    def due_ms(self, payload: EdgePayload) -> float:
        return payload.sent_at_ms + self.window_period_ms

    def ingest_event(self, payload: EdgePayload,
                     now_ms: float) -> IngestOutcome:
        wid = int(payload.window_id)
        staleness = now_ms - self.due_ms(payload)
        if wid in self._ingested:
            self.duplicates += 1
            return IngestOutcome("duplicate", wid, staleness)
        self._ingested.add(wid)
        if staleness > self.deadline_ms:
            self.late_drops += 1
            return IngestOutcome("late_dropped", wid, staleness)
        rec = reconstruct_window(payload)
        self._rec_wids.add(wid)
        if wid > self._best_wid:
            self._best_wid = wid
            self._best_rec = rec
            self._best_sent_at = float(payload.sent_at_ms)
        self.windows_seen += 1
        self.last_reconstruction = rec
        if wid <= self._frontier:   # query already answered -> re-emit
            self.revisions += 1
            return IngestOutcome("revised", wid, staleness, rec)
        return IngestOutcome("fresh", wid, staleness, rec)

    def serve(self, wid: int, now_ms: float):
        """``(reconstruction, age_ms, served_wid)`` for a query over window
        ``wid``; ``([], nan, None)`` before any window ``<= wid`` arrived.
        Queries must come in non-decreasing ``wid``."""
        self._frontier = max(self._frontier, wid)
        if self._best_rec is None or self._best_wid > wid:
            return [], float("nan"), None
        if self._best_wid < wid:    # gap-serving
            self.stale_serves += 1
        age = now_ms - (self._best_sent_at + self.window_period_ms)
        return self._best_rec, float(age), self._best_wid

    def finalize(self, n_windows: int) -> list:
        """Close the books: windows never reconstructed count as gaps."""
        missing = [w for w in range(n_windows) if w not in self._rec_wids]
        self.gaps += len(missing)
        return missing
