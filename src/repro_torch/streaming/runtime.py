"""Edge, WAN link and cloud of the event loops — port of
``repro.streaming.runtime``.

* :class:`EdgeNode` — caches one tumbling window of one edge and plans it
  (Algorithm 1, ``core.planner.plan_window``) on its device.
* :class:`Transport` — byte and cost accounting and an injectable drop
  probability, drawn from its own ``default_rng(seed)``.
* :class:`CloudNode` — reconstructs windows, counts sequence gaps and
  serves the previous reconstruction for a dropped window.

The link and the cloud are host numpy, bitwise the reference's.

Fault tolerance: a straggling stream contributes N_i = 0 tuples and the
planner's imputation covers it from its predictor; a lost payload is a
sequence gap the cloud serves from the previous reconstruction.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.api.registry import BASELINES, MODELS, UnknownComponentError
from repro_torch.core import queries as Q
from repro_torch.core.reconstruct import reconstruct_window
from repro_torch.core.types import EdgePayload, PlannerConfig, WindowBatch


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
class EdgeNode:
    """Caches one tumbling window then plans it (Algorithm 1).

    ``method`` ``"model"`` plans with ``cfg.model``; a registered model
    family ("linear" | "cubic" | "mean" | "multi") pins that family; a
    registered baseline ("srs" | "approx_iot" | "s_voila" |
    "neyman_cost") bypasses the planner (``plan_with_baseline`` with
    ``cfg.seed`` and ``cfg.cost_per_sample``).  The budget is
    ``budget_fraction`` of the window's tuples after stragglers, at least
    2.  ``plan_seconds`` sums the planner's time, split for the planner
    into ``device_seconds`` (upload, statistics, fit, permutations, read)
    and ``solve_seconds`` (the host program); ``newton_steps`` sums the
    IPM's steps.  ``device=None`` is the GPU.
    """

    cfg: PlannerConfig
    budget_fraction: float
    method: str = "model"          # "model" | model names | baselines
    straggler_drop: Optional[Callable[[int, int], bool]] = None
    plan_seconds: float = 0.0
    device: object = None
    device_seconds: float = 0.0
    solve_seconds: float = 0.0
    newton_steps: int = 0

    def __post_init__(self):
        if not (self.method == "model" or self.method in MODELS
                or self.method in BASELINES):
            raise UnknownComponentError(
                "method", self.method,
                ("model", *MODELS.names(), *BASELINES.names()))
        self.device = resolve_device(self.device)

    def process_window(self, batch: WindowBatch) -> EdgePayload:
        from repro_torch.core.planner import plan_window, plan_with_baseline
        values = np.asarray(batch.values)
        counts = np.asarray(batch.counts).copy()
        wid = int(batch.window_id)
        if self.straggler_drop is not None:
            for i in range(len(counts)):
                if self.straggler_drop(wid, i):
                    counts[i] = 0            # missed the deadline entirely
        batch = WindowBatch.from_numpy(values, counts, wid)
        budget = max(int(self.budget_fraction * int(np.sum(counts))), 2)
        t0 = time.perf_counter()
        if self.method in BASELINES:
            payload = plan_with_baseline(batch, budget, self.method,
                                         seed=self.cfg.seed,
                                         cost=self.cfg.cost_per_sample,
                                         device=self.device)
            self.plan_seconds += time.perf_counter() - t0
            return payload
        cfg = (self.cfg if self.method == "model"
               else dataclasses.replace(self.cfg, model=self.method))
        payload, diag = plan_window(batch, budget, cfg, device=self.device)
        self.plan_seconds += time.perf_counter() - t0
        self.device_seconds += diag.device_seconds
        self.solve_seconds += diag.solve_seconds
        self.newton_steps += diag.allocation.newton_steps
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
