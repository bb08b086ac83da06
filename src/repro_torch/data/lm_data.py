"""Deterministic synthetic LM token pipeline (port of ``repro.data.lm_data``).

A fixed order-1 Markov chain over the vocabulary gives the model real
structure to learn (the loss falls measurably within a few hundred steps)
while staying reproducible and free of downloads.  Batches are drawn on
the host with numpy, in the reference's order of draws, so the same seed
gives the reference's batches bitwise; a background thread keeps
``prefetch`` batches ready.  Where the reference's thread drops the batch
it drew when the queue stays full for 0.5 s (so what a slow consumer sees
depends on its pace), the port's holds it until there is room: batch i
is always the i-th draw, which a restored training run relies on.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class MarkovTokenStream:
    """Order-1 Markov chain with a banded+sparse transition structure."""

    def __init__(self, vocab: int, seed: int = 0, branch: int = 16):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.branch = min(branch, vocab)
        # each token moves to `branch` successors with Dirichlet weights
        self.succ = rng.integers(0, vocab, size=(vocab, self.branch))
        probs = rng.dirichlet(np.ones(self.branch) * 0.3, size=vocab)
        self.probs = probs.astype(np.float64)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int64)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            cur = out[:, t]
            # one categorical draw per row
            u = rng.random(batch)
            cdf = np.cumsum(self.probs[cur], axis=1)
            idx = (u[:, None] > cdf).sum(axis=1)
            out[:, t + 1] = self.succ[cur, np.minimum(idx, self.branch - 1)]
        return out


class LMBatcher:
    """Yields ``{'tokens', 'labels'}`` int32 numpy batches (B, seq), the
    labels the tokens shifted by one, with background prefetch.  ``extras``
    maps a name to ``(shape, dtype)`` of a zero array added per row.
    :meth:`close` stops the prefetch thread."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 extras: Optional[dict] = None, prefetch: int = 2):
        self.stream = MarkovTokenStream(vocab, seed)
        self.batch, self.seq = batch, seq
        self.extras = extras or {}
        self.rng = np.random.default_rng(seed + 1)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self):
        toks = self.stream.sample(self.rng, self.batch, self.seq)
        b = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
        for k, (shape, dtype) in self.extras.items():
            b[k] = np.zeros((self.batch, *shape), dtype)
        return b

    def _worker(self):
        while not self._stop.is_set():
            batch = self._make()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(5.0)     # a put waits at most 0.5 s
