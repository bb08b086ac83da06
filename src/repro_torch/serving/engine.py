"""Batched serving engine: slot-based batching over the decode step, with
straggler eviction (max-token budget per request).

Port of ``repro.serving.engine``, with its exact scheduling: prompts are
left-padded with token 0 to a common length (the pads are attended as real
tokens), so every sequence's last prompt token lands at the same position
and the ring caches stay aligned; inactive slots are filled with a mirror
of the last active request; a new batch is admitted only when every slot
is empty; a request leaves at its token budget or its eos, and the ones
still running at ``max_steps`` are drained as done.  The next token is the
argmax of the last position's f32 logits.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos: Optional[int] = None
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serve ``cfg`` with the port's parameter tree ``params`` (None: weights
    drawn from a generator seeded with ``seed``).  The model is built on
    ``device`` (None: the GPU, raising without one); ``use_kernel=False``
    keeps prefill's attention off the flash kernels.

    The engine passes tokens only, as the reference's does, so it refuses
    a config with a modality stub (whisper's encoder frames, qwen2-vl's
    patches) with a ``ValueError``: the reference's engine would fail in
    its first prefill with a ``KeyError``.  Serve those through
    ``repro_torch.launch.make_prefill`` and ``make_decode_step``."""

    def __init__(self, params: Optional[dict], cfg: ModelConfig,
                 batch_slots: int = 4, max_seq: int = 256,
                 greedy: bool = True, *, device=None, use_kernel: bool = True,
                 seed: int = 0):
        if cfg.frontend != "none":
            needs = ("encoder_embeds" if cfg.frontend == "audio_stub"
                     else "patch_embeds")
            raise ValueError(
                f"{cfg.name}: ServeEngine passes tokens only, and the "
                f"{cfg.frontend!r} frontend needs {needs}; serve it through "
                f"repro_torch.launch.make_prefill and make_decode_step")
        self.model = Transformer(cfg, params, device=device, seed=seed,
                                 use_kernel=use_kernel)
        self.B = batch_slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.cache = None
        self.steps = 0

    def submit(self, req: Request):
        self.queue.append(req)

    def _batch_prefill(self, reqs: list[Request]):
        """Left-pad prompts to a common length; batch prefill."""
        maxlen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), maxlen), np.int32)
        for i, r in enumerate(reqs):
            toks[i, maxlen - len(r.prompt):] = r.prompt
        return self.model.prefill({"tokens": toks}, self.max_seq)

    def run(self, max_steps: int = 512) -> list[Request]:
        """Process the queue to completion (or step budget). Returns all
        finished requests."""
        finished: list[Request] = []
        while (self.queue or any(self.slots)) and self.steps < max_steps:
            # admit: (re)start a batch whenever all slots are empty
            if not any(self.slots) and self.queue:
                active = []
                while self.queue and len(active) < self.B:
                    active.append(self.queue.popleft())
                self.slots = active + [None] * (self.B - len(active))
                # pad inactive slots with a mirror of the last request
                reqs = active + [active[-1]] * (self.B - len(active))
                logits, self.cache = self._batch_prefill(reqs)
                nxt = self._select(logits)
                for i, r in enumerate(active):
                    r.generated.append(int(nxt[i]))
            # decode step for the current batch
            live = [r for r in self.slots if r is not None and not r.done]
            if not live:
                self.slots = [None] * self.B
                continue
            last = np.zeros((self.B, 1), np.int64)
            for i, r in enumerate(self.slots):
                if r is not None and r.generated:
                    last[i, 0] = r.generated[-1]
            logits, self.cache = self.model.decode_step(self.cache, last)
            nxt = self._select(logits)
            self.steps += 1
            for i, r in enumerate(self.slots):
                if r is None or r.done:
                    continue
                tok = int(nxt[i])
                r.generated.append(tok)
                # straggler eviction: token budget, or eos
                if (len(r.generated) >= r.max_new_tokens
                        or (r.eos is not None and tok == r.eos)):
                    r.done = True
                    finished.append(r)
                    self.slots[i] = None
        # drain leftovers as done (engine stopping)
        for r in self.slots:
            if r is not None:
                r.done = True
                finished.append(r)
        self.slots = [None] * self.B
        return finished

    def _select(self, logits: torch.Tensor) -> np.ndarray:
        """Argmax of each row's last-position f32 logits (the first of
        equal maxima)."""
        return logits[:, -1, :].to(torch.float32).argmax(dim=-1).cpu().numpy()
