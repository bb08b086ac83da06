"""Within-stream sampling of the host planner — port of
``repro.core.samplers.draw_samples``.

Each stream draws a simple random sample without replacement from its
valid prefix: the first n_i entries of ``jax.random.permutation(sub_i,
N_i)``, where sub_i is the i-th subkey of a sequential split chain of the
window's key.  The key is split once for every stream, before its
allocation is looked at, and the permutation runs over the stream's own
count, so a short or straggled stream draws a permutation of its own
length.  The permutations come from :mod:`repro_torch.runtime.threefry`
on the caller's device, one call for each distinct count.

(The baseline allocators of ``repro.core.samplers`` come with the
baselines: ROADMAP.md queue 1, 'Event path'.)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

# runtime.threefry is imported where it is used: the runtime package
# imports the planners, which import this module


def stream_subkeys(key: tuple, k: int) -> list:
    """The subkey of every stream: ``key, sub = split(key)`` k times."""
    from repro_torch.runtime import threefry
    subs = []
    for _ in range(k):
        key, sub = threefry.split(key)
        subs.append(sub)
    return subs


def stream_permutations(key: tuple, counts, device=None) -> torch.Tensor:
    """(k, max N_i) int64 on ``device``: row i holds
    ``permutation(sub_i, N_i)`` in its first N_i entries, -1 after."""
    from repro_torch.runtime import threefry
    dev = resolve_device(device)
    counts = [int(c) for c in np.asarray(counts)]
    subs = stream_subkeys(key, len(counts))
    out = torch.full((len(counts), max(counts + [0])), -1,
                     dtype=torch.int64, device=dev)
    for c in sorted(set(counts) - {0}):
        rows = [i for i, ci in enumerate(counts) if ci == c]
        out[rows, :c] = threefry.permutations([subs[i] for i in rows], c,
                                              device=dev)
    return out


def take_samples(values: np.ndarray, counts, alloc, perms) -> list:
    """The drawn samples on the host, from host values and host
    permutations: stream i's first min(alloc_i, N_i) permuted tuples."""
    out = []
    for i, n_i in enumerate(np.asarray(alloc)):
        n_i = int(min(int(n_i), int(counts[i])))
        if n_i <= 0:
            out.append(np.zeros((0,), np.float32))
            continue
        out.append(np.asarray(values[i])[perms[i, :n_i]].astype(np.float32))
    return out


def draw_samples(key: tuple, values, counts, alloc, device=None) -> list:
    """SRS without replacement inside each stream's valid prefix: a list
    of k f32 host arrays from host ``values`` and ``counts``.  ``key`` is
    a threefry key (``prng_key(seed)``); the permutations are drawn on
    ``device``."""
    perms = stream_permutations(key, counts, device).cpu().numpy()
    return take_samples(np.asarray(values), counts, alloc, perms)
