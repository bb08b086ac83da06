"""Baseline allocators and within-stream sampling — port of
``repro.core.samplers``.

The baseline allocators (§V-A3, appendix C) take per-stream sizes and
statistics and a sample budget and return integer allocations
(largest-remainder rounding, capped at N_i).  They are host numpy, the
reference's calls with the reference's dtypes, so ties break as there.

Each stream draws a simple random sample without replacement from its
valid prefix: the first n_i entries of ``jax.random.permutation(sub_i,
N_i)``, where sub_i is the i-th subkey of a sequential split chain of the
window's key.  The key is split once for every stream, before its
allocation is looked at, and the permutation runs over the stream's own
count, so a short or straggled stream draws a permutation of its own
length.  The permutations come from :mod:`repro_torch.runtime.threefry`
on the caller's device, one call for each distinct count.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.registry import SAMPLERS

# runtime.threefry is imported where it is used: the runtime package
# imports the planners, which import this module


def _largest_remainder(frac: np.ndarray, budget: int,
                       cap: np.ndarray) -> np.ndarray:
    frac = np.maximum(frac, 0.0)
    tot = frac.sum()
    if tot <= 0:
        frac = np.minimum(np.ones_like(frac), cap)
        tot = max(frac.sum(), 1.0)
    share = frac / tot * budget
    base = np.minimum(np.floor(share).astype(np.int64),
                      cap.astype(np.int64))
    left = int(budget - base.sum())
    if left > 0:
        order = np.argsort(-(share - np.floor(share)))
        for j in order:
            if left == 0:
                break
            if base[j] < cap[j]:
                base[j] += 1
                left -= 1
        # second pass: dump remaining anywhere with headroom
        for j in np.argsort(-(cap - base)):
            if left == 0:
                break
            add = int(min(left, cap[j] - base[j]))
            base[j] += add
            left -= add
    return base


def srs_allocation(n_obs: np.ndarray, budget: int) -> np.ndarray:
    """Simple random sample over the pooled window: E[n_i] ∝ N_i."""
    return _largest_remainder(n_obs.astype(np.float64), budget, n_obs)


def stratified_allocation(n_obs: np.ndarray, budget: int) -> np.ndarray:
    """ApproxIoT-style proportional allocation, n_i ∝ N_i, with every
    stratum represented (at least 1 where the budget allows)."""
    k = len(n_obs)
    base = np.minimum(np.ones(k, np.int64), n_obs.astype(np.int64))
    if base.sum() > budget:
        return srs_allocation(n_obs, budget)
    rest = _largest_remainder(n_obs.astype(np.float64),
                              budget - int(base.sum()), n_obs - base)
    return base + rest


def svoila_allocation(n_obs: np.ndarray, sigma: np.ndarray,
                      budget: int) -> np.ndarray:
    """S-VOILA: variance-driven (Neyman) allocation n_i ∝ N_i sigma_i."""
    return _largest_remainder(n_obs * np.maximum(sigma, 1e-9), budget,
                              n_obs)


def neyman_cost_allocation(n_obs: np.ndarray, sigma: np.ndarray,
                           cost: np.ndarray,
                           budget_cost: float) -> np.ndarray:
    """Appendix C's optimal allocation: n_i ∝ N_i sigma_i / sqrt(c_i)
    under the cost budget sum c_i n_i <= budget_cost, floored, then
    filled greedily by N_i sigma_i / c_i."""
    w = n_obs * np.maximum(sigma, 1e-9) / np.sqrt(np.maximum(cost, 1e-9))
    tot = w.sum()
    if tot <= 0:
        w = np.ones_like(w)
        tot = w.sum()
    lam = budget_cost / float(np.sum(cost * w / tot))
    n = np.minimum(np.floor(w / tot * lam).astype(np.int64),
                   n_obs.astype(np.int64))
    left = budget_cost - float(cost @ n)
    for j in np.argsort(-(w / cost)):
        while n[j] < n_obs[j] and cost[j] <= left:
            n[j] += 1
            left -= cost[j]
    return n


SAMPLERS.register("srs", srs_allocation)
SAMPLERS.register("stratified", stratified_allocation)
SAMPLERS.register("svoila", svoila_allocation)
SAMPLERS.register("neyman_cost", neyman_cost_allocation)


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
