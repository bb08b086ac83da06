"""Bitwise replica of the ``jax.random`` calls the fleet sampler makes.

The reference draws each window's Fisher–Yates uniforms as
``uniform(fold_in(PRNGKey(seed ^ wid), 0x5A), (E, k, N))``.  Without the
same bits the samples differ, and from the second window on so do the
controller's error signal, the budgets, the allocations and the WAN
bytes, so the port computes the same bits.  Specification: JAX's
``threefry_seed``, ``threefry_2x32``, ``_threefry_fold_in`` and
``_threefry_random_bits_partitionable`` (``jax/_src/prng.py``) and
``_uniform`` (``jax/_src/random.py``) of jax 0.9, with
``jax_threefry_partitionable`` on, as the reference runs.

Threefry-2x32 is written as integer torch ops on int64 tensors masked to
32 bits, so the same code runs on the CPU and on the card.  Keys are
derived on the host: a key is a pair of Python ints (two uint32 words),
and the same cipher code hashes them.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key: tuple, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on two uint32 words.

    key: (k0, k1) ints; x0, x1: ints, or int64 tensors of one shape
    holding uint32 values.  Returns the two output words.
    """
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _MASK
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: words (0, seed)."""
    return (0, int(seed) & _MASK)


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in(key, data)``: hash the key with (0, data)."""
    return threefry2x32(key, 0, int(data) & _MASK)


def random_bits(key: tuple, shape, device=None) -> torch.Tensor:
    """32 random bits per element (partitionable threefry), int64.

    ``device=None`` means the card, as everywhere in the package."""
    numel = 1
    for d in shape:
        numel *= int(d)
    if numel >= 2 ** 32:
        raise NotImplementedError("random bits arrays of 2**32 elements or "
                                  "more need the high counter word")
    counts = torch.arange(numel, dtype=torch.int64,
                          device=resolve_device(device))
    b0, b1 = threefry2x32(key, torch.zeros_like(counts), counts)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: tuple, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32: [0, 1) from the top 23
    random bits placed in the mantissa of a float in [1, 2)."""
    bits = random_bits(key, shape, device)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)
