"""The threefry replica and the scan samplers against ``jax.random``.

Integer outputs must match bitwise: the uniforms' bit patterns and the
sample sets the Fisher–Yates shuffle (fleets) and the permutation (one
site) draw from them.
"""
import numpy as np
import pytest
import torch

import jax

from repro.runtime.step import draw_fleet_samples
from repro_torch.runtime import threefry
from repro_torch.runtime.step import sample_fleet

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

SEEDS = [0, 15, 2**31 - 1]
SHAPES = [(6, 4, 64), (3, 5, 7), (16, 8, 256)]


def _words(key) -> tuple:
    return tuple(int(v) for v in np.asarray(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert threefry.prng_key(seed) == _words(key)
    for data in (0, 0x5A, 7, 2**31 - 1):
        assert (threefry.fold_in(threefry.prng_key(seed), data)
                == _words(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_equal_jax(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5A)
    want = np.asarray(jax.random.uniform(key, shape))
    got = threefry.uniform(threefry.fold_in(threefry.prng_key(seed), 0x5A),
                           shape, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed,wid,shape", [
    (15, 0, (6, 4, 64)), (15, 5, (6, 4, 64)), (0, 3, (3, 5, 40)),
    (2**31 - 1, 11, (4, 8, 256))])
def test_sample_fleet_equals_reference(seed, wid, shape):
    rng = np.random.default_rng(wid)
    values = rng.normal(50.0, 5.0, shape).astype(np.float32)
    n_real = rng.integers(0, shape[2] + 1, shape[:2]).astype(np.int32)
    want = draw_fleet_samples(seed, wid, values, n_real)
    got = sample_fleet(seed, wid, torch.as_tensor(values),
                       torch.as_tensor(n_real)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_single_edge_sampler_is_not_ported_yet():
    """One site draws by ``permutation`` from the ``split`` chain, not by
    the fleet's Fisher–Yates shuffle: the sample sets equal the
    reference's bitwise (tests/test_torch_single_edge.py has the rest)."""
    values = np.arange(24, dtype=np.float32).reshape(1, 3, 8)
    n_real = np.array([[8, 3, 0]], np.int32)
    want = draw_fleet_samples(0, 0, values, n_real)
    got = sample_fleet(0, 0, torch.as_tensor(values),
                       torch.as_tensor(n_real)).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got[0, 0]) == list(range(8))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without CUDA")
def test_uniform_without_device_raises_without_cuda():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        threefry.uniform(threefry.prng_key(0), (2, 3))
