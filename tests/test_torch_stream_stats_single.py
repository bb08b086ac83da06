"""The port's single-window statistics against the JAX package.

On the CPU ``window_moments_xxt`` takes its plain version; the reference
runs its Pallas kernel (``stream_stats_pallas``) in interpret mode.  The
CUDA kernel is held against the plain version on the card by
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream_stats.ops import derived_stats as ref_derived
from repro.kernels.stream_stats.ops import window_moments_xxt as ref_window
from repro_torch.kernels.stream_stats import ops as ss_ops

# the tolerances of tests/test_kernel_stream_stats.py
RTOL = {"float32": 2e-5, "bfloat16": 3e-2}
ATOL = 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(1, 128), (3, 200), (8, 512), (5, 700),
                                 (16, 1024), (9, 130)])
def test_window_moments_match_reference_kernel(k, n, dtype):
    rng = np.random.default_rng(k * 1000 + n)
    x = rng.normal(2.0, 1.5, (k, n)).astype(np.float32)
    mom_r, xxt_r = ref_window(jnp.asarray(x, dtype), use_kernel=True,
                              interpret=True)
    before = ss_ops.WINDOW_LAUNCHES
    mom, xxt = ss_ops.window_moments_xxt(
        torch.as_tensor(x).to(getattr(torch, dtype)))
    assert ss_ops.WINDOW_LAUNCHES == before
    assert mom.dtype == xxt.dtype == torch.float32
    assert mom.shape == (k, 4) and xxt.shape == (k, k)
    np.testing.assert_allclose(mom.numpy(), np.asarray(mom_r),
                               rtol=RTOL[dtype], atol=ATOL)
    np.testing.assert_allclose(xxt.numpy(), np.asarray(xxt_r),
                               rtol=RTOL[dtype], atol=ATOL)


@pytest.mark.parametrize("k,n,loc,scale", [(6, 384, 10.0, 4.0),
                                           (3, 100, 0.0, 1.0),
                                           (8, 1, 5.0, 2.0)])
def test_derived_stats_match_reference(k, n, loc, scale):
    rng = np.random.default_rng(k + n)
    x = rng.normal(loc, scale, (k, n)).astype(np.float32)
    mom, xxt = ss_ops.window_moments_xxt(torch.as_tensor(x))
    got = ss_ops.derived_stats(mom, xxt, n)
    want = ref_derived(jnp.asarray(mom.numpy()), jnp.asarray(xxt.numpy()), n)
    # m4 is a difference of terms of size S4 / n that cancel; f32 leaves
    # it a few ulps of that size
    m4_atol = 8 * np.finfo(np.float32).eps * float(mom[:, 3].max()) / n
    for name, g, w in zip(("mean", "var", "m4", "cov"), got, want):
        atol = m4_atol if name == "m4" else 1e-5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol, err_msg=name)


def test_window_kernel_entry_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ss_ops.stream_stats_cuda(torch.zeros(3, 40))
