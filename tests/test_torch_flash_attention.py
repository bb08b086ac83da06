"""The port's flash attention against the JAX package on the CPU.

On the CPU ``flash_attention`` takes its plain version; it is held against
the reference's jnp oracle on the reference's own shape cases, and on two
of them against the reference's Pallas kernel in interpret mode.  The CUDA
kernel is held against the plain version on the card by
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref as plain_flash

# the cases and tolerances of tests/test_kernel_flash_attention.py
CASES = [
    (64, 64, 4, 2, 16, True, 0),       # GQA causal
    (48, 48, 4, 4, 32, True, 16),      # sliding window
    (32, 80, 2, 1, 16, False, 0),      # cross-attn shape, ragged keys
    (100, 100, 8, 2, 64, True, 32),    # non-power-of-two, window
    (16, 16, 2, 2, 8, True, 0),        # tiny
]
ATOL = {"float32": 2e-6, "bfloat16": 3e-2}


def _inputs(s, t, h, kv, hd, b=2):
    rng = np.random.default_rng(s * 7 + t)
    return (rng.normal(0, 1, (b, s, h, hd)).astype(np.float32),
            rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32),
            rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32))


def _port(arrays, dtype, **kw):
    q, k, v = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays)
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.LAUNCHES == before
    assert out.dtype == q.dtype and out.shape == q.shape
    return out.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,h,kv,hd,causal,window", CASES)
def test_plain_matches_reference_oracle(s, t, h, kv, hd, causal, window,
                                        dtype):
    arrays = _inputs(s, t, h, kv, hd)
    want = flash_attention_ref(*(jnp.asarray(a, dtype) for a in arrays),
                               causal=causal, window=window)
    got = _port(arrays, dtype, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=ATOL[dtype])


@pytest.mark.parametrize("s,t,h,kv,hd,causal,window", [CASES[4], CASES[2]])
def test_plain_matches_reference_kernel_interpret(s, t, h, kv, hd, causal,
                                                  window):
    arrays = _inputs(s, t, h, kv, hd)
    want = ref_flash(*(jnp.asarray(a) for a in arrays), causal=causal,
                     window=window, interpret=True)
    got = _port(arrays, "float32", causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL["float32"])


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_gqa_matches_a_loop_over_heads(causal, window):
    """H = 8 query heads on KV = 2 kv heads: head h reads kv head h // 4."""
    s, t, h, kv, hd = 24, 24, 8, 2, 16
    q, k, v = _inputs(s, t, h, kv, hd)
    got = _port((q, k, v), "float32", causal=causal, window=window)
    qp, kp = np.arange(s)[:, None], np.arange(t)[None, :]
    live = np.ones((s, t), bool)
    if causal:
        live &= kp <= qp
    if window:
        live &= qp - kp < window
    want = np.empty_like(q, dtype=np.float64)
    for b in range(q.shape[0]):
        for hh in range(h):
            g = hh // (h // kv)
            sc = q[b, :, hh].astype(np.float64) @ k[b, :, g].T / np.sqrt(hd)
            sc = np.where(live, sc, -np.inf)
            p = np.exp(sc - sc.max(1, keepdims=True))
            want[b, :, hh] = (p / p.sum(1, keepdims=True)) @ v[b, :, g]
    np.testing.assert_allclose(got, want, atol=ATOL["float32"])


def test_plain_version_on_a_slice_of_rows():
    """``q_offset`` places a slice of the queries at their positions, as
    the card's check of the last rows of a long prefill does."""
    s, h, kv, hd, r = 40, 4, 2, 16, 8
    q, k, v = (torch.as_tensor(a) for a in _inputs(s, s, h, kv, hd))
    for causal, window in ((True, 0), (True, 6), (False, 6)):
        full = plain_flash(q, k, v, causal=causal, window=window)
        tail = plain_flash(q[:, -r:], k, v, causal=causal, window=window,
                           q_offset=s - r)
        torch.testing.assert_close(tail, full[:, -r:], rtol=0, atol=1e-6)


def test_flash_kernel_entry_refuses_cpu_tensors():
    q, k, v = (torch.as_tensor(a) for a in _inputs(16, 16, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention_cuda(q, k, v)
