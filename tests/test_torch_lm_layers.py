"""The port's dense LM layers against the reference's, on the CPU.

Each case feeds the same numpy inputs and weights (made from a seed) to
``repro.models.layers`` and to ``repro_torch.models.layers``.  Tolerances:
f32 outputs within rtol 1e-4, atol 1e-5 of the reference's (the two
packages' elementwise functions (exp, rsqrt, sin, cos) differ in the last
place in a few elements); bf16 outputs with an RMS difference at most 1e-2
of the reference's RMS (both round to bf16 at the same steps, but a
last-place difference in f32 flips a rounding now and then).  A cache's
``pos`` and ``write_idx`` must be equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro_torch.configs import get_config
from repro_torch.models import layers as PL

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

F32_RTOL, F32_ATOL = 1e-4, 1e-5
BF16_RMS = 1e-2
DTYPES = ["float32", "bfloat16"]


def _cfgs(arch="gemma3-12b", **change):
    return (dataclasses.replace(ref_config(arch, smoke=True), **change),
            dataclasses.replace(get_config(arch, smoke=True), **change))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        rms = np.sqrt(np.mean(np.square(got - want)))
        assert rms <= BF16_RMS * np.sqrt(np.mean(np.square(want))), rms


def _inputs(shape, dtype, seed):
    """The same array for both packages, rounded to ``dtype`` first."""
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(_np(j).copy()).to(getattr(torch, dtype))


def _weights(shapes: dict, seed: int):
    """f32 masters: a dict for the reference and one for the port."""
    rng = np.random.default_rng(seed)
    w = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in shapes.items()}
    return ({n: jnp.asarray(a) for n, a in w.items()},
            {n: torch.from_numpy(a) for n, a in w.items()})


def _attn_weights(cfg, seed=3):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    return _weights({"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
                     "wo": (h, hd, d)}, seed)


def _positions(b, s, start=0):
    p = np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None],
                        (b, s)).copy()
    return jnp.asarray(p), torch.from_numpy(p)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    xj, xp = _inputs((2, 7, 64), dtype, 0)
    scale = np.random.default_rng(1).normal(size=64).astype(np.float32) * 0.3
    got = PL.rmsnorm({"scale": torch.from_numpy(scale)}, xp, 1e-6)
    assert got.dtype == xp.dtype
    assert_close(got, RL.rmsnorm({"scale": jnp.asarray(scale)}, xj, 1e-6),
                 dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rope", "rope2d", "mrope", "none"])
def test_apply_rope(kind, dtype):
    xj, xp = _inputs((2, 40, 4, 16), dtype, 2)
    pj, pp = _positions(2, 40, start=5)
    got = PL.apply_rope(xp, pp, kind, 10_000.0)
    want = RL.apply_rope(xj, pj, kind, 10_000.0)
    assert got.dtype == {"float32": torch.float32,
                         "bfloat16": torch.float32 if kind != "none"
                         else torch.bfloat16}[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_RTOL,
                               atol=F32_ATOL)


def test_apply_mrope_with_three_position_streams():
    xj, xp = _inputs((2, 12, 4, 16), "float32", 4)
    pos = np.random.default_rng(5).integers(0, 50, (2, 12, 3)).astype(np.int32)
    got = PL.apply_rope(xp, torch.from_numpy(pos), "mrope", 1e6)
    want = RL.apply_rope(xj, jnp.asarray(pos), "mrope", 1e6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_RTOL,
                               atol=F32_ATOL)


ATTENTION_CASES = {
    # name -> (arch, config change, window, causal, S)
    "causal_full": ("yi-9b", {}, 0, True, 20),
    "local_window": ("gemma3-12b", {}, 16, True, 40),
    "banded": ("gemma3-12b", {"attn_impl": "banded"}, 16, True, 48),
    "rope2d_full": ("chatglm3-6b", {}, 0, True, 20),
    "bidirectional": ("starcoder2-3b", {}, 0, False, 20),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_apply(case, dtype):
    arch, change, window, causal, s = ATTENTION_CASES[case]
    rc, pc = _cfgs(arch, dtype=dtype, **change)
    wj, wp = _attn_weights(rc)
    xj, xp = _inputs((2, s, rc.d_model), dtype, 6)
    pj, pp = _positions(2, s)
    want, _ = RL.attention_apply(wj, xj, pj, rc, window=window, causal=causal)
    got, cache = PL.attention_apply(wp, xp, pp, pc, window=window,
                                    causal=causal)
    assert cache is None and got.dtype == xp.dtype
    assert_close(got, want, dtype)


def test_banded_attention_is_the_dense_attention():
    """The banded path computes what the dense path does (both ported)."""
    _, pc = _cfgs("gemma3-12b", dtype="float32")
    _, wp = _attn_weights(pc)
    _, xp = _inputs((2, 48, pc.d_model), "float32", 7)
    _, pp = _positions(2, 48)
    dense, _ = PL.attention_apply(wp, xp, pp, pc, window=16)
    banded, _ = PL.attention_apply(
        wp, xp, pp, dataclasses.replace(pc, attn_impl="banded"), window=16)
    np.testing.assert_allclose(banded.numpy(), dense.numpy(), rtol=F32_RTOL,
                               atol=F32_ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention(dtype):
    rc, pc = _cfgs("starcoder2-3b", dtype=dtype)
    wj, wp = _attn_weights(rc)
    xj, xp = _inputs((2, 9, rc.d_model), dtype, 8)
    ej, ep = _inputs((2, 30, rc.d_model), dtype, 9)
    pj, pp = _positions(2, 9)
    want, _ = RL.attention_apply(wj, xj, pj, rc, kv_x=ej, causal=False)
    got, _ = PL.attention_apply(wp, xp, pp, pc, kv_x=ep, causal=False)
    assert_close(got, want, dtype)


def _ref_cache(b, t, cfg, dtype):
    return {"k": jnp.zeros((b, t, cfg.n_kv, cfg.head_dim), dtype),
            "v": jnp.zeros((b, t, cfg.n_kv, cfg.head_dim), dtype),
            "pos": jnp.full((b, t), -1, jnp.int32),
            "write_idx": jnp.asarray(0, jnp.int32)}


def _port_cache(b, t, cfg, dtype):
    return {"k": torch.zeros((b, t, cfg.n_kv, cfg.head_dim), dtype=dtype),
            "v": torch.zeros((b, t, cfg.n_kv, cfg.head_dim), dtype=dtype),
            "pos": torch.full((b, t), -1, dtype=torch.int32),
            "write_idx": 0}


def _assert_cache(got, want, dtype):
    assert_close(got["k"], want["k"], dtype)
    assert_close(got["v"], want["v"], dtype)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    assert got["write_idx"] == int(want["write_idx"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("prompt", [20, 40])
def test_prefill_then_decode_through_a_ring_that_wraps(prompt, dtype):
    """A local layer's ring of window + 8 = 24 slots: a prompt under the
    ring (20) wraps it during decode; one over it (40) keeps its last 24
    positions in slots 0..23, as the reference does (ROADMAP queue 3, note
    k).  Output and cache after prefill and after each of 8 decode steps."""
    rc, pc = _cfgs("gemma3-12b", dtype=dtype)
    ring, window = rc.window + 8, rc.window
    wj, wp = _attn_weights(rc)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, xp = _inputs((2, prompt + 8, rc.d_model), dtype, 10)
    pj, pp = _positions(2, prompt)
    cj, cp = _ref_cache(2, ring, rc, jdt), _port_cache(2, ring, pc, tdt)
    want, cj = RL.attention_apply(wj, xj[:, :prompt], pj, rc, window=window,
                                  cache=cj)
    got, cp = PL.attention_apply(wp, xp[:, :prompt], pp, pc, window=window,
                                 cache=cp)
    assert_close(got, want, dtype)
    _assert_cache(cp, cj, dtype)
    for t in range(prompt, prompt + 8):
        cj = dict(cj, write_idx=jnp.asarray(t % ring, jnp.int32))
        cp["write_idx"] = t % ring
        pj, pp = _positions(2, 1, start=t)
        want, cj = RL.attention_apply(wj, xj[:, t:t + 1], pj, rc,
                                      window=window, cache=cj)
        got, cp = PL.attention_apply(wp, xp[:, t:t + 1], pp, pc,
                                     window=window, cache=cp)
        assert_close(got, want, dtype)
        _assert_cache(cp, cj, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_apply(dtype):
    wj, wp = _weights({"wi": (64, 128), "wg": (64, 128), "wo": (128, 64)}, 11)
    xj, xp = _inputs((2, 13, 64), dtype, 12)
    got = PL.mlp_apply(wp, xp)
    assert got.dtype == xp.dtype
    assert_close(got, RL.mlp_apply(wj, xj), dtype)


def test_init_shapes_and_scales():
    """The port's initialisers draw the reference's shapes and scales
    (truncated normal on [-2, 2] over sqrt(fan_in))."""
    _, pc = _cfgs("gemma3-12b")
    g = torch.Generator().manual_seed(0)
    p = PL.attention_init(g, pc)
    assert {n: tuple(t.shape) for n, t in p.items()} == {
        "wq": (64, 4, 16), "wk": (64, 2, 16), "wv": (64, 2, 16),
        "wo": (4, 16, 64)}
    # fan-in is shape[-2] (the heads) for wq/wk/wv, shape[0] for wo
    for name, fan_in in (("wq", 4), ("wk", 2), ("wo", 4)):
        t = p[name] * np.sqrt(fan_in)
        assert float(t.abs().max()) <= 2.0 + 1e-6
        assert 0.7 < float(t.std()) < 1.0
    m = PL.mlp_init(g, 64, 128)
    assert float((m["wo"] * np.sqrt(128)).abs().max()) <= 2.0 + 1e-6
    assert float(PL.rmsnorm_init(64)["scale"].abs().sum()) == 0.0
