"""The port's Mamba2 layer, the mamba2 and jamba decoders and their
serving against the reference's, on the CPU.

mamba2 smoke (one group, 8 heads of 16, d_state 16, chunk 32) and jamba
smoke (two groups; Mamba, attention and MoE layers in one period of 8).
The layer takes seeded numpy inputs and the reference's ``mamba_init``
weights with ``conv_b``, ``D`` and the norm's scale redrawn from a numpy
seed (their init values, zeros and ones, would leave those paths
untested); the models take the reference's ``init_params(PRNGKey(0))``,
carried across by ``params_from_jax``.  The reference's functions run
jitted with no mesh.

What is held, and why:

* ``_segsum`` and the cumulative sums under it bitwise in f32 and bf16:
  the port adds in the order the reference's compiler does
  (``layers._cumsum``);
* ``_ssd_chunked`` (1 and 2 chunks, with and without an initial state,
  one and two groups) and ``mamba_apply`` in f32 within ``sweep/diff.py``'s
  ``f32`` class (rtol 3e-5, atol 1e-6), and so the conv window and the
  SSM state a prefill hands to decode and each decode step; in bf16 the
  same within the gap that the two packages' f32 sums inside their
  products leave (``BF16_GAP``: a few elements in a thousand one rounding
  step apart, where such a sum lands on the other side of a bf16 rounding
  boundary; the summation order of the reference's compiled dots is not
  reproduced, while every elementwise step rounds where it rounds, so
  most of these bf16 comparisons are bitwise); at mamba2-780m's full
  width the gap is wider and is pinned on its own (``BF16_GAP_FULL``,
  measured by ``scripts/mamba_bf16_gap.py``), split between the
  projections and the SSD's own products;
* the models' prefill and decode logits as ``test_torch_lm_model.py``
  holds the dense ones (f32 rtol 1e-3, atol 1e-3; bf16 an RMS 3e-2 of the
  reference's), and every token of an f32 serve run equal to the
  reference engine's.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import (SSMConfig, Transformer, init_cache,
                                init_params, params_from_jax, params_to_jax)
from repro_torch.models import layers as PL
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.__main__ import PROMPTS

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MAMBA = ["mamba2-780m", "jamba-1-5-large-398b"]
DTYPES = ["float32", "bfloat16"]
F32_RTOL, F32_ATOL = 3e-5, 1e-6           # sweep/diff.py's "f32" class
MODEL_RTOL, MODEL_ATOL, MODEL_BF16_RMS = 1e-3, 1e-3, 3e-2
# bf16 SSD and prefill: at most this share of the outputs differ, each by
# at most one bf16 step (2**-7) of the largest |output| (measured: 0 to 18
# of 2048-8192 elements in these tests, 1 to 4 steps of the element)
BF16_GAP = {"share": 1e-2, "step": 2.0 ** -7}
# the same at mamba2-780m's full width, one mixer on (1, 512), seed 3
# (``scripts/mamba_bf16_gap.py``; share of elements that differ, largest
# difference in bf16 steps of the largest |output|).  Measured: the layer
# 28,444 of 786,432 (3.6%), 2.17 steps; with the reference's two
# projections in the port's layer 773 (0.098%), 0.48 steps; the SSD alone
# on the same inputs 49 of 1,572,864 outputs, 0.14 steps, and 8 of
# 393,216 state elements, 0.04 steps
BF16_GAP_FULL = {"layer": (0.05, 3.0),
                 "layer_reference_projections": (2e-3, 1.0),
                 "ssd_y": (1e-4, 0.5), "ssd_state": (1e-4, 0.5)}
B = 2


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pair(a: np.ndarray, dtype):
    """The same values in both packages, rounded to ``dtype``."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(_np(j).copy()).to(getattr(torch, dtype))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@functools.cache
def _layer_weights(arch, seed=1):
    rc, _ = _cfgs(arch)
    tree = jax.tree.map(np.asarray, RL.mamba_init(jax.random.PRNGKey(seed),
                                                  rc))
    return dict(tree, conv_b=_normal(tree["conv_b"].shape, seed + 10, 0.1),
                D=_normal(tree["D"].shape, seed + 11),
                norm={"scale": _normal(tree["norm"]["scale"].shape,
                                       seed + 12, 0.1)})


def _port_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_f32(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_RTOL,
                               atol=F32_ATOL)


def _assert_bf16_gap(got, want, share=True):
    """``BF16_GAP``; ``share=False`` for the f32 SSM state of a bf16
    model, whose f32 steps differ in the last place (XLA's f32 exp and
    torch's differ in ~10% of elements), held to the step alone."""
    g, w = _np(got), _np(want)
    diff = np.abs(g - w)
    if share:
        assert (diff > 0).mean() <= BF16_GAP["share"], (diff > 0).sum()
    assert diff.max() <= BF16_GAP["step"] * np.abs(w).max(), diff.max()


def _ref_apply(rc):
    return jax.jit(lambda p, x, c: RL.mamba_apply(p, x, rc, cache=c))


def _caches(rc, dtype, b=B):
    """Zero caches of one Mamba layer in both packages."""
    s = rc.ssm
    d_in = s.expand * rc.d_model
    conv = (b, s.conv_width - 1, d_in + 2 * s.n_groups * s.d_state)
    ssm = (b, d_in // s.head_dim, s.head_dim, s.d_state)
    return ({"conv": jnp.zeros(conv, getattr(jnp, dtype)),
             "ssm": jnp.zeros(ssm, jnp.float32)},
            {"conv": torch.zeros(conv, dtype=getattr(torch, dtype)),
             "ssm": torch.zeros(ssm, dtype=torch.float32)})


# ---------------------------------------------------------------- the SSD

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q", [5, 16, 32, 40, 256, 1000])
def test_segsum_and_its_cumulative_sums_are_the_references(q, dtype):
    a = -np.abs(_normal((2, 3, q), q, 0.3))
    aj, ap = _pair(a, dtype)
    want = jax.jit(RL._segsum)(aj)
    got = PL._segsum(ap)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 3, q, q)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(PL._cumsum(ap)), _np(jax.jit(lambda x: jnp.cumsum(x, -1))(aj)))
    above = np.triu(np.ones((q, q), bool), 1)
    assert np.isneginf(_np(got)[..., above]).all()
    assert (_np(torch.exp(got))[..., above] == 0).all()


def _ssd_inputs(dtype, n_groups, s, seed=3):
    h, p, n = 8, 16, 16
    x = _pair(_normal((B, s, h, p), seed), dtype)
    dt = _pair(np.abs(_normal((B, s, h), seed + 1, 0.05)) + 0.01, dtype)
    A = _pair(-np.arange(1, h + 1, dtype=np.float32), dtype)
    Bm = _pair(_normal((B, s, n_groups, n), seed + 2), dtype)
    Cm = _pair(_normal((B, s, n_groups, n), seed + 3), dtype)
    init = _pair(_normal((B, h, p, n), seed + 4, 0.5), "float32")
    return [t[0] for t in (x, dt, A, Bm, Cm, init)], \
        [t[1] for t in (x, dt, A, Bm, Cm, init)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("n_chunks", [1, 2])
def test_ssd_chunked_matches_the_reference(n_chunks, n_groups, with_init,
                                           dtype):
    chunk = 32
    (xj, dtj, Aj, Bj, Cj, ij), (xp, dtp, Ap, Bp, Cp, ip) = _ssd_inputs(
        dtype, n_groups, n_chunks * chunk)
    want_y, want_s = jax.jit(
        lambda *a: RL._ssd_chunked(*a[:5], chunk, init_state=a[5]))(
        xj, dtj, Aj, Bj, Cj, ij if with_init else None)
    y, state = PL._ssd_chunked(xp, dtp, Ap, Bp, Cp, chunk,
                               init_state=ip if with_init else None)
    assert y.dtype == state.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _assert_f32(y, want_y)
        _assert_f32(state, want_s)
    else:
        _assert_bf16_gap(y, want_y)
        _assert_bf16_gap(state, want_s)


# ---------------------------------------------------------------- the layer

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [32, 64, 40], ids=["1-chunk", "2-chunks",
                                                 "fallback"])
@pytest.mark.parametrize("arch", MAMBA)
def test_mamba_prefill_matches_the_reference(arch, s, dtype):
    """32 tokens take one chunk of 32, 64 two (the inter-chunk carry), and
    40 (not a multiple of 32) the reference's one-chunk fallback."""
    rc, pc = _cfgs(arch, dtype)
    tree = _layer_weights(arch)
    xj, xp = _pair(_normal((B, s, rc.d_model), s), dtype)
    want, _ = _ref_apply(rc)(tree, xj, None)
    got, cache = PL.mamba_apply(_port_tree(tree), xp, pc)
    assert cache is None and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _assert_f32(got, want)
    else:
        _assert_bf16_gap(got, want)


def test_bf16_gap_at_full_width_is_the_projections_and_the_ssd_products():
    """mamba2-780m's mixer at full width in bf16: the two packages differ
    in a few per cent of the outputs, and almost all of that goes when the
    port's layer takes the reference's two projections; what is left is
    the SSD's own products (their f32 sums over n = 128 and the chunk's
    256 tokens in another order), the SSD alone on the same inputs
    differing in a few outputs in 10^5."""
    spec = importlib.util.spec_from_file_location(
        "mamba_bf16_gap", ROOT / "scripts" / "mamba_bf16_gap.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    parts = script.split("mamba2-780m", seq=512, seed=3)
    for part, (share, steps) in BF16_GAP_FULL.items():
        assert parts[part]["share"] <= share, (part, parts[part])
        assert parts[part]["max_steps"] <= steps, (part, parts[part])
    assert parts["layer_reference_projections"]["differing"] \
        < parts["layer"]["differing"] / 10


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("prompt", [1, 3, 40], ids=lambda p: f"prompt{p}")
@pytest.mark.parametrize("arch", MAMBA)
def test_mamba_decode_from_the_prefill_cache_matches_the_reference(
        arch, prompt, dtype):
    """A prefill with a cache (one token: the reference's single step from
    zero states), then 4 decode steps: each step's output and the conv and
    SSM states after it."""
    rc, pc = _cfgs(arch, dtype)
    tree = _layer_weights(arch, seed=2)
    params = _port_tree(tree)
    cj, cp = _caches(rc, dtype)
    xj, xp = _pair(_normal((B, prompt, rc.d_model), prompt + 7), dtype)
    ref = _ref_apply(rc)
    want, cj = ref(tree, xj, cj)
    got, cp = PL.mamba_apply(params, xp, pc, cache=cp)
    close = _assert_f32 if dtype == "float32" else _assert_bf16_gap
    for step in range(5):
        assert cp["ssm"].dtype == torch.float32
        close(got, want)
        close(cp["conv"], cj["conv"])
        if dtype == "float32":
            close(cp["ssm"], cj["ssm"])
        else:
            close(cp["ssm"], cj["ssm"], share=False)
        if step == 4:
            break
        xj, xp = _pair(_normal((B, 1, rc.d_model), 100 + step), dtype)
        want, cj = ref(tree, xj, cj)
        got, cp = PL.mamba_apply(params, xp, pc, cache=cp)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_hands_over_the_last_conv_inputs_and_the_final_state(dtype):
    """The cache after a 64-token prefill (two chunks): the conv window is
    the last cw - 1 = 3 conv inputs, and the SSM state the reference's
    final state (bf16: its bf16 state, cast to f32).  The conv inputs
    are the input projection's own rounded outputs."""
    rc, pc = _cfgs("mamba2-780m", dtype)
    tree = _layer_weights("mamba2-780m", seed=4)
    cj, cp = _caches(rc, dtype)
    xj, xp = _pair(_normal((B, 64, rc.d_model), 5), dtype)
    _, cj = _ref_apply(rc)(tree, xj, cj)
    _, cp = PL.mamba_apply(_port_tree(tree), xp, pc, cache=cp)
    proj = torch.einsum("bsd,de->bse", xp, _port_tree(tree)["in_proj"]
                        .to(xp.dtype))
    d_in = rc.ssm.expand * rc.d_model
    assert torch.equal(cp["conv"], proj[:, -3:, d_in:2 * d_in + 32])
    close = _assert_f32 if dtype == "float32" else _assert_bf16_gap
    close(cp["conv"], cj["conv"])
    close(cp["ssm"], cj["ssm"])
    if dtype == "bfloat16":
        assert torch.equal(cp["ssm"], cp["ssm"].to(torch.bfloat16).float())


@pytest.mark.parametrize("arch", MAMBA)
def test_a_prompt_shorter_than_the_conv_window_fails_in_both(arch):
    """A 2-token prefill (conv_width 4): the reference leaves its conv
    state None and fails on it; the port raises ``ValueError`` naming the
    reason, in the layer and in the model."""
    rc, pc = _cfgs(arch)
    tree = _ref_params(arch, "float32")
    with pytest.raises(AttributeError, match="NoneType"):
        jax.jit(lambda p, b: RT.prefill(p, b, rc, 16))(
            tree, {"tokens": jnp.zeros((B, 2), jnp.int32)})
    model = _port_model(arch, "float32")
    with pytest.raises(ValueError, match="shorter than conv_width - 1 = 3"):
        model.prefill({"tokens": np.zeros((B, 2), np.int32)}, 16)
    _, cp = _caches(rc, "float32")
    with pytest.raises(ValueError, match="no conv state"):
        PL.mamba_apply(_port_tree(_layer_weights(arch)),
                       torch.zeros((B, 2, rc.d_model)), pc, cache=cp)


# ---------------------------------------------------------------- init

@pytest.mark.parametrize("arch", MAMBA)
def test_mamba_init_has_the_references_leaves_and_values(arch):
    """The reference's leaves and shapes; ``A_log``, ``D``, ``conv_b`` and
    the norm's scale equal to its init, ``dt_bias`` the inverse softplus
    of a draw in [1e-3, 0.1], the matrices at their fan-ins."""
    rc, pc = _cfgs(arch)
    want = RL.mamba_init(jax.random.PRNGKey(0), rc)
    got = PL.mamba_init(torch.Generator().manual_seed(0), pc)
    assert jax.tree.structure(_port_tree(jax.tree.map(np.asarray, want))) \
        == jax.tree.structure(got)
    for (path, w), g in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
    for name in ("D", "conv_b"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    _assert_f32(got["A_log"], want["A_log"])
    assert not got["norm"]["scale"].any()
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 0.1 + 1e-7
    for name, fan_in in (("in_proj", rc.d_model),
                         ("conv_w", rc.ssm.conv_width),
                         ("out_proj", rc.ssm.expand * rc.d_model)):
        t = got[name] * np.sqrt(fan_in)
        assert float(t.abs().max()) <= 2.0 + 1e-6


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", MAMBA)
def test_configs_and_parameter_trees_count_the_references(arch, smoke):
    """``param_count()`` is analytic and leaves out ``dt_bias``, ``conv_b``
    and the norms (780,059,136 against a tree of 780,148,992 at mamba2
    FULL): each count is held to its reference counterpart."""
    rc, pc = ref_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert pc.ssm == SSMConfig(**dataclasses.asdict(rc.ssm))
    assert pc.param_count() == rc.param_count()
    if arch == "mamba2-780m" and not smoke:
        assert pc.param_count() == 780_059_136
    shapes = jax.eval_shape(lambda k: ref_init_params(k, rc),
                            jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    port = init_params(pc, None, device="meta")
    assert sum(t.numel() for t in jax.tree.leaves(port)) == n_ref
    if arch == "mamba2-780m" and not smoke:
        assert n_ref == 780_148_992
    if smoke:
        assert Transformer(pc, device="cpu").n_params() == n_ref


# ---------------------------------------------------------------- the models

@functools.cache
def _ref_params(arch, dtype):
    rc, _ = _cfgs(arch, dtype)
    return jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0),
                                                    rc))


@functools.cache
def _port_model(arch, dtype):
    _, pc = _cfgs(arch, dtype)
    return Transformer(pc, params_from_jax(_ref_params(arch, dtype), pc),
                       device="cpu")


def test_bf16_model_keeps_the_f32_leaves_and_round_trips():
    """A bf16 jamba holds its Mamba matrices, conv and D in bf16 and
    ``A_log``, ``dt_bias`` and the mixer's nested norm in f32 (its router
    too); the nested norm is in ``Block.params``; the tree round-trips
    through the reference's stacked layout."""
    _, pc = _cfgs("jamba-1-5-large-398b", "bfloat16")
    tree = _ref_params("jamba-1-5-large-398b", "bfloat16")
    model = _port_model("jamba-1-5-large-398b", "bfloat16")
    mix = model.layers[0].params["mixer"]
    for name in ("in_proj", "conv_w", "conv_b", "D", "out_proj"):
        assert mix[name].dtype == torch.bfloat16, name
    for t in (mix["A_log"], mix["dt_bias"], mix["norm"]["scale"],
              model.layers[1].params["moe"]["router"]):
        assert t.dtype == torch.float32
    assert model.layers[4].kind == "attn" and "wq" in \
        model.layers[4].params["mixer"]
    drawn = init_params(pc, torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16)
    assert drawn["layers"][0]["mixer"]["A_log"].dtype == torch.float32
    assert drawn["layers"][0]["mixer"]["norm"]["scale"].dtype == \
        torch.float32
    assert drawn["layers"][0]["mixer"]["in_proj"].dtype == torch.bfloat16
    back = params_to_jax(params_from_jax(tree, pc), pc)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


def _assert_model_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL)
    else:
        rms = np.sqrt(np.mean(np.square(got - want)))
        assert rms <= MODEL_BF16_RMS * np.sqrt(np.mean(np.square(want)))


def _ref_layer_cache(cache, cfg, i):
    c = cache["layers"][i % cfg.period]
    return {k: v[i // cfg.period] for k, v in c.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MAMBA)
def test_prefill_and_decode_match_the_reference(arch, dtype):
    rc, _ = _cfgs(arch, dtype)
    tree, model = _ref_params(arch, dtype), _port_model(arch, dtype)
    toks = np.random.default_rng(1).integers(0, rc.vocab, (B, 28)) \
        .astype(np.int32)
    want, cw = jax.jit(lambda p, b: RT.prefill(p, b, rc, 64))(
        tree, {"tokens": jnp.asarray(toks[:, :20])})
    got, cg = model.prefill({"tokens": toks[:, :20]}, 64)
    _assert_model_close(got, want, dtype)
    for i, c in enumerate(cg["layers"]):
        w = _ref_layer_cache(cw, rc, i)
        assert set(c) == set(w)
        if "ssm" in c:
            assert c["ssm"].dtype == torch.float32
            _assert_model_close(c["conv"], w["conv"], dtype)
            _assert_model_close(c["ssm"], w["ssm"], dtype)
    decode = jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rc))
    for t in range(20, 28):
        want, cw = decode(tree, cw, jnp.asarray(toks[:, t:t + 1]))
        got, cg = model.decode_step(cg, toks[:, t:t + 1])
        _assert_model_close(got, want, dtype)
    assert cg["len"] == int(cw["len"]) == 28


@pytest.mark.parametrize("arch", MAMBA)
def test_prefill_then_decode_matches_the_full_forward(arch):
    """The port's counterpart of the reference's
    ``test_prefill_decode_matches_forward`` (f32, rtol and atol 1e-3):
    each of 6 decode steps after an 18-token prompt against the full
    forward at that position (the conv and SSM states carried)."""
    rc, _ = _cfgs(arch)
    model = _port_model(arch, "float32")
    toks = np.random.default_rng(2).integers(0, rc.vocab, (B, 24))
    full = model({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :18]}, 64)
    for t in range(18, 24):
        got, cache = model.decode_step(cache, toks[:, t:t + 1])
        np.testing.assert_allclose(got.numpy(), full[:, t:t + 1].numpy(),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", MAMBA)
def test_f32_serve_tokens_equal_the_references(arch):
    """The example's six requests on four slots: two batches of
    left-padded prompts (4 and 3 tokens) whose pads run through the conv
    and the SSM state, in both engines."""
    rc, pc = _cfgs(arch)
    tree = _ref_params(arch, "float32")
    ref = RefEngine(tree, rc, batch_slots=4, max_seq=96)
    port = ServeEngine(params_from_jax(tree, pc), pc, batch_slots=4,
                       max_seq=96, device="cpu")
    for i, p in enumerate(PROMPTS):
        ref.submit(RefRequest(rid=i, prompt=p, max_new_tokens=12))
        port.submit(Request(rid=i, prompt=p, max_new_tokens=12))
    want, got = ref.run(), port.run()
    assert [(r.rid, r.generated) for r in got] == \
        [(r.rid, r.generated) for r in want]
    assert sum(len(r.generated) for r in got) == 72


def test_init_cache_gives_mamba_layers_their_states():
    """jamba smoke's cache: conv (B, cw - 1, ch) in the activation type
    and ssm (B, nh, p, n) in f32 at its Mamba layers, a ring at its
    attention layer; a decode step moves no write index of a Mamba
    layer."""
    _, pc = _cfgs("jamba-1-5-large-398b", "bfloat16")
    cache = init_cache(pc, 3, 40)
    s = pc.ssm
    for i, c in enumerate(cache["layers"]):
        if i == 4:
            assert set(c) == {"k", "v", "pos", "write_idx"}
            continue
        assert set(c) == {"conv", "ssm"}
        assert c["conv"].shape == (3, 3, 128 + 2 * 2 * 16)
        assert c["conv"].dtype == torch.bfloat16
        assert c["ssm"].shape == (3, 128 // s.head_dim, s.head_dim,
                                  s.d_state)
        assert c["ssm"].dtype == torch.float32
