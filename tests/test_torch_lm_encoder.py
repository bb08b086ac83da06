"""whisper's encoder and cross-attention in the port against the
reference's, on the CPU.

whisper smoke (2 decoder layers with cross-attention, a 2-layer encoder
over 30 frames, d 64), the reference's ``init_params(PRNGKey(0))``
carried across by ``params_from_jax``.  The frame embeddings are a seeded
normal draw, as the reference's own tests draw them: the zero frames the
training driver feeds would make the encoder's output the final norm of
zeros, and cross-attention would add nothing to check.

Tolerances, as the other LM tests hold them: f32 rtol and atol 1e-3 (the
reference's own cache tests' limit; its jitted layers differ from the
port's in the last place of exp and rsqrt, and the random attention
weights, whose ``wq`` the reference scales by 1/sqrt(H), make
near-one-hot probabilities that magnify that past 1e-4 even in one
layer); bf16 RMS(difference) at most 3e-2 of the reference's RMS, and for
the encoder and one layer at most 5% of the elements apart, which holds
only where the port rounds where the reference's compiled form does (the
encoder's carry at every layer; each residual sum reaching the next norm
unrounded, the cross step's included): with every norm reading the
rounded sum instead, 60% of the encoder's outputs differ.  Greedy tokens,
``pos``, ``write_idx`` and ``len`` equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import Transformer, init_params, params_from_jax
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ARCH = "whisper-large-v3"
DTYPES = ["float32", "bfloat16"]
B, PROMPT, STEPS, MAX_SEQ = 2, 12, 6, 32
F32_RTOL, F32_ATOL = 1e-3, 1e-3
BF16_RMS, BF16_DIFFER = 3e-2, 0.05


def _cfgs(dtype):
    return (dataclasses.replace(ref_config(ARCH, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_close(got, want, dtype, rtol=F32_RTOL, atol=F32_ATOL,
                 differ=None):
    """f32 within (rtol, atol); bf16 within the RMS rule, and with
    ``differ`` at most that share of the elements unequal."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        return
    rms = np.sqrt(np.mean(np.square(got - want)))
    assert rms <= BF16_RMS * np.sqrt(np.mean(np.square(want))), rms
    if differ is not None:
        assert np.mean(got != want) <= differ, np.mean(got != want)


@functools.cache
def _ref_params(dtype, seed=0):
    rc, _ = _cfgs(dtype)
    return jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(seed),
                                                    rc))


@functools.cache
def _port_model(dtype, seed=0):
    _, pc = _cfgs(dtype)
    return Transformer(pc, params_from_jax(_ref_params(dtype, seed), pc),
                       device="cpu")


def _frames(cfg, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        0, 1, (B, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)


def _tokens(vocab, n, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, n)) \
        .astype(np.int32)


@functools.cache
def _ref_encode_fn(dtype):
    rc, _ = _cfgs(dtype)
    return jax.jit(lambda p, e: RT._encode(p, rc, e))


@functools.cache
def _ref_prefill_fn(dtype):
    rc, _ = _cfgs(dtype)
    return jax.jit(lambda p, b: RT.prefill(p, b, rc, MAX_SEQ))


@functools.cache
def _ref_decode_fn(dtype):
    rc, _ = _cfgs(dtype)
    return jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rc))


def _block0(tree):
    """Decoder layer 0 of the reference's stacked tree (period 1)."""
    return jax.tree.map(lambda a: a[0], tree["blocks"][0])


# ---------------------------------------------------------------- encoder

@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_the_reference(dtype):
    """The encoder alone: both layers' bidirectional attention and MLP at
    positions 0..29, the carry in the activation type, the final norm."""
    rc, pc = _cfgs(dtype)
    frames = _frames(rc)
    want = _ref_encode_fn(dtype)(_ref_params(dtype), jnp.asarray(frames))
    got = _port_model(dtype).encode(frames)
    assert got.dtype == pc.activation_dtype
    assert_close(got, want, dtype, differ=BF16_DIFFER)


def test_encoder_output_of_zero_frames_is_the_final_norm_of_zeros():
    """The driver's zero frames (the reference's training extras): every
    layer's attention and MLP read zeros and add zeros, so the encoder's
    output is zero and cross-attention reads all-zero keys and values;
    the port agrees with the reference on it."""
    rc, _ = _cfgs("float32")
    zeros = np.zeros((B, rc.encoder.seq_len, rc.d_model), np.float32)
    got = _port_model("float32").encode(zeros)
    want = _ref_encode_fn("float32")(_ref_params("float32"),
                                     jnp.asarray(zeros))
    assert not got.any() and not np.asarray(want).any()


# ---------------------------------------------------------------- cross

@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_the_reference(dtype):
    """``attention_apply`` onto the encoder's output (no mask, no RoPE, a
    query length other than the key length), alone and inside a decoder
    layer with its three residual adds."""
    rc, pc = _cfgs(dtype)
    tree = _ref_params(dtype)
    enc = np.array(_ref_encode_fn(dtype)(tree, jnp.asarray(_frames(rc)))
                   .astype(jnp.float32))
    x = np.random.default_rng(3).normal(0, 1, (B, PROMPT, rc.d_model)) \
        .astype(np.float32)
    positions = np.repeat(np.arange(PROMPT)[None], B, axis=0)
    p_ref = _block0(tree)
    p_port = params_from_jax(tree, pc)["layers"][0]
    dt = pc.activation_dtype
    xj = jnp.asarray(x).astype(rc.activation_dtype)
    ej = jnp.asarray(enc).astype(rc.activation_dtype)
    xt = torch.from_numpy(x).to(dt)
    et = torch.from_numpy(enc).to(dt)
    pos_t = torch.from_numpy(positions).int()

    want, _ = jax.jit(lambda p, a, e: RL.attention_apply(
        p, a, jnp.asarray(positions), rc, kv_x=e, causal=False))(
        p_ref["cross"], xj, ej)
    got, _ = PL.attention_apply(p_port["cross"], xt, pos_t, pc, kv_x=et,
                                causal=False)
    assert_close(got, want, dtype, differ=BF16_DIFFER)

    want, _, _ = jax.jit(lambda p, a, e: RT._apply_position(
        p, a, jnp.asarray(positions), rc, 0, enc_out=e))(p_ref, xj, ej)
    got, _, _ = PT._apply_position(p_port, "attn", 0, xt,
                                   xt.to(torch.float32), pos_t, pc,
                                   enc_out=et)
    assert_close(got, want, dtype, differ=BF16_DIFFER)


# ---------------------------------------------------------------- serving

def _assert_cache(got, want, cfg, dtype):
    assert got["len"] == int(want["len"])
    assert_close(got["enc_out"], want["enc_out"], dtype)
    assert got["enc_out"].dtype == (torch.float32 if dtype == "float32"
                                    else torch.bfloat16)
    for i, g in enumerate(got["layers"]):
        w = jax.tree.map(lambda a: a[i], want["layers"][0])
        assert_close(g["k"], w["k"], dtype)
        assert_close(g["v"], w["v"], dtype)
        np.testing.assert_array_equal(g["pos"].numpy(), np.asarray(w["pos"]))
        assert g["write_idx"] == int(w["write_idx"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_the_reference(dtype):
    """Prefill over a 12-token prompt and 30 frames (last logits, every
    layer's ring, ``enc_out``, ``len``), then 6 decode steps that attend
    to the cached ``enc_out``.  In f32 both decode greedily, each from its
    own argmax, and the tokens are equal; in bf16 both are fed the same
    tokens."""
    rc, _ = _cfgs(dtype)
    tree, model = _ref_params(dtype), _port_model(dtype)
    frames, toks = _frames(rc), _tokens(rc.vocab, PROMPT + STEPS)
    want, cw = _ref_prefill_fn(dtype)(tree, {
        "tokens": jnp.asarray(toks[:, :PROMPT]),
        "encoder_embeds": jnp.asarray(frames)})
    got, cg = model.prefill({"tokens": toks[:, :PROMPT],
                             "encoder_embeds": frames}, MAX_SEQ)
    assert got.shape == (B, 1, rc.vocab)
    assert_close(got, want, dtype)
    _assert_cache(cg, cw, rc, dtype)
    decode = _ref_decode_fn(dtype)
    for t in range(PROMPT, PROMPT + STEPS):
        if dtype == "float32":
            nxt_w = np.asarray(jnp.argmax(want[:, -1], -1))[:, None]
            nxt_g = got[:, -1].argmax(-1)[:, None].numpy()
            np.testing.assert_array_equal(nxt_g, nxt_w)
        else:
            nxt_w = nxt_g = toks[:, t:t + 1]
        want, cw = decode(tree, cw, jnp.asarray(nxt_w, jnp.int32))
        got, cg = model.decode_step(cg, nxt_g)
        assert_close(got, want, dtype)
    _assert_cache(cg, cw, rc, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_forward_matches_the_reference(dtype):
    """The forward over prompt and frames: the reference's encoder and
    stack, then the final norm and the f32 logits at every token."""
    rc, _ = _cfgs(dtype)
    frames, toks = _frames(rc, seed=6), _tokens(rc.vocab, PROMPT, seed=7)

    def fwd(params, batch):
        x, positions, enc_out, pad = RT._prepare_inputs(params, rc, batch)
        h, _, _ = RT._stack(rc, params, x, positions, enc_out=enc_out,
                            remat=False)
        h = RT.L.rmsnorm(params["final_norm"], h, rc.norm_eps)
        return RT._lm_logits(params, rc, h)
    want = jax.jit(fwd)(_ref_params(dtype), {
        "tokens": jnp.asarray(toks), "encoder_embeds": jnp.asarray(frames)})
    got = _port_model(dtype)({"tokens": toks, "encoder_embeds": frames})
    assert got.dtype == torch.float32
    assert_close(got, want, dtype)


def test_prefill_then_decode_matches_the_full_forward():
    """The reference's ``test_prefill_decode_matches_forward`` for the
    port (f32, its tolerance): each decode step after the prompt against
    the full forward over prompt and steps at that position, the frames
    encoded once at prefill."""
    rc, _ = _cfgs("float32")
    model = _port_model("float32", seed=1)
    frames, toks = _frames(rc, seed=4), _tokens(rc.vocab, PROMPT + STEPS,
                                                seed=5)
    full = model({"tokens": toks, "encoder_embeds": frames})
    assert full.shape == (B, PROMPT + STEPS, rc.vocab)
    _, cache = model.prefill({"tokens": toks[:, :PROMPT],
                              "encoder_embeds": frames}, MAX_SEQ)
    for t in range(PROMPT, PROMPT + STEPS):
        got, cache = model.decode_step(cache, toks[:, t:t + 1])
        np.testing.assert_allclose(got.numpy(), full[:, t:t + 1].numpy(),
                                   rtol=F32_RTOL, atol=F32_ATOL)


def test_decode_encodes_the_extras_when_the_cache_has_no_enc_out():
    """The reference's ``decode_step`` reads ``enc_out`` from the cache,
    and only where the cache has none encodes ``batch_extras``'
    frames: both give the same step, and extras beside a cached
    ``enc_out`` are not read."""
    rc, _ = _cfgs("float32")
    model = _port_model("float32")
    frames, toks = _frames(rc), _tokens(rc.vocab, PROMPT + 1)
    _, cache = model.prefill({"tokens": toks[:, :PROMPT],
                              "encoder_embeds": frames}, MAX_SEQ)
    bare = {"layers": [{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                        for k, v in c.items()} for c in cache["layers"]],
            "len": cache["len"]}
    want, _ = model.decode_step(cache, toks[:, PROMPT:],
                                batch_extras={"encoder_embeds":
                                              np.zeros_like(frames)})
    got, _ = model.decode_step(bare, toks[:, PROMPT:],
                               batch_extras={"encoder_embeds": frames})
    assert torch.equal(got, want)


# ---------------------------------------------------------------- params

def test_params_and_param_count():
    """The port holds the reference's parameters, the encoder's and the
    cross-attention's included: as many as the reference's tree, which
    is ``param_count()`` plus what the analytic count leaves out (the two
    final norms and each decoder layer's cross norm); the cross group and
    the encoder's matrices in the activation type, every norm in f32."""
    rc, pc = _cfgs("bfloat16")
    model = _port_model("bfloat16")
    leaves = sum(a.size for a in jax.tree.leaves(_ref_params("bfloat16")))
    assert model.n_params() == leaves == (
        pc.param_count() + pc.d_model * (2 + pc.n_layers))
    layer = model.layers[0]
    assert layer.cross["wk"].dtype == torch.bfloat16
    assert layer.norm_cross["scale"].dtype == torch.float32
    assert model.encoder[0].mlp["wi"].dtype == torch.bfloat16
    assert model.encoder_norm["scale"].dtype == torch.float32
    drawn = init_params(pc, torch.Generator().manual_seed(0))
    assert len(drawn["encoder"]["layers"]) == pc.encoder.n_layers
    assert set(drawn["layers"][0]) == {"norm1", "mixer", "norm_cross",
                                       "cross", "norm2", "mlp"}
