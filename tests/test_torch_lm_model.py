"""The port's dense decoders against the reference's, on the CPU.

The weights are the reference's ``init_params(PRNGKey(0))``, carried across
by ``params_from_jax``; the tokens come from a numpy seed.  For gemma3,
yi, starcoder2 and chatglm3 smoke: prefill's last logits and its whole
cache, then 8 decode steps, in f32 and in bf16.

Tolerances.  bf16: RMS(difference) at most 3e-2 of the reference's RMS,
for the logits and for each layer's cached k and v (the port rounds to
bf16 where the reference's compiled blocks do, so the two agree to f32
noise in most cases).  f32: rtol 1e-3, atol 1e-3, the tolerance the
reference's own cache tests hold its prefill and decode to against its
forward.  A tighter f32 bound does not hold for any two computations of
these models: their random attention weights make near-one-hot
probabilities that magnify last-place differences layer by layer, and the
reference's own prefill misses rtol 1e-4, atol 1e-5 against its own
forward on gemma3 smoke (test below).  The layer tests hold f32 to rtol
1e-4, atol 1e-5 on the same inputs.  ``pos``, ``write_idx`` and ``len``
must be equal.
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
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import Transformer, init_params, params_from_jax

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

DENSE = ["gemma3-12b", "yi-9b", "starcoder2-3b", "chatglm3-6b"]
# served since ROADMAP item 4e (test_torch_lm_encoder.py and
# test_torch_lm_vision.py hold them to the reference)
STUB_SERVED = ["qwen2-vl-2b", "whisper-large-v3"]
# served since ROADMAP item 4d (test_torch_lm_mamba.py holds them to the
# reference)
MAMBA_SERVED = ["jamba-1-5-large-398b", "mamba2-780m"]
DTYPES = ["float32", "bfloat16"]
B, PROMPT, STEPS, MAX_SEQ = 2, 20, 8, 64
F32_RTOL, F32_ATOL = 1e-3, 1e-3
BF16_RMS = 3e-2


def _cfgs(arch, dtype):
    return (dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        rms = np.sqrt(np.mean(np.square(got - want)))
        assert rms <= BF16_RMS * np.sqrt(np.mean(np.square(want))), rms


@functools.cache
def _ref_params(arch, dtype, seed=0):
    rc, _ = _cfgs(arch, dtype)
    return jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(seed),
                                                    rc))


@functools.cache
def _port_model(arch, dtype, seed=0):
    _, pc = _cfgs(arch, dtype)
    return Transformer(pc, params_from_jax(_ref_params(arch, dtype, seed), pc),
                       device="cpu")


def _tokens(vocab, n, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)) \
        .astype(np.int32)


@functools.cache
def _ref_prefill_fn(arch, dtype, max_seq):
    rc, _ = _cfgs(arch, dtype)
    return jax.jit(lambda p, b: RT.prefill(p, b, rc, max_seq))


@functools.cache
def _ref_decode_fn(arch, dtype):
    rc, _ = _cfgs(arch, dtype)
    return jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rc))


@functools.cache
def _ref_forward_fn(arch, dtype):
    rc, _ = _cfgs(arch, dtype)

    def fwd(params, tokens):
        x, positions, _, _ = RT._prepare_inputs(params, rc,
                                                {"tokens": tokens})
        h, _, _ = RT._stack(rc, params, x, positions, remat=False)
        h = RT.L.rmsnorm(params["final_norm"], h, rc.norm_eps)
        return RT._lm_logits(params, rc, h)
    return jax.jit(fwd)


def _ref_layer_cache(cache, cfg, i):
    """Layer i of the reference's cache: block i // period of period
    position i % period."""
    c = cache["layers"][i % cfg.period]
    b = i // cfg.period
    return {"k": c["k"][b], "v": c["v"][b], "pos": c["pos"][b],
            "write_idx": c["write_idx"][b]}


def _assert_cache(got, want, cfg, dtype):
    assert got["len"] == int(want["len"])
    assert len(got["layers"]) == cfg.n_layers
    for i, g in enumerate(got["layers"]):
        w = _ref_layer_cache(want, cfg, i)
        assert_close(g["k"], w["k"], dtype)
        assert_close(g["v"], w["v"], dtype)
        np.testing.assert_array_equal(g["pos"].numpy(), np.asarray(w["pos"]))
        assert g["write_idx"] == int(w["write_idx"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference(arch, dtype):
    rc, _ = _cfgs(arch, dtype)
    tree, model = _ref_params(arch, dtype), _port_model(arch, dtype)
    toks = _tokens(rc.vocab, PROMPT + STEPS)
    want, cw = _ref_prefill_fn(arch, dtype, MAX_SEQ)(
        tree, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    got, cg = model.prefill({"tokens": toks[:, :PROMPT]}, MAX_SEQ)
    assert got.dtype == torch.float32 and got.shape == (B, 1, rc.vocab)
    assert_close(got, want, dtype)
    _assert_cache(cg, cw, rc, dtype)
    decode = _ref_decode_fn(arch, dtype)
    for t in range(PROMPT, PROMPT + STEPS):
        want, cw = decode(tree, cw, jnp.asarray(toks[:, t:t + 1]))
        got, cg = model.decode_step(cg, toks[:, t:t + 1])
        assert_close(got, want, dtype)
    _assert_cache(cg, cw, rc, dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_the_full_forward(arch):
    """The counterpart of the reference's
    ``test_prefill_decode_matches_forward`` for the port alone (f32, its
    tolerance): each of 8 decode steps after a 20-token prompt against the
    full forward at that position.  On gemma3's local layers (ring 24) the
    decode wraps the ring, which the reference handles correctly."""
    rc, _ = _cfgs(arch, "float32")
    model = _port_model(arch, "float32")
    toks = _tokens(rc.vocab, PROMPT + STEPS, seed=2)
    full = model({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :PROMPT]}, MAX_SEQ)
    for t in range(PROMPT, PROMPT + STEPS):
        got, cache = model.decode_step(cache, toks[:, t:t + 1])
        np.testing.assert_allclose(got.numpy(), full[:, t:t + 1].numpy(),
                                   rtol=1e-3, atol=1e-3)


def test_reference_misses_a_tighter_f32_bound_against_its_own_forward():
    """Why the model checks hold f32 to 1e-3: the reference's prefill on
    gemma3 smoke differs from its own forward by more than rtol 1e-4, atol
    1e-5, and by less than 1e-3."""
    rc, _ = _cfgs("gemma3-12b", "float32")
    tree = _ref_params("gemma3-12b", "float32")
    toks = _tokens(rc.vocab, PROMPT + STEPS)
    pre, _ = _ref_prefill_fn("gemma3-12b", "float32", MAX_SEQ)(
        tree, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    # the forward over a longer sequence, at the prompt's last position
    fwd = _ref_forward_fn("gemma3-12b", "float32")(tree, jnp.asarray(toks))
    pre, last = _np(pre), _np(fwd[:, PROMPT - 1:PROMPT])
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(pre, last, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pre, last, rtol=F32_RTOL, atol=F32_ATOL)


# ROADMAP queue 3, note k: a prompt longer than a local layer's ring (24 on
# gemma3 smoke) leaves its last 24 positions in slots 0..23, and the first
# decode step writes slot len % 24, evicting a position still inside the
# window when len % 24 >= 9.  At a 40-token prompt the reference's decode
# differs from its own forward; the port reproduces it.
NOTE_K_PROMPT = 40


@functools.cache
def _note_k_runs():
    rc, _ = _cfgs("gemma3-12b", "float32")
    tree = _ref_params("gemma3-12b", "float32", seed=2)
    toks = _tokens(rc.vocab, NOTE_K_PROMPT + 1, seed=3)
    _, cache = _ref_prefill_fn("gemma3-12b", "float32", MAX_SEQ)(
        tree, {"tokens": jnp.asarray(toks[:, :NOTE_K_PROMPT])})
    ref_dec, _ = _ref_decode_fn("gemma3-12b", "float32")(
        tree, cache, jnp.asarray(toks[:, NOTE_K_PROMPT:]))
    ref_fwd = _ref_forward_fn("gemma3-12b", "float32")(tree,
                                                       jnp.asarray(toks))
    return toks, _np(ref_dec), _np(ref_fwd[:, -1:])


def test_note_k_port_equals_the_reference_past_the_ring():
    toks, ref_dec, _ = _note_k_runs()
    model = _port_model("gemma3-12b", "float32", seed=2)
    _, cache = model.prefill({"tokens": toks[:, :NOTE_K_PROMPT]}, MAX_SEQ)
    assert [c["pos"][0, 0].item() for c in cache["layers"][:5]] == [16] * 5
    got, _ = model.decode_step(cache, toks[:, NOTE_K_PROMPT:])
    np.testing.assert_allclose(got.numpy(), ref_dec, rtol=F32_RTOL,
                               atol=F32_ATOL)


def test_note_k_reference_decode_differs_from_its_forward_past_the_ring():
    _, ref_dec, ref_fwd = _note_k_runs()
    assert np.abs(ref_dec - ref_fwd).max() > 0.1


@pytest.mark.parametrize("arch", STUB_SERVED + MAMBA_SERVED)
def test_unserved_families_raise(arch):
    """The families that raised at build before their items were ported
    (the encoder and stub families: 4e; the Mamba families: 4d) now
    build, draw their parameters and take a prompt, with their stub's
    inputs (frames for whisper, patches before the tokens for qwen2-vl:
    the cache's ``len`` counts them)."""
    cfg = get_config(arch, smoke=True)
    model = Transformer(cfg, device="cpu")
    assert len(init_params(cfg, torch.Generator().manual_seed(0))
               ["layers"]) == cfg.n_layers
    batch = {"tokens": [[1, 2, 3, 4]]}
    rng = np.random.default_rng(0)
    if cfg.frontend == "audio_stub":
        batch["encoder_embeds"] = rng.normal(
            size=(1, cfg.encoder.seq_len, cfg.d_model))
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.normal(size=(1, cfg.n_patches,
                                                 cfg.d_model))
    logits, cache = model.prefill(batch, 32)
    assert logits.shape == (1, 1, cfg.vocab)
    assert torch.isfinite(logits).all()
    assert cache["len"] == 4 + (cfg.n_patches
                                if cfg.frontend == "vision_stub" else 0)


@pytest.mark.parametrize("arch", DENSE)
def test_param_count(arch):
    """The port holds the reference's parameters: as many as its tree, and
    ``param_count()`` plus the final norm's scale (which the analytic count
    leaves out)."""
    cfg = get_config(arch, smoke=True)
    model = _port_model(arch, "bfloat16")
    leaves = sum(a.size for a in jax.tree.leaves(_ref_params(arch,
                                                             "bfloat16")))
    assert model.n_params() == leaves == cfg.param_count() + cfg.d_model
    # matrices in the activation type, norms in f32
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0].mixer["wq"].dtype == torch.bfloat16
    assert model.layers[0].norm1["scale"].dtype == torch.float32


def test_seeded_weights_are_the_f32_draw_cast():
    """A bf16 model drawn from a seed holds the f32 model's weights cast
    to bf16, so the two compute the same function in two types."""
    _, pc = _cfgs("gemma3-12b", "float32")
    m32 = Transformer(pc, device="cpu", seed=4)
    m16 = Transformer(dataclasses.replace(pc, dtype="bfloat16"),
                      device="cpu", seed=4)
    for a, b in zip(m32.parameters(), m16.parameters()):
        assert torch.equal(a.to(b.dtype), b)


def test_model_defaults_to_the_gpu():
    cfg = get_config("gemma3-12b", smoke=True)
    if torch.cuda.is_available():
        assert Transformer(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Transformer(cfg)
