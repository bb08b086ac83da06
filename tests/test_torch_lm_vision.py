"""qwen2-vl's vision stub and M-RoPE positions in the port against the
reference's, on the CPU.

qwen2-vl smoke (4 layers, d 64, 4 heads of 16 over 2 kv heads, M-RoPE's
three sections, 16 patches), the reference's ``init_params(PRNGKey(0))``
carried across by ``params_from_jax``; the patch embeddings a seeded
normal draw, as the reference's own tests draw them.  Two kinds of
positions:

* the model's own, 0..P+S-1 on all three sections (attention over a
  prompt may take the flash kernels on the GPU: they mask by index);
* the caller's, as qwen2-vl gives them: the patches on a 4 x 4 grid at
  time 0 ((0, row, column)), then the text from 4 on, the same on all
  three sections.  The reference masks by the first section, so the 16
  patches attend to each other both ways; those prompts take the plain
  route (``index_positions=False``), never the kernels.

Tolerances as in ``test_torch_lm_model.py``: f32 rtol and atol 1e-3, bf16
RMS(difference) at most 3e-2 of the reference's RMS; greedy tokens,
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
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import Transformer, params_from_jax
from repro_torch.models import layers as PL

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ARCH = "qwen2-vl-2b"
DTYPES = ["float32", "bfloat16"]
POSITIONS = ["own", "caller"]
B, PROMPT, STEPS, MAX_SEQ = 2, 10, 6, 48
F32_RTOL, F32_ATOL = 1e-3, 1e-3
BF16_RMS = 3e-2


def _cfgs(dtype):
    return (dataclasses.replace(ref_config(ARCH, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype))


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


def grid_positions(n_patches: int, s: int, b: int = B) -> np.ndarray:
    """qwen2-vl's M-RoPE positions (b, P + s, 3): the patches on a square
    grid at time 0, (0, row, column), then the text after the grid's
    largest index, the same on all three sections."""
    side = int(round(np.sqrt(n_patches)))
    rows, cols = np.divmod(np.arange(n_patches), side)
    patches = np.stack([np.zeros(n_patches, int), rows, cols], axis=-1)
    text = np.repeat((side + np.arange(s))[:, None], 3, axis=1)
    return np.broadcast_to(np.concatenate([patches, text])[None],
                           (b, n_patches + s, 3)).astype(np.int32).copy()


def _batch(cfg, s, positions: str, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
             "patch_embeds": rng.normal(0, 1, (B, cfg.n_patches, cfg.d_model))
             .astype(np.float32)}
    if positions == "caller":
        batch["positions"] = grid_positions(cfg.n_patches, s)
    return batch


@functools.cache
def _ref_prefill_fn(dtype):
    rc, _ = _cfgs(dtype)
    return jax.jit(lambda p, b: RT.prefill(p, b, rc, MAX_SEQ))


@functools.cache
def _ref_decode_fn(dtype):
    rc, _ = _cfgs(dtype)
    return jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rc))


@functools.cache
def _ref_forward_fn(dtype):
    rc, _ = _cfgs(dtype)

    def fwd(params, batch):
        x, positions, enc_out, pad = RT._prepare_inputs(params, rc, batch)
        h, _, _ = RT._stack(rc, params, x, positions, enc_out=enc_out,
                            remat=False)
        h = RT.L.rmsnorm(params["final_norm"], h, rc.norm_eps)
        return RT._lm_logits(params, rc, h[:, pad:])
    return jax.jit(fwd)


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("positions", POSITIONS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_the_reference(dtype, positions):
    """Prefill over 16 patches and a 10-token prompt (last logits, every
    layer's ring with its positions, ``len`` 26), then 6 decode steps at
    positions 26.. on all three sections (the reference's, whatever the
    caller's positions were).  In f32 both decode greedily, each from its
    own argmax, and the tokens are equal; in bf16 both are fed the same
    tokens."""
    rc, _ = _cfgs(dtype)
    tree, model = _ref_params(dtype), _port_model(dtype)
    batch = _batch(rc, PROMPT + STEPS, positions)
    prompt = {**batch, "tokens": batch["tokens"][:, :PROMPT]}
    if positions == "caller":
        prompt["positions"] = batch["positions"][:, :rc.n_patches + PROMPT]
    want, cw = _ref_prefill_fn(dtype)(tree, _jnp(prompt))
    got, cg = model.prefill(prompt, MAX_SEQ)
    assert got.shape == (B, 1, rc.vocab)
    assert_close(got, want, dtype)
    assert cg["len"] == int(cw["len"]) == rc.n_patches + PROMPT
    for step in range(STEPS + 1):
        for i, g in enumerate(cg["layers"]):
            w = jax.tree.map(lambda a: a[i], cw["layers"][0])
            assert_close(g["k"], w["k"], dtype)
            assert_close(g["v"], w["v"], dtype)
            np.testing.assert_array_equal(g["pos"].numpy(),
                                          np.asarray(w["pos"]))
            assert g["write_idx"] == int(w["write_idx"])
        if step == STEPS:
            break
        if dtype == "float32":
            nxt_w = np.asarray(jnp.argmax(want[:, -1], -1))[:, None]
            nxt_g = got[:, -1].argmax(-1)[:, None].numpy()
            np.testing.assert_array_equal(nxt_g, nxt_w)
        else:
            nxt_w = nxt_g = batch["tokens"][:, PROMPT + step:][:, :1]
        want, cw = _ref_decode_fn(dtype)(tree, cw,
                                         jnp.asarray(nxt_w, jnp.int32))
        got, cg = model.decode_step(cg, nxt_g)
        assert_close(got, want, dtype)
        assert cg["len"] == int(cw["len"])


@pytest.mark.parametrize("positions", POSITIONS)
def test_full_forward_matches_the_reference_on_the_tokens(positions):
    """The forward's logits cover the tokens only (the patches' positions
    left out, as the reference's training forward strips them)."""
    rc, _ = _cfgs("float32")
    batch = _batch(rc, PROMPT, positions, seed=2)
    want = _ref_forward_fn("float32")(_ref_params("float32"), _jnp(batch))
    got = _port_model("float32")(batch)
    assert got.shape == (B, PROMPT, rc.vocab)
    assert_close(got, want, "float32")


def test_prefill_then_decode_matches_the_full_forward():
    """The reference's ``test_prefill_decode_matches_forward`` for the
    port (f32, its tolerance), with the model's own positions: each decode
    step after patches and prompt against the full forward at that
    position."""
    rc, _ = _cfgs("float32")
    model = _port_model("float32", seed=1)
    batch = _batch(rc, PROMPT + STEPS, "own", seed=3)
    full = model(batch)
    _, cache = model.prefill({**batch, "tokens": batch["tokens"][:, :PROMPT]},
                             MAX_SEQ)
    for t in range(PROMPT, PROMPT + STEPS):
        got, cache = model.decode_step(cache, batch["tokens"][:, t:t + 1])
        np.testing.assert_allclose(got.numpy(), full[:, t:t + 1].numpy(),
                                   rtol=F32_RTOL, atol=F32_ATOL)


def test_caller_positions_change_the_answer():
    """The grid positions are not the indices: the same batch under the
    model's own positions gives other logits (both the reference's), so
    the two routes below are not interchangeable."""
    rc, _ = _cfgs("float32")
    batch = _batch(rc, PROMPT, "caller")
    own = {k: v for k, v in batch.items() if k != "positions"}
    fwd = _ref_forward_fn("float32")
    tree = _ref_params("float32")
    assert np.abs(_np(fwd(tree, _jnp(batch)))
                  - _np(fwd(tree, _jnp(own)))).max() > 1e-2


@pytest.mark.parametrize("positions", POSITIONS)
def test_attention_route_follows_whose_positions(monkeypatch, positions):
    """Every prompt attention layer tells ``kernel_route`` whether its
    positions are the indices: the model's own are, the caller's are not
    (so on the GPU they take the plain route, which masks by position as
    the reference does).  Decode steps and the CPU never take the
    kernels."""
    rc, _ = _cfgs("float32")
    seen = []
    route = PL.kernel_route

    def spy(**kw):
        seen.append(kw)
        return route(**kw)
    monkeypatch.setattr(PL, "kernel_route", spy)
    model = _port_model("float32")
    batch = _batch(rc, PROMPT, positions)
    _, cache = model.prefill(batch, MAX_SEQ)
    assert len(seen) == rc.n_layers
    assert all(kw["index_positions"] is (positions == "own")
               and not kw["decode"] and not kw["on_gpu"] for kw in seen)
    seen.clear()
    model.decode_step(cache, batch["tokens"][:, :1])
    assert len(seen) == rc.n_layers and all(kw["decode"] for kw in seen)
