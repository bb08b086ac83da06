"""Training the two modality-stub families in the port against the
reference, on the CPU: the training forward, the train step, the driver's
extras and training states carried both ways.

whisper smoke (an encoder of 2 layers over 30 frames, cross-attention in
each of 2 decoder layers) and qwen2-vl smoke (16 patches before the
tokens, M-RoPE) in f32 unless stated, the reference's
``init_params(PRNGKey(0))`` carried across, batches of 2 x 24 (the step:
4 x 24) tokens from a numpy seed with some labels -1, and the stubs'
inputs a seeded normal draw (the driver's zero frames would leave the
encoder's output zero and cross-attention with nothing to learn from).
The oracle is the reference's jitted ``forward_train`` and
``make_train_step`` with no mesh (ROADMAP queue 3, note c); the limits are
the other families' (``test_torch_mamba_train.py``):

* f32: the loss within 1e-5 relative, every gradient leaf within 1e-3 of
  its largest |grad| (one bf16 step, 2**-7, more for the leaves
  ``cast_params_bf16`` rounds, the encoder's stacked norm scales among
  them, as both sides round them), the grad norm within 1e-3 relative;
* bf16 activations: the loss within 3e-2 relative
  (``test_torch_lm_train.py``'s rule);
* a training state through ``ckpt`` both ways bitwise, in the reference's
  stacked layout with ``encoder['blocks']`` and the decoder's
  ``norm_cross`` and ``cross``;
* the driver's zero stub inputs give NaN gradients at depth in both
  packages (ROADMAP queue 3, note o).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore as ref_restore
from repro.ckpt import save as ref_save
from repro.configs import get_config as ref_config
from repro.data.lm_data import LMBatcher as RefBatcher
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import init_params as ref_init_params
from repro.models import transformer as RT
from repro.optim import adamw as ref_adamw
from repro_torch import ckpt
from repro_torch.configs import get_config
from repro_torch.data.lm_data import LMBatcher
from repro_torch.launch import make_train_step
from repro_torch.launch.train import main, stub_extras
from repro_torch.models import (forward_train, params_from_jax,
                                params_to_jax, train_state_from_jax,
                                train_state_template, train_state_to_jax)
from repro_torch.optim import (cosine_schedule, global_norm, tree_leaves,
                               tree_unflatten)

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

STUBS = ["whisper-large-v3", "qwen2-vl-2b"]
B, S = 2, 24
LR = 1e-3
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 3e-2
GRAD_LIMIT = 1e-3
GNORM_RTOL = 1e-3
BF16_STEP = 2.0 ** -7
SETTINGS = [(1, False), (2, False), (1, True)]
IDS = ["mb1", "mb2", "mb1-bf16"]


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


@functools.cache
def _ref_params(arch):
    rc, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0),
                                                    rc))


def _batch(cfg, b=B, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.normal(
            0, 1, (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        batch["encoder_embeds"] = rng.normal(
            0, 1, (b, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_grads(got_tree, want_tree, cast=False):
    got = jax.tree.leaves(got_tree)
    want = _paths(want_tree)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        g = np.asarray(g)
        assert np.isfinite(g).all(), path
        limit = GRAD_LIMIT + (BF16_STEP if cast and w.ndim >= 2 else 0)
        err = np.abs(g - w).max()
        assert err <= limit * np.abs(w).max(), (path, err, np.abs(w).max())


def _rel(a, b):
    a, b = (float(v.detach()) if isinstance(v, torch.Tensor) else float(v)
            for v in (a, b))
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------- forward

@functools.cache
def _ref_forward(arch, dtype="float32"):
    rc, _ = _cfgs(arch, dtype)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: RT.forward_train(p, b, rc), has_aux=True))
    (loss, metrics), grads = fn(
        _ref_params(arch),
        {k: jnp.asarray(v) for k, v in _batch(rc).items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _port_forward(arch, dtype="float32", remat=True):
    rc, pc = _cfgs(arch, dtype)
    params = params_from_jax(_ref_params(arch), pc)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = forward_train(params, _batch(rc), pc, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, tree_unflatten(params, grads)


@pytest.mark.parametrize("arch", STUBS)
def test_forward_train_f32_loss_and_gradients_match_the_reference(arch):
    """The loss over the tokens (qwen2-vl's patches left out), its
    metrics, and the gradients of every leaf: the encoder's, the cross
    groups' and the patches' path through the stack."""
    want_loss, want_m, want_grads = _ref_forward(arch)
    loss, metrics, grads = _port_forward(arch)
    assert set(metrics) == set(want_m)
    assert _rel(loss, want_loss) <= LOSS_RTOL
    for k in want_m:
        assert _rel(metrics[k], want_m[k]) <= LOSS_RTOL, k
    _assert_grads(params_to_jax(grads, _cfgs(arch)[1]), want_grads)


@pytest.mark.parametrize("arch", STUBS)
def test_forward_train_bf16_loss_matches_the_reference(arch):
    want_loss, _, _ = _ref_forward(arch, "bfloat16")
    loss, _, grads = _port_forward(arch, "bfloat16")
    assert _rel(loss, want_loss) <= BF16_LOSS_RTOL
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))


@pytest.mark.parametrize("arch", STUBS)
def test_recomputation_gives_the_same_gradients_bitwise(arch):
    """Recomputing each period block and each encoder layer in the
    backward pass changes no number."""
    loss_a, _, g_a = _port_forward(arch, remat=True)
    loss_b, _, g_b = _port_forward(arch, remat=False)
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(tree_leaves(g_a), tree_leaves(g_b)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- the step

@functools.cache
def _ref_step(arch, microbatches, cast):
    """The reference's jitted first step: (state before, metrics, state
    after) as numpy."""
    rc, _ = _cfgs(arch)
    step = jax.jit(ref_make_train_step(
        rc, ref_adamw.cosine_schedule(LR, 0, 10), microbatches=microbatches,
        cast_params_bf16=cast))
    before = jax.tree.map(np.asarray, ref_adamw.adamw_init(
        ref_init_params(jax.random.PRNGKey(0), rc)))
    after, metrics = step(jax.tree.map(jnp.asarray, before),
                          {k: jnp.asarray(v)
                           for k, v in _batch(rc, b=4, seed=3).items()})
    return (before, {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, after))


@pytest.mark.parametrize("microbatches,cast", SETTINGS, ids=IDS)
@pytest.mark.parametrize("arch", STUBS)
def test_train_step_matches_the_reference(arch, microbatches, cast):
    """The step's loss, gradients (the reference's from its first moment,
    m = 0.1 * clip * g), grad norm and updated parameters.  The stubs'
    inputs are cut into the microbatches with the tokens; with the cast
    on, the encoder's per-layer norm scales (two dims in the stacked
    layout) are rounded to bf16 in both, its final norm's not."""
    rc, pc = _cfgs(arch)
    before, metrics, after = _ref_step(arch, microbatches, cast)
    step = make_train_step(pc, cosine_schedule(LR, 0, 10),
                           microbatches=microbatches, cast_params_bf16=cast)
    state = train_state_from_jax(before, pc)
    loss, _, grads = step.loss_and_grads(state, _batch(rc, b=4, seed=3))
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    gnorm = metrics["grad_norm"]
    assert abs(float(global_norm(grads)) - gnorm) <= GNORM_RTOL * gnorm
    if cast and microbatches == 1 and arch == "whisper-large-v3":
        enc = grads["encoder"]
        assert enc["layers"][0]["norm1"]["scale"].dtype == torch.bfloat16
        assert enc["final_norm"]["scale"].dtype == torch.float32
    clip = min(1.0, 1.0 / max(gnorm, 1e-9))
    want = jax.tree.map(lambda m: m / np.float32(0.1) / np.float32(clip),
                        after.m)
    _assert_grads(params_to_jax(grads, pc), want, cast)
    new, _ = step.apply(state, grads, loss, {})
    assert new.step == 1
    got = jax.tree.leaves(params_to_jax(new.params, pc))
    for (path, w), g in zip(_paths(after.params), got):
        assert np.abs(g - w).max() <= 2 * LR, path


@pytest.mark.parametrize("arch,depth", [("qwen2-vl-2b", 12),
                                        ("whisper-large-v3", 10)])
def test_zero_stub_inputs_give_nan_gradients_at_depth_in_both(arch, depth):
    """ROADMAP queue 3, note o.  The driver's zero patches or frames stay
    exactly zero through every layer (a zero row's norm, attention over
    zero rows and MLP give zero), and each layer's RMSNorm multiplies a
    zero row's gradient by 1/sqrt(eps) = 1000, so at depth the gradient
    overflows and turns NaN, in the reference as in the port (f32, smoke
    width, ``depth`` layers, whisper's encoder as deep; the reference's
    are finite at 10 and 8 layers): the full models (28; 32 and 32) train
    to NaN from their first step on the driver's inputs.  The loss itself
    is finite, and at smoke depth the driver trains on the zeros
    (``test_driver_trains_whisper_on_its_zero_frames``)."""
    rc, pc = _cfgs(arch)
    rc = dataclasses.replace(rc, n_layers=depth)
    pc = dataclasses.replace(pc, n_layers=depth)
    if rc.encoder is not None:
        rc = dataclasses.replace(rc, encoder=dataclasses.replace(
            rc.encoder, n_layers=depth))
        pc = dataclasses.replace(pc, encoder=rc.encoder)
    batch = {k: v[:1, :8] if k in ("tokens", "labels") else np.zeros_like(
        v[:1]) for k, v in _batch(rc).items()}
    tree = jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0),
                                                    rc))
    want = jax.jit(jax.grad(lambda p, b: RT.forward_train(p, b, rc)[0]))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(tree, pc)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = forward_train(params, batch, pc)
    got = torch.autograd.grad(loss, leaves)
    assert torch.isfinite(loss)
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(want))
    assert any(bool(torch.isnan(g).any()) for g in got)


# ---------------------------------------------------------------- the driver

@pytest.mark.parametrize("arch", STUBS)
def test_driver_extras_are_the_references(arch):
    """The driver feeds the reference driver's extras: zero f32 arrays of
    (n_patches, d) or (encoder.seq_len, d) a row; the port's batcher with
    them gives the reference's batches bitwise."""
    rc, pc = _cfgs(arch)
    extras = stub_extras(pc)
    want = ({"patch_embeds": ((rc.n_patches, rc.d_model), np.float32)}
            if arch == "qwen2-vl-2b" else
            {"encoder_embeds": ((rc.encoder.seq_len, rc.d_model),
                                np.float32)})
    assert extras == want
    got_it = LMBatcher(pc.vocab, 2, 8, seed=4, extras=extras)
    ref_it = RefBatcher(rc.vocab, 2, 8, seed=4, extras=want)
    try:
        got, ref = next(iter(got_it)), next(iter(ref_it))
    finally:
        got_it.close()
        ref_it.close()
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    (name, ((n, d), _)), = extras.items()
    assert got[name].shape == (2, n, d) and not got[name].any()


def test_driver_trains_whisper_on_its_zero_frames():
    """whisper smoke through the driver (``--arch whisper-large-v3
    --smoke --device cpu``): 8 steps of 4 x 16 tokens on the zero frames,
    the loss finite and falling."""
    stats = {}
    losses = main(["--arch", "whisper-large-v3", "--steps", "8", "--batch",
                   "4", "--seq", "16", "--lr", "8e-3", "--log-every", "4",
                   "--device", "cpu"], stats=stats)
    assert len(losses) == 3 and all(np.isfinite(losses))   # steps 1, 4, 8
    assert losses[-1] < losses[0]
    assert len(stats["loss"]) == 8 and all(np.isfinite(stats["grad_norm"]))
    assert stats["arch"] == "whisper-smoke"


# ---------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("arch", STUBS)
def test_train_state_round_trips_through_ckpt_both_ways(arch, tmp_path):
    """A port state after one step, saved by the port: the reference's
    ``ckpt.restore`` reads it bitwise into its own tree (whisper's
    ``encoder['blocks']`` and ``encoder['final_norm']``, the decoder's
    ``norm_cross`` and ``cross``), and the reference's save of the same
    state restores into the port bitwise; the stacked layout itself
    round-trips exactly."""
    rc, pc = _cfgs(arch)
    before, _, _ = _ref_step(arch, 1, False)
    back = params_to_jax(params_from_jax(before.params, pc), pc)
    assert jax.tree.structure(back) == jax.tree.structure(before.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(before.params)):
        assert np.array_equal(a, b)
    state = train_state_from_jax(before, pc)
    step = make_train_step(pc, cosine_schedule(LR, 0, 10))
    state, _ = step(state, _batch(rc, b=4, seed=3))
    saved = train_state_to_jax(state, pc)
    ckpt.save(saved, 1, tmp_path / "port")
    keys = set(ckpt.flatten(saved))
    if arch == "whisper-large-v3":
        for key in (".params['encoder']['blocks']['mixer']['wq']",
                    ".m['encoder']['final_norm']['scale']",
                    ".v['blocks'][0]['cross']['wo']",
                    ".params['blocks'][0]['norm_cross']['scale']"):
            assert key in keys, key
    abstract = jax.eval_shape(lambda k: ref_adamw.adamw_init(
        ref_init_params(k, rc)), jax.random.PRNGKey(0))
    ref_state = ref_restore(tmp_path / "port", 1, abstract)
    assert int(ref_state.step) == 1
    for name in ("params", "m", "v"):
        want = _paths(getattr(saved, name))
        got = _paths(getattr(ref_state, name))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert np.array_equal(a, b)
    ref_save(ref_state, 1, tmp_path / "ref")
    back = train_state_from_jax(
        ckpt.restore(tmp_path / "ref", 1, train_state_template(pc),
                     device="cpu"), pc)
    assert back.step == 1
    for name in ("params", "m", "v"):
        for a, b in zip(tree_leaves(getattr(back, name)),
                        tree_leaves(getattr(state, name))):
            assert torch.equal(a, b.detach())
