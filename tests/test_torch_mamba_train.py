"""Mamba2 training in the port against the reference, on the CPU: the
layer's gradients, the training forward, the train step, checkpoints and
the driver.

mamba2 smoke (four Mamba layers) and jamba smoke (Mamba, attention and MoE
layers in one period of 8) in f32, the reference's
``init_params(PRNGKey(0))`` carried across, batches of 2 x 24 (the step:
4 x 24) tokens from a numpy seed with some labels -1.  The oracle is the
reference's jitted ``forward_train`` and ``make_train_step`` with no
mesh (ROADMAP queue 3, note c); the limits are the other families'
(``test_torch_moe_train.py``):

* the loss within 1e-5 relative; every gradient leaf within 1e-3 of its
  largest |grad| (one bf16 step, 2**-7, more for the leaves
  ``cast_params_bf16`` rounds, as both sides round them); the grad norm
  within 1e-3 relative;
* the masked half of the SSD's decay matrix (exp of -inf) gives zero
  gradients, never NaN;
* a training state through ``ckpt`` both ways bitwise, in the reference's
  stacked layout with the mixer's nested ``norm`` group.
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
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.optim import adamw as ref_adamw
from repro_torch import ckpt
from repro_torch.configs import get_config
from repro_torch.launch import make_train_step
from repro_torch.launch.train import main
from repro_torch.models import (forward_train, params_from_jax,
                                params_to_jax, train_state_from_jax,
                                train_state_template, train_state_to_jax)
from repro_torch.models import layers as PL
from repro_torch.optim import (cosine_schedule, global_norm, tree_leaves,
                               tree_unflatten)

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

MAMBA = ["mamba2-780m", "jamba-1-5-large-398b"]
B, S = 2, 24
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_LIMIT = 1e-3
GNORM_RTOL = 1e-3
BF16_STEP = 2.0 ** -7
SETTINGS = [(1, False), (2, False), (1, True), (2, True)]
IDS = ["mb1", "mb2", "mb1-bf16", "mb2-bf16"]


def _cfgs(arch):
    return (dataclasses.replace(ref_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


@functools.cache
def _ref_params(arch):
    rc, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0),
                                                    rc))


def _batch(vocab, b=B, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, S)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1
    return {"tokens": tokens, "labels": labels}


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


# ---------------------------------------------------------------- the layer

@pytest.mark.parametrize("arch", MAMBA)
def test_mamba_layer_gradients_match_jax_grad(arch):
    """f32, two chunks of 32: the gradients of sum(out * r) with respect
    to every leaf of the mixer (the nested norm's scale included) and to
    x, each within 1e-3 of its largest |grad|; none is NaN although half
    of each chunk's decay matrix is exp(-inf)."""
    rc, pc = _cfgs(arch)
    tree = jax.tree.map(np.asarray, RL.mamba_init(jax.random.PRNGKey(5), rc))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 64, rc.d_model)).astype(np.float32)
    r = rng.normal(size=(B, 64, rc.d_model)).astype(np.float32)

    def ref_loss(p, x):
        return jnp.sum(RL.mamba_apply(p, x, rc)[0] * r)
    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        tree, jnp.asarray(x))
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                          .requires_grad_(True), tree)
    xp = torch.from_numpy(x.copy()).requires_grad_(True)
    out, _ = PL.mamba_apply(params, xp, pc)
    leaves = jax.tree.leaves(params)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                leaves + [xp])
    for g, w in zip(grads, jax.tree.leaves(want_p) + [want_x]):
        w = np.asarray(w)
        assert torch.isfinite(g).all()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_LIMIT * np.abs(w).max(), (err, np.abs(w).max())


# ---------------------------------------------------------------- forward

@functools.cache
def _ref_forward(arch):
    rc, _ = _cfgs(arch)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: RT.forward_train(p, b, rc), has_aux=True))
    (loss, metrics), grads = fn(
        _ref_params(arch),
        {k: jnp.asarray(v) for k, v in _batch(rc.vocab).items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _port_forward(arch, remat=True):
    rc, pc = _cfgs(arch)
    params = params_from_jax(_ref_params(arch), pc)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = forward_train(params, _batch(rc.vocab), pc, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, tree_unflatten(params, grads)


@pytest.mark.parametrize("arch", MAMBA)
def test_forward_train_loss_and_gradients_match_the_reference(arch):
    want_loss, want_m, want_grads = _ref_forward(arch)
    loss, metrics, grads = _port_forward(arch)
    assert set(metrics) == set(want_m)
    assert _rel(loss, want_loss) <= LOSS_RTOL
    for k in want_m:
        assert _rel(metrics[k], want_m[k]) <= LOSS_RTOL, k
    _assert_grads(params_to_jax(grads, _cfgs(arch)[1]), want_grads)


@pytest.mark.parametrize("arch", MAMBA)
def test_recomputation_gives_the_same_gradients_bitwise(arch):
    loss_a, _, g_a = _port_forward(arch, remat=True)
    loss_b, _, g_b = _port_forward(arch, remat=False)
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(tree_leaves(g_a), tree_leaves(g_b)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- the step

def _step_batch(vocab):
    return _batch(vocab, b=4, seed=3)


@functools.cache
def _ref_step(microbatches, cast):
    """The reference's jitted first step on mamba2 smoke: (state before,
    metrics, state after) as numpy."""
    rc, _ = _cfgs("mamba2-780m")
    step = jax.jit(ref_make_train_step(
        rc, ref_adamw.cosine_schedule(LR, 0, 10), microbatches=microbatches,
        cast_params_bf16=cast))
    before = jax.tree.map(np.asarray, ref_adamw.adamw_init(
        ref_init_params(jax.random.PRNGKey(0), rc)))
    after, metrics = step(jax.tree.map(jnp.asarray, before),
                          {k: jnp.asarray(v)
                           for k, v in _step_batch(rc.vocab).items()})
    return (before, {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, after))


@pytest.mark.parametrize("microbatches,cast", SETTINGS, ids=IDS)
def test_train_step_matches_the_reference(microbatches, cast):
    """The step's loss, gradients (the reference's from its first moment,
    m = 0.1 * clip * g), grad norm and updated parameters.  With the cast
    on, ``A_log``, ``D``, ``dt_bias`` and ``conv_b`` (two dims in the
    stacked layout) are rounded to bf16 in both, and the mixer runs its
    bf16 ``A_log`` through exp in bf16 as the reference does."""
    rc, pc = _cfgs("mamba2-780m")
    before, metrics, after = _ref_step(microbatches, cast)
    step = make_train_step(pc, cosine_schedule(LR, 0, 10),
                           microbatches=microbatches, cast_params_bf16=cast)
    state = train_state_from_jax(before, pc)
    loss, _, grads = step.loss_and_grads(state, _step_batch(rc.vocab))
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    gnorm = metrics["grad_norm"]
    assert abs(float(global_norm(grads)) - gnorm) <= GNORM_RTOL * gnorm
    clip = min(1.0, 1.0 / max(gnorm, 1e-9))
    want = jax.tree.map(lambda m: m / np.float32(0.1) / np.float32(clip),
                        after.m)
    _assert_grads(params_to_jax(grads, pc), want, cast)
    new, _ = step.apply(state, grads, loss, {})
    assert new.step == 1
    got = jax.tree.leaves(params_to_jax(new.params, pc))
    for (path, w), g in zip(_paths(after.params), got):
        assert np.abs(g - w).max() <= 2 * LR, path


# ---------------------------------------------------------------- checkpoints

def test_mamba_train_state_round_trips_through_ckpt_both_ways(tmp_path):
    """A port state after one step, saved by the port: the reference's
    ``ckpt.restore`` reads it bitwise into its own tree (the mixer's
    nested ``['norm']['scale']`` and its f32 ``A_log`` and ``dt_bias``
    included), and the reference's save of the same state restores into
    the port bitwise."""
    rc, pc = _cfgs("mamba2-780m")
    before, _, _ = _ref_step(1, False)
    state = train_state_from_jax(before, pc)
    step = make_train_step(pc, cosine_schedule(LR, 0, 10))
    state, _ = step(state, _step_batch(rc.vocab))
    saved = train_state_to_jax(state, pc)
    ckpt.save(saved, 1, tmp_path / "port")
    keys = set(ckpt.flatten(saved))
    for key in (".params['blocks'][0]['mixer']['norm']['scale']",
                ".m['blocks'][0]['mixer']['A_log']",
                ".v['blocks'][0]['mixer']['dt_bias']"):
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


# ---------------------------------------------------------------- the driver

def test_driver_trains_mamba2():
    """mamba2 smoke through the driver: 12 steps of 4 x 32 tokens (one
    chunk of 32 a sequence), the loss finite and falling."""
    stats = {}
    losses = main(["--arch", "mamba2-780m", "--steps", "12", "--batch", "4",
                   "--seq", "32", "--lr", "8e-3", "--log-every", "4",
                   "--device", "cpu"], stats=stats)
    assert len(losses) == 4 and all(np.isfinite(losses))   # steps 1, 4, 8, 12
    assert losses[-1] < losses[0]
    assert len(stats["loss"]) == 12 and all(np.isfinite(stats["grad_norm"]))
    assert stats["arch"] == "mamba2-smoke"
