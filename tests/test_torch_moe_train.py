"""MoE training in the port against the reference, on the CPU: the
training forward with its aux losses, the train step, checkpoints and the
driver.

deepseek-moe and qwen3-moe smoke in f32, the reference's
``init_params(PRNGKey(0))`` carried across, batches of 2 x 24 (the step:
4 x 24) tokens from a numpy seed with some labels -1.  The oracle is the
reference's jitted ``forward_train`` and ``make_train_step`` with no
mesh (ROADMAP queue 3, note c); the limits are the dense families'
(``test_torch_lm_train.py``, ``test_torch_train_step.py``):

* the loss, ``moe_lb`` and ``moe_z`` within 1e-5 relative; every
  gradient leaf within 1e-3 of its largest |grad| (one bf16 step, 2**-7,
  more for the leaves ``cast_params_bf16`` rounds, as both sides round
  them); the grad norm within 1e-3 relative;
* a training state through ``ckpt`` both ways bitwise, in the
  reference's stacked layout with the MoE's nested ``shared`` group.
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
from repro.models import transformer as RT
from repro.optim import adamw as ref_adamw
from repro_torch import ckpt
from repro_torch.configs import get_config
from repro_torch.launch import make_train_step
from repro_torch.launch.train import build_argparser, config_from_args, main
from repro_torch.models import (forward_train, params_from_jax,
                                params_to_jax, train_state_from_jax,
                                train_state_template, train_state_to_jax)
from repro_torch.optim import (cosine_schedule, global_norm, tree_leaves,
                               tree_unflatten)

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

MOE = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
B, S = 2, 24
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_LIMIT = 1e-3
GNORM_RTOL = 1e-3
BF16_STEP = 2.0 ** -7
SETTINGS = [(1, False), (2, False), (1, True), (2, True)]
IDS = ["mb1", "mb2", "mb1-bf16", "mb2-bf16"]
AUX = ("moe_lb", "moe_z")


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
        limit = GRAD_LIMIT + (BF16_STEP if cast and w.ndim >= 2 else 0)
        err = np.abs(g - w).max()
        assert err <= limit * np.abs(w).max(), (path, err, np.abs(w).max())


def _rel(a, b):
    a, b = (float(v.detach()) if isinstance(v, torch.Tensor) else float(v)
            for v in (a, b))
    return abs(a - b) / abs(b)


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


@pytest.mark.parametrize("arch", MOE)
def test_forward_train_loss_aux_and_gradients_match_the_reference(arch):
    want_loss, want_m, want_grads = _ref_forward(arch)
    loss, metrics, grads = _port_forward(arch)
    assert set(metrics) == set(want_m) == {"ce", "ntokens", *AUX}
    assert _rel(loss, want_loss) <= LOSS_RTOL
    for k in ("ce", *AUX):
        assert metrics[k].dtype == torch.float32
        assert _rel(metrics[k], want_m[k]) <= LOSS_RTOL, k
    # the loss is the cross-entropy plus each aux sum over the 4 layers
    want = metrics["ce"] + metrics["moe_lb"] / 4 + metrics["moe_z"] / 4
    assert torch.equal(loss, want.detach())
    _assert_grads(params_to_jax(grads, _cfgs(arch)[1]), want_grads)


@pytest.mark.parametrize("arch", MOE)
def test_recomputation_gives_the_same_gradients_and_aux_bitwise(arch):
    loss_a, m_a, g_a = _port_forward(arch, remat=True)
    loss_b, m_b, g_b = _port_forward(arch, remat=False)
    assert torch.equal(loss_a, loss_b)
    for k in AUX:
        assert torch.equal(m_a[k], m_b[k])
    for a, b in zip(tree_leaves(g_a), tree_leaves(g_b)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- the step

def _step_batch(vocab):
    return _batch(vocab, b=4, seed=3)


@functools.cache
def _ref_step(microbatches, cast):
    """The reference's jitted first step on deepseek smoke:
    (state before, metrics, state after) as numpy."""
    rc, _ = _cfgs("deepseek-moe-16b")
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
    m = 0.1 * clip * g), grad norm and aux metrics.  A microbatched step
    reports the microbatches' mean aux losses (the reference's reports
    none): each microbatch's own unmicrobatched step gives them."""
    rc, pc = _cfgs("deepseek-moe-16b")
    before, metrics, after = _ref_step(microbatches, cast)
    step = make_train_step(pc, cosine_schedule(LR, 0, 10),
                           microbatches=microbatches, cast_params_bf16=cast)
    batch = _step_batch(rc.vocab)
    state = train_state_from_jax(before, pc)
    loss, got_m, grads = step.loss_and_grads(state, batch)
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    gnorm = metrics["grad_norm"]
    assert abs(float(global_norm(grads)) - gnorm) <= GNORM_RTOL * gnorm
    clip = min(1.0, 1.0 / max(gnorm, 1e-9))
    want = jax.tree.map(lambda m: m / np.float32(0.1) / np.float32(clip),
                        after.m)
    _assert_grads(params_to_jax(grads, pc), want, cast)
    assert set(got_m) == ({"ce", "ntokens", *AUX} if microbatches == 1
                          else set(AUX))
    if microbatches == 1:
        for k in AUX:
            assert _rel(got_m[k], metrics[k]) <= LOSS_RTOL, k
    else:
        one = make_train_step(pc, cosine_schedule(LR, 0, 10),
                              cast_params_bf16=cast)
        each = [one.loss_and_grads(state, {k: v[i * 2:(i + 1) * 2]
                                           for k, v in batch.items()})[1]
                for i in range(2)]
        for k in AUX:
            mean = (each[0][k] + each[1][k]) / 2
            assert _rel(got_m[k], mean) <= LOSS_RTOL, k
    new, new_m = step.apply(state, grads, loss, got_m)
    assert new.step == 1 and set(AUX) <= set(new_m)
    got = jax.tree.leaves(params_to_jax(new.params, pc))
    for (path, w), g in zip(_paths(after.params), got):
        assert np.abs(g - w).max() <= 2 * LR, path


# ---------------------------------------------------------------- checkpoints

def test_moe_train_state_round_trips_through_ckpt_both_ways(tmp_path):
    """A port state after one step, saved by the port: the reference's
    ``ckpt.restore`` reads it bitwise into its own tree (the nested
    ``['moe']['shared']`` leaves included), and the reference's save of
    the same state restores into the port bitwise."""
    rc, pc = _cfgs("deepseek-moe-16b")
    before, _, _ = _ref_step(1, False)
    state = train_state_from_jax(before, pc)
    step = make_train_step(pc, cosine_schedule(LR, 0, 10))
    state, _ = step(state, _step_batch(rc.vocab))
    saved = train_state_to_jax(state, pc)
    ckpt.save(saved, 1, tmp_path / "port")
    keys = set(ckpt.flatten(saved))
    assert ".params['blocks'][0]['moe']['shared']['wi']" in keys
    assert ".m['blocks'][0]['moe']['router']" in keys
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

def test_driver_trains_and_logs_the_aux_losses(capsys):
    """deepseek-moe smoke (routed and shared experts) through the driver:
    the loss falls over 20 steps and both aux losses are logged each
    step (the driver's code is the same for every family)."""
    stats = {}
    losses = main(["--arch", "deepseek-moe-16b", "--steps", "20", "--batch",
                   "4", "--seq", "32", "--lr", "8e-3", "--log-every", "5",
                   "--device", "cpu"], stats=stats)
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    for k in AUX:
        assert len(stats[k]) == 20 and all(np.isfinite(stats[k]))
    assert stats["moe_lb"][0] > 0.5
    out = capsys.readouterr().out
    assert "moe_lb=" in out and "moe_z=" in out


def test_layer_cut_keeps_the_full_width():
    """``--full --n-layers 4`` keeps qwen3-moe-30b-a3b's width, experts and
    vocabulary and cuts its depth from 48 to 4."""
    cfg = config_from_args(build_argparser().parse_args(
        ["--arch", "qwen3-moe-30b-a3b", "--full", "--n-layers", "4"]))
    full = get_config("qwen3-moe-30b-a3b")
    assert cfg == dataclasses.replace(full, n_layers=4)
    assert (cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k, cfg.vocab) == \
        (2048, 128, 8, 151936)
    assert 3.0e9 < cfg.param_count() < 3.3e9
