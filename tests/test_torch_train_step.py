"""The port's train step against the reference's jitted ``make_train_step``
(no mesh), and training checkpoints across the two packages, on the CPU.

starcoder2 smoke in f32 (``dataclasses.replace(cfg, dtype="float32")``),
the reference's ``init_params(PRNGKey(0))`` carried across, batches of
4 x 24 tokens from a numpy seed with some labels -1, the cosine schedule
at a peak of 1e-3 with no warm-up; each of the four settings of
``microbatches`` (1, 2) and ``cast_params_bf16`` (off, on).  The
reference takes three steps; the port takes each of them from the
reference's state before it (a chaotic divergence of two f32 orders
would otherwise be all that a third step measures), on the same batch.

What is held, and why:

* the step's gradients (microbatches summed in f32 and divided, or taken
  with respect to the bf16 copies) against the reference's, read back
  from its first step's first moment (m = 0.1 * clip * g): within 1e-3 of
  each leaf's largest |grad| (the forward tests' limit), and for a leaf
  the cast makes bf16, one bf16 step (2**-7) of that largest |grad| more,
  since both sides round those gradients to bf16; the loss within 1e-5
  relative, the grad norm within 1e-3 relative;
* the update: the port's step applied to its own gradients against the
  reference's ``adamw_update`` on the same gradients and state, as in the
  AdamW tests (rtol 1e-6 above a floor of 1e-6 of each leaf's largest
  magnitude);
* each of the three steps whole: the loss within 1e-5 relative and every
  parameter within 2 * lr of the reference's (AdamW's first step moves a
  parameter by about +-lr wherever its gradient is non-zero, so a sign
  that flips on a near-zero gradient moves it by 2 * lr).

Tighter bounds that the reference misses against itself (its jitted step
against the same step op by op, ``jax.disable_jit``): the grad norm
within 1e-5 relative, and all but 0.1% of the parameters within 1e-6
after one step; the last test pins both.
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
from repro.optim import adamw as ref_adamw
from repro_torch import ckpt
from repro_torch.configs import get_config
from repro_torch.launch import make_train_step
from repro_torch.models import (params_from_jax, params_to_jax,
                                train_state_from_jax, train_state_template,
                                train_state_to_jax)
from repro_torch.optim import (cosine_schedule, global_norm, tree_leaves,
                               tree_map)

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ARCH = "starcoder2-3b"
B, S, STEPS = 4, 24, 3
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_LIMIT = 1e-3
GNORM_RTOL = 1e-3
BF16_STEP = 2.0 ** -7
SETTINGS = [(1, False), (2, False), (1, True), (2, True)]
IDS = ["mb1", "mb2", "mb1-bf16", "mb2-bf16"]


def _cfgs():
    return (dataclasses.replace(ref_config(ARCH, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(ARCH, smoke=True),
                                dtype="float32"))


def _batches():
    rng = np.random.default_rng(3)
    vocab = _cfgs()[0].vocab
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        b["labels"][0, :3] = -1
        out.append(b)
    return out


def _host(state):
    return jax.tree.map(np.asarray, state)


@functools.cache
def _ref_init():
    rc, _ = _cfgs()
    return _host(ref_adamw.adamw_init(ref_init_params(jax.random.PRNGKey(0),
                                                      rc)))


@functools.cache
def _ref_run(microbatches, cast):
    """The reference's jitted steps from its init: [(state before, metrics,
    state after)] (numpy)."""
    rc, _ = _cfgs()
    step = jax.jit(ref_make_train_step(
        rc, ref_adamw.cosine_schedule(LR, 0, 10), microbatches=microbatches,
        cast_params_bf16=cast))
    state, out = _ref_init(), []
    for b in _batches():
        new, metrics = step(jax.tree.map(jnp.asarray, state),
                            {k: jnp.asarray(v) for k, v in b.items()})
        new = _host(new)
        out.append((state, {k: float(v) for k, v in metrics.items()}, new))
        state = new
    return out


def _port_step(microbatches, cast):
    _, pc = _cfgs()
    return make_train_step(pc, cosine_schedule(LR, 0, 10),
                           microbatches=microbatches, cast_params_bf16=cast)


def _port_state(ref_state):
    return train_state_from_jax(ref_state, _cfgs()[1])


def _paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_params_within_two_lr(got_state, want_state):
    got = jax.tree.leaves(params_to_jax(got_state.params, _cfgs()[1]))
    for (path, w), g in zip(_paths(want_state.params), got):
        assert np.isfinite(g).all(), path
        err = np.abs(g - w).max()
        assert err <= 2 * LR, (path, err)


def assert_state_close(got_state, want_state):
    """params, m and v within rtol 1e-6 above 1e-6 of each leaf's max."""
    pc = _cfgs()[1]
    assert got_state.step == int(want_state.step)
    for name in ("params", "m", "v"):
        got = jax.tree.leaves(params_to_jax(getattr(got_state, name), pc))
        for (path, w), g in zip(_paths(getattr(want_state, name)), got):
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{name}{path}")


@pytest.mark.parametrize("microbatches,cast", SETTINGS, ids=IDS)
def test_step_gradients_match_the_reference(microbatches, cast):
    before, metrics, after = _ref_run(microbatches, cast)[0]
    loss, _, grads = _port_step(microbatches, cast).loss_and_grads(
        _port_state(before), _batches()[0])
    assert abs(float(loss) - metrics["loss"]) <= LOSS_RTOL * metrics["loss"]
    gnorm = metrics["grad_norm"]
    assert abs(float(global_norm(grads)) - gnorm) <= GNORM_RTOL * gnorm
    # the cast: bf16 gradients for what the reference casts (every leaf of
    # two or more dims in its stacked layout: all but the final norm's
    # scale); microbatches sum them in f32
    pc = _cfgs()[1]
    for g in tree_leaves({k: v for k, v in grads.items()
                          if k != "final_norm"}):
        assert g.dtype == (torch.bfloat16 if cast and microbatches == 1
                           else torch.float32)
    assert grads["final_norm"]["scale"].dtype == torch.float32
    # the reference's gradient from its first moment: m = 0.1 * clip * g
    clip = min(1.0, 1.0 / max(gnorm, 1e-9))
    want = jax.tree.map(lambda m: m / np.float32(0.1) / np.float32(clip),
                        after.m)
    got = jax.tree.leaves(params_to_jax(grads, pc))
    for (path, w), g in zip(_paths(want), got):
        limit = GRAD_LIMIT + (BF16_STEP if cast and w.ndim >= 2 else 0)
        err = np.abs(g - w).max()
        assert err <= limit * np.abs(w).max(), (path, err, np.abs(w).max())


@pytest.mark.parametrize("microbatches,cast", SETTINGS, ids=IDS)
def test_step_update_is_adamw_on_its_gradients(microbatches, cast):
    """Each of the three steps: the port's update of the reference's state
    with the port's own gradients against the reference's
    ``adamw_update`` with the same gradients and lr."""
    pc = _cfgs()[1]
    step = _port_step(microbatches, cast)
    ref_update = jax.jit(ref_adamw.adamw_update)
    ref_lr = ref_adamw.cosine_schedule(LR, 0, 10)
    for (before, _, _), batch in zip(_ref_run(microbatches, cast),
                                     _batches()):
        state = _port_state(before)
        loss, metrics, grads = step.loss_and_grads(state, batch)
        g_np = params_to_jax(grads, pc)        # before the update scales it
        got, got_m = step.apply(state, grads, loss, metrics)
        want, want_m = ref_update(jax.tree.map(jnp.asarray, before),
                                  jax.tree.map(jnp.asarray, g_np),
                                  ref_lr(jnp.asarray(before.step)))
        assert got_m["lr"] == float(want_m["lr"])
        gnorm = float(want_m["grad_norm"])
        assert abs(float(got_m["grad_norm"]) - gnorm) <= 1e-6 * gnorm
        assert_state_close(got, _host(want))


@pytest.mark.parametrize("microbatches,cast", SETTINGS, ids=IDS)
def test_one_and_three_steps_match_the_reference(microbatches, cast):
    step = _port_step(microbatches, cast)
    for i, ((before, metrics, after), batch) in enumerate(
            zip(_ref_run(microbatches, cast), _batches())):
        got, got_m = step(_port_state(before), batch)
        assert got.step == int(after.step) == i + 1
        loss = metrics["loss"]
        assert abs(float(got_m["loss"]) - loss) <= LOSS_RTOL * loss, i
        assert_params_within_two_lr(got, after)
        for name in ("m", "v"):
            assert all(torch.isfinite(t).all()
                       for t in tree_leaves(getattr(got, name)))


def test_the_reference_misses_tighter_step_bounds_against_itself():
    """Why the grad norm is held to 1e-3 and not 1e-5, and the parameters
    to 2 * lr and not 1e-6 for all but 0.1%: the reference's first step
    evaluated op by op differs from its jitted one by more than both."""
    rc, _ = _cfgs()
    before, metrics, after = _ref_run(1, False)[0]
    fn = ref_make_train_step(rc, ref_adamw.cosine_schedule(LR, 0, 10))
    with jax.disable_jit():
        eager, eager_m = fn(jax.tree.map(jnp.asarray, before),
                            {k: jnp.asarray(v)
                             for k, v in _batches()[0].items()})
    gnorm = metrics["grad_norm"]
    rel = abs(float(eager_m["grad_norm"]) - gnorm) / gnorm
    assert 1e-5 < rel <= GNORM_RTOL
    got = [np.asarray(x) for x in jax.tree.leaves(eager.params)]
    want = jax.tree.leaves(after.params)
    off = sum(int((np.abs(a - b) > 1e-6).sum()) for a, b in zip(got, want))
    share = off / sum(a.size for a in want)
    assert share > 1e-3
    assert max(np.abs(a - b).max() for a, b in zip(got, want)) <= 2 * LR


# ---------------------------------------------------------------- checkpoints

def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A reference state after two steps, saved by ``repro.ckpt.save``:
    the port restores it bitwise, and one more step on each side agrees
    within the step limits."""
    (_, _, s2), (_, m3, s3) = _ref_run(1, False)[1:]
    ref_save(jax.tree.map(jnp.asarray, s2), 2, tmp_path)
    restored = ckpt.restore(tmp_path, 2, train_state_template(_cfgs()[1]),
                            device="cpu")
    state = train_state_from_jax(restored, _cfgs()[1])
    assert state.step == 2
    for name in ("params", "m", "v"):
        got = jax.tree.leaves(params_to_jax(getattr(state, name),
                                            _cfgs()[1]))
        for a, b in zip(got, jax.tree.leaves(getattr(s2, name))):
            assert np.array_equal(a, b)
    got, got_m = _port_step(1, False)(state, _batches()[2])
    assert abs(float(got_m["loss"]) - m3["loss"]) <= LOSS_RTOL * m3["loss"]
    assert_params_within_two_lr(got, s3)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """A port state after two steps, saved by the port in the reference's
    layout: ``repro.ckpt.restore`` (no mesh) reads it bitwise, and one
    more step on each side agrees within the step limits."""
    rc, pc = _cfgs()
    step = _port_step(1, False)
    state = _port_state(_ref_init())
    for b in _batches()[:2]:
        state, _ = step(state, b)
    saved = train_state_to_jax(state, pc)
    ckpt.save(saved, 2, tmp_path)
    abstract = jax.eval_shape(lambda k: ref_adamw.adamw_init(
        ref_init_params(k, rc)), jax.random.PRNGKey(0))
    ref_state = ref_restore(tmp_path, 2, abstract)
    assert int(ref_state.step) == 2
    for name in ("params", "m", "v"):
        for a, b in zip(jax.tree.leaves(getattr(ref_state, name)),
                        jax.tree.leaves(getattr(saved, name))):
            assert np.array_equal(np.asarray(a), b)
    ref_step = jax.jit(ref_make_train_step(
        rc, ref_adamw.cosine_schedule(LR, 0, 10)))
    batch = _batches()[2]
    want, want_m = ref_step(ref_state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    got, got_m = step(state, batch)
    loss = float(want_m["loss"])
    assert abs(float(got_m["loss"]) - loss) <= LOSS_RTOL * loss
    assert_params_within_two_lr(got, _host(want))


def test_stacked_layout_round_trips_bitwise():
    """``params_to_jax`` inverts ``params_from_jax``; the checkpoint keys
    of a training state are the reference's."""
    rc, pc = _cfgs()
    tree = _ref_init().params
    back = params_to_jax(params_from_jax(tree, pc), pc)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)
    keys = set(ckpt.flatten(train_state_to_jax(_port_state(_ref_init()),
                                               pc)))
    want = {jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(_ref_init())[0]}
    assert keys == want
    assert ".params['blocks'][0]['mixer']['wq']" in keys and ".step" in keys


def test_train_step_refuses_the_gradient_exchange():
    """Since the exchange was ported (``tests/test_torch_pod_train.py``),
    as in the reference: ``n_pods`` > 1 with no exchange is the plain
    step, bitwise; an exchange with ``n_pods`` == 1 (the rank route) is
    applied to the one gradient tree with the step's momentum, its
    metrics merged."""
    _, pc = _cfgs()
    lr = cosine_schedule(LR, 0, 10)
    before = _ref_run(1, False)[1][0]
    batch = _batches()[1]
    plain, plain_m = make_train_step(pc, lr)(_port_state(before), batch)
    pods, pods_m = make_train_step(pc, lr, n_pods=2)(_port_state(before),
                                                     batch)
    assert sorted(pods_m) == sorted(plain_m)
    assert float(pods_m["loss"]) == float(plain_m["loss"])
    for a, b in zip(tree_leaves(plain.params), tree_leaves(pods.params)):
        assert torch.equal(a, b)
    seen = []

    def double(grads, momentum):
        seen.append(momentum)
        return tree_map(lambda g: 2 * g, grads), {"doubled": len(seen)}
    state = _port_state(before)
    _, want_m, want = make_train_step(pc, lr).loss_and_grads(state, batch)
    step = make_train_step(pc, lr, grad_exchange=double)
    loss, metrics, grads = step.loss_and_grads(state, batch)
    assert len(seen) == 1 and seen[0] is state.m
    assert sorted(metrics) == sorted([*want_m, "doubled"])
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        assert torch.equal(a, 2 * b)
    _, m = step.apply(state, grads, loss, metrics)
    assert m["doubled"] == 1 and float(m["loss"]) == float(plain_m["loss"])
    assert float(m["grad_norm"]) == 2 * float(plain_m["grad_norm"])


def test_prefill_and_decode_step_factories():
    """``make_prefill`` and ``make_decode_step`` run the serving model's
    prefill and decode step; decode inputs other than tokens (the
    encoder's frames) go to the decode step as its ``batch_extras``, as
    in the reference: on whisper smoke the factories' steps equal the
    model's, and a step whose cache has no ``enc_out`` encodes the
    extras' frames."""
    from repro_torch.launch import make_decode_step, make_prefill
    from repro_torch.models import Transformer
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              dtype="float32")
    model = Transformer(cfg, device="cpu", seed=3)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 9))
    prefill, decode = make_prefill(cfg, 32), make_decode_step(cfg)
    got, cache = prefill(model, {"tokens": toks[:, :8]})
    want, want_cache = model.prefill({"tokens": toks[:, :8]}, 32)
    assert torch.equal(got, want)
    got, cache = decode(model, cache, {"tokens": toks[:, 8:]})
    want, _ = model.decode_step(want_cache, toks[:, 8:])
    assert torch.equal(got, want) and cache["len"] == 9
    wcfg = dataclasses.replace(get_config("whisper-large-v3", smoke=True),
                               dtype="float32")
    model = Transformer(wcfg, device="cpu", seed=3)
    frames = np.random.default_rng(5).normal(
        size=(2, wcfg.encoder.seq_len, wcfg.d_model))
    prefill, decode = make_prefill(wcfg, 32), make_decode_step(wcfg)
    prompt = {"tokens": toks[:, :8] % wcfg.vocab, "encoder_embeds": frames}
    got, cache = prefill(model, prompt)
    want, want_cache = model.prefill(prompt, 32)
    assert torch.equal(got, want)
    step = {"tokens": toks[:, 8:] % wcfg.vocab, "encoder_embeds": frames}
    del cache["enc_out"]
    got, cache = decode(model, cache, step)
    want, _ = model.decode_step(want_cache, step["tokens"])
    assert torch.equal(got, want) and cache["len"] == 9
