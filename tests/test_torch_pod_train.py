"""The port's exchanged train step against the reference's jitted
``make_train_step(..., grad_exchange=make_stacked_exchange(plan),
n_pods=2)`` with no mesh, and the driver's ``--pods`` / ``--edge-exchange``
run, on the CPU.

starcoder2 (dense) and deepseek-moe (MoE) smoke in f32, the reference's
``init_params(PRNGKey(0))`` carried across, batches of 4 x 24 tokens (two
pods of 2 x 24) from a numpy seed with some labels -1.  The reference
takes two steps: the first from full sync, the second with a plan that
skips every other stream (so the skipped streams take the non-zero
momentum of step 1); the port takes each from the reference's state
before it, on the same batch.  Settings: microbatches 1 and 2, and
(starcoder2) ``cast_params_bf16``, whose pods' bf16 gradients are
averaged in f32 and rounded once, as the reference's compiled mean is.

Held, with ``tests/test_torch_train_step.py``'s limits: the loss within
1e-5 relative, the grad norm within 1e-3 relative, every parameter
within 2 * lr of the reference's; each synced stream's exchanged
gradient (the reference's recovered from its first moment) within 1e-3
of the leaf's largest |grad| (one bf16 step more where the cast rounds
it); each skipped stream's exactly the step's momentum (in the
gradient's type).  The telemetry, per-stream squared norms of those
gradients, within 2e-3 relative, twice the grad norm's limit (a squared
norm's relative error is twice the norm's).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import init_params as ref_init_params
from repro.optim import adamw as ref_adamw
from repro.optim import edge_exchange as ref_ex
from repro_torch.configs import get_config
from repro_torch.launch import make_train_step
from repro_torch.launch.train import main
from repro_torch.models import params_to_jax, train_state_from_jax
from repro_torch.optim import cosine_schedule, tree_leaves
from repro_torch.optim import edge_exchange as ex

B, S, LR = 4, 24, 1e-3
N_PODS = 2
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-3
GRAD_LIMIT = 1e-3
TEL_RTOL = 2 * GNORM_RTOL
BF16_STEP = 2.0 ** -7
CASES = [("starcoder2-3b", 1, False), ("starcoder2-3b", 2, False),
         ("starcoder2-3b", 1, True), ("deepseek-moe-16b", 1, False),
         ("deepseek-moe-16b", 2, False)]
IDS = ["starcoder2-mb1", "starcoder2-mb2", "starcoder2-mb1-bf16",
       "deepseek-moe-mb1", "deepseek-moe-mb2"]


def _cfgs(arch):
    return (dataclasses.replace(ref_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(vocab):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(2):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        b["labels"][0, :3] = -1
        b["labels"][3, -2:] = -1
        out.append(b)
    return out


def _plans(keys):
    return [{k: True for k in keys},
            {k: i % 2 == 0 for i, k in enumerate(keys)}]


@functools.cache
def _ref_run(arch, microbatches, cast):
    """The reference's two exchanged steps: [(plan, state before,
    metrics, state after)] (numpy)."""
    rc, _ = _cfgs(arch)
    state = _host(ref_adamw.adamw_init(ref_init_params(jax.random.PRNGKey(0),
                                                       rc)))
    keys = list(ref_ex.full_sync_plan(state.params).sync)
    out = []
    for plan, b in zip(_plans(keys), _batches(rc.vocab)):
        step = jax.jit(ref_make_train_step(
            rc, ref_adamw.cosine_schedule(LR, 0, 10),
            microbatches=microbatches, cast_params_bf16=cast,
            grad_exchange=ref_ex.make_stacked_exchange(
                ref_ex.ExchangePlan(sync=plan)), n_pods=N_PODS))
        new, metrics = step(jax.tree.map(jnp.asarray, state),
                            {k: jnp.asarray(v) for k, v in b.items()})
        new = _host(new)
        out.append((plan, state, _host(metrics), new))
        state = new
    return out


def _paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("arch,microbatches,cast", CASES, ids=IDS)
def test_exchanged_step_matches_the_reference(arch, microbatches, cast):
    _, pc = _cfgs(arch)
    batches = _batches(pc.vocab)
    for i, (plan, before, metrics, after) in enumerate(
            _ref_run(arch, microbatches, cast)):
        step = make_train_step(
            pc, cosine_schedule(LR, 0, 10), microbatches=microbatches,
            cast_params_bf16=cast, grad_exchange=ex.make_stacked_exchange(
                ex.ExchangePlan(sync=plan), cfg=pc), n_pods=N_PODS)
        state = train_state_from_jax(before, pc)
        momentum = [t.clone() for t in tree_leaves(state.m)]
        loss, got_m, grads = step.loss_and_grads(state, batches[i])
        assert sorted(got_m) == ["pod_disagreement", "pod_magnitude"]
        assert _rel(loss, metrics["loss"]) <= LOSS_RTOL, i
        for k in got_m:
            np.testing.assert_allclose(got_m[k].numpy(), metrics[k],
                                       rtol=TEL_RTOL, atol=0,
                                       err_msg=f"step {i + 1} {k}")
        # each stream's exchanged gradient
        gnorm = float(metrics["grad_norm"])
        clip = min(1.0, 1.0 / max(gnorm, 1e-9))
        want_g = jax.tree.map(
            lambda m1, m0: (m1 - np.float32(0.9) * m0) / np.float32(0.1)
            / np.float32(clip), after.m, before.m)
        streams = ex.stream_leaves(grads, pc)
        leaves = tree_leaves(grads)
        for (path, w) in _paths(want_g):
            idx = streams[path]
            if not plan[path]:
                for j in idx:
                    assert torch.equal(leaves[j],
                                       momentum[j].to(leaves[j].dtype)), path
                continue
            got = np.stack([leaves[j].float().numpy() for j in idx]) \
                if "['blocks']" in path else \
                leaves[idx[0]].float().numpy()
            limit = GRAD_LIMIT + (BF16_STEP if cast and w.ndim >= 2 else 0)
            err = np.abs(got - w).max()
            assert err <= limit * np.abs(w).max(), (i, path, err)
        new, new_m = step.apply(state, grads, loss, got_m)
        assert _rel(new_m["grad_norm"], gnorm) <= GNORM_RTOL, i
        assert new.step == int(after.step) == i + 1
        got_p = jax.tree.leaves(params_to_jax(new.params, pc))
        for (path, w), g in zip(_paths(after.params), got_p):
            assert np.isfinite(g).all(), path
            assert np.abs(g - w).max() <= 2 * LR, (i, path)


def test_the_whole_step_is_its_parts():
    """``train_step(state, batch)`` is ``local_grads``, ``exchange`` and
    ``apply`` in turn: the pods' gradients a list of trees, the metrics
    the exchange's and the optimizer's."""
    _, pc = _cfgs("starcoder2-3b")
    (plan, before, _, _), = _ref_run("starcoder2-3b", 1, False)[1:]
    batch = _batches(pc.vocab)[1]
    step = make_train_step(pc, cosine_schedule(LR, 0, 10),
                           grad_exchange=ex.make_stacked_exchange(
                               ex.ExchangePlan(sync=plan), cfg=pc),
                           n_pods=N_PODS)
    whole, whole_m = step(train_state_from_jax(before, pc), batch)
    state = train_state_from_jax(before, pc)
    loss, metrics, grads_p = step.local_grads(state, batch)
    assert metrics == {} and len(grads_p) == N_PODS
    grads, ex_m = step.exchange(grads_p, state.m)
    parts, parts_m = step.apply(state, grads, loss, {**metrics, **ex_m})
    assert sorted(whole_m) == sorted(parts_m) == [
        "grad_norm", "loss", "lr", "pod_disagreement", "pod_magnitude"]
    for a, b in zip(tree_leaves(whole.params), tree_leaves(parts.params)):
        assert torch.equal(a, b)


def test_driver_pods_and_edge_exchange(capsys):
    """The reference test's exchange flags at smoke size: two replans in
    nine steps, finite losses, the exchange timed apart, the sync
    fraction after each window."""
    stats = {}
    losses = main(["--arch", "starcoder2-3b", "--steps", "9", "--batch", "8",
                   "--seq", "32", "--lr", "8e-3", "--pods", "2",
                   "--edge-exchange", "--dcn-budget", "0.4",
                   "--exchange-window", "3", "--log-every", "3",
                   "--device", "cpu"], stats=stats)
    out = capsys.readouterr().out
    assert "replanned: sync fraction=" in out
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert len(stats["sync_fraction"]) == 3
    assert all(0 < f < 1 for f in stats["sync_fraction"])
    assert stats["replanned_at"] and stats["replanned_at"][0] == 3
    assert len(stats["exchange_ms"]) == 9 and stats["median_exchange_ms"] > 0
