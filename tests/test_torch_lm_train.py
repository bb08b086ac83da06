"""The port's training pieces against the reference's, on the CPU:
``forward_train`` and its gradients, attention's route under autograd,
AdamW, the cosine schedule, and the Markov token batches.

The weights are the reference's ``init_params(PRNGKey(0))`` carried
across by ``params_from_jax``; the tokens and labels come from a numpy
seed, with some labels -1 (masked).  The reference runs jitted, with no
mesh.

Tolerances.  f32 (``dataclasses.replace(cfg, dtype="float32")``): the
loss within 1e-5 relative, and every gradient leaf within 1e-3 of that
leaf's largest |grad| in the reference, compared in the reference's
stacked layout (``params_to_jax``).  The reference's own jitted gradients
differ from its op-by-op ones by up to ~1e-4 of a leaf's max on these
models (random attention weights magnify last-place differences), so the
limit is about 10x the reference's own spread.  bf16: the loss only, to
3e-2 of the reference's (the class the serving model's bf16 tests hold
logits to); bf16 gradients are no parity target.  AdamW on the
reference's own gradients: the grad norm within rtol 1e-6, and params,
m and v within rtol 1e-6 above a floor of 1e-6 of the leaf's largest
magnitude (the moment sums cancel where b1 * m is near the new term, and
the last subtraction where a parameter is near its step: there the other
order's last-place differences are large relative ones).
"""
import ast
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data import lm_data as ref_lm_data
from repro.models import init_params as ref_init_params
from repro.models import transformer as RT
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.data.lm_data import LMBatcher, MarkovTokenStream
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import (forward_train, params_from_jax,
                                params_to_jax)
from repro_torch.models import layers as L
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               global_norm, tree_leaves, tree_unflatten)

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DENSE = ["gemma3-12b", "yi-9b", "starcoder2-3b", "chatglm3-6b"]
B, S = 2, 24            # S > gemma3 smoke's window of 16
LOSS_RTOL = 1e-5
GRAD_LIMIT = 1e-3       # of each leaf's max |grad|
BF16_LOSS = 3e-2


def _cfgs(arch, dtype):
    return (dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


@functools.cache
def _ref_params(arch, dtype):
    rc, _ = _cfgs(arch, dtype)
    return jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0),
                                                    rc))


def _batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1
    return {"tokens": tokens, "labels": labels}


@functools.cache
def _ref_value_and_grad(arch, dtype):
    rc, _ = _cfgs(arch, dtype)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: RT.forward_train(p, b, rc)[0]))
    loss, grads = fn(_ref_params(arch, dtype),
                     {k: jnp.asarray(v) for k, v in _batch(rc.vocab).items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_value_and_grad(arch, dtype, remat=True):
    rc, pc = _cfgs(arch, dtype)
    params = params_from_jax(_ref_params(arch, dtype), pc)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = forward_train(params, _batch(rc.vocab), pc, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, tree_unflatten(params, grads)


def assert_leaves_within_grad_limit(got: dict, want: dict, limit=GRAD_LIMIT):
    """Every leaf of ``got`` (a reference-layout numpy tree) within
    ``limit`` of the reference leaf's largest magnitude."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(paths)
    for (path, w), g in zip(paths, got_leaves):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        err = np.abs(g - w).max()
        assert err <= limit * np.abs(w).max(), (jax.tree_util.keystr(path),
                                                err, np.abs(w).max())


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_f32_loss_and_gradients_match_the_reference(arch):
    want_loss, want_grads = _ref_value_and_grad(arch, "float32")
    loss, metrics, grads = _port_value_and_grad(arch, "float32")
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    # 48 tokens, 8 of them masked
    assert float(metrics["ntokens"]) == 2 * S - 8
    _, pc = _cfgs(arch, "float32")
    assert_leaves_within_grad_limit(params_to_jax(grads, pc), want_grads)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_bf16_loss_matches_the_reference(arch):
    want_loss, _ = _ref_value_and_grad(arch, "bfloat16")
    loss, _, grads = _port_value_and_grad(arch, "bfloat16")
    assert loss.dtype == torch.float32
    assert abs(float(loss) - want_loss) <= BF16_LOSS * abs(want_loss)
    # the masters are f32 and so are their gradients
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in tree_leaves(grads))


@pytest.mark.parametrize("arch", DENSE)
def test_recomputation_gives_the_same_gradients_bitwise(arch):
    loss_r, _, g_r = _port_value_and_grad(arch, "float32", remat=True)
    loss_n, _, g_n = _port_value_and_grad(arch, "float32", remat=False)
    assert torch.equal(loss_r, loss_n)
    for a, b in zip(tree_leaves(g_r), tree_leaves(g_n)):
        assert torch.equal(a, b)


def test_forward_train_loss_is_the_masked_mean_cross_entropy():
    """The loss against ``torch.nn.functional.cross_entropy`` on the
    port's own logits, with -1 labels ignored; all-masked labels give 0
    over ntokens = 1, as the reference clamps it."""
    from repro_torch.models.transformer import Transformer
    _, pc = _cfgs("yi-9b", "float32")
    params = params_from_jax(_ref_params("yi-9b", "float32"), pc)
    batch = _batch(pc.vocab)
    loss, _ = forward_train(params, batch, pc)
    logits = Transformer(pc, params, device="cpu")(batch)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, pc.vocab),
        torch.as_tensor(batch["labels"]).long().reshape(-1), ignore_index=-1)
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    masked = dict(batch, labels=np.full_like(batch["labels"], -1))
    loss0, metrics = forward_train(params, masked, pc)
    assert float(loss0) == 0.0 and float(metrics["ntokens"]) == 1.0


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("on_gpu", [True, False])
@pytest.mark.parametrize("index_positions", [True, False])
@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("differentiated", [True, False])
def test_attention_route(use_kernel, on_gpu, index_positions, decode,
                         differentiated):
    """Only a prompt's attention (self- or cross-attention) on the GPU,
    allowed by the caller, at the positions 0..s-1 the kernels mask by,
    and not recorded by autograd, goes to the flash kernels."""
    want = (use_kernel and on_gpu and index_positions and not decode
            and not differentiated)
    assert L.kernel_route(use_kernel=use_kernel, on_gpu=on_gpu,
                          index_positions=index_positions, decode=decode,
                          differentiated=differentiated) is want


def test_a_training_forward_is_differentiated():
    """``is_differentiated`` reads grad mode and ``requires_grad``: the
    masters of a training state make the forward differentiated, the
    serving model's frozen weights and ``torch.no_grad()`` do not."""
    w = torch.ones(3, requires_grad=True)
    q = torch.ones(3) * w
    assert L.is_differentiated(torch.ones(3), q)
    with torch.no_grad():
        assert not L.is_differentiated(torch.ones(3) * w)
    assert not L.is_differentiated(torch.ones(3), torch.zeros(3))


def test_flash_kernel_refuses_a_differentiated_call():
    """The kernels write their output outside autograd: their entry point
    raises before anything else where autograd would record the call."""
    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention_cuda(q, k, k)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        fa_ops.flash_attention_cuda(q, k, k)


# ---------------------------------------------------------------- AdamW

def _state_pair(seed):
    """The reference's and the port's AdamW state over starcoder2 smoke's
    f32 parameters, and two gradient trees: the reference's own gradient
    and a second one drawn from a numpy seed at ten times its scale."""
    rc, pc = _cfgs("starcoder2-3b", "float32")
    tree = _ref_params("starcoder2-3b", "float32")
    _, g1 = _ref_value_and_grad("starcoder2-3b", "float32")
    rng = np.random.default_rng(seed)
    g2 = jax.tree.map(lambda g: (10 * np.abs(g).max() * rng.standard_normal(
        g.shape)).astype(np.float32), g1)
    ref = ref_adamw.adamw_init(jax.tree.map(jnp.asarray, tree))
    port = adamw_init(params_from_jax(tree, pc))
    return pc, ref, port, [g1, g2]


@pytest.mark.parametrize("clip_norm", [1.0, 1e6], ids=["clipped", "unclipped"])
def test_adamw_update_matches_the_reference(clip_norm):
    pc, ref, port, grads = _state_pair(seed=7)
    for i, g in enumerate(grads):
        ref, rm = jax.jit(functools.partial(
            ref_adamw.adamw_update, clip_norm=clip_norm))(
            ref, jax.tree.map(jnp.asarray, g), 3e-3)
        port, pm = adamw_update(port, params_from_jax(g, pc), 3e-3,
                                clip_norm=clip_norm)
        gnorm = float(rm["grad_norm"])
        assert abs(float(pm["grad_norm"]) - gnorm) <= 1e-6 * gnorm
        # clipping engages in the clipped case only
        assert (gnorm > clip_norm) is (clip_norm == 1.0)
        assert port.step == int(ref.step) == i + 1
        for name in ("params", "m", "v"):
            got = jax.tree.leaves(params_to_jax(getattr(port, name), pc))
            want = jax.tree.leaves(getattr(ref, name))
            for a, b in zip(got, want):
                b = np.asarray(b)
                np.testing.assert_allclose(a, b, rtol=1e-6,
                                           atol=1e-6 * np.abs(b).max())


def test_global_norm_and_cosine_schedule_match_the_reference():
    _, g = _ref_value_and_grad("starcoder2-3b", "float32")
    _, pc = _cfgs("starcoder2-3b", "float32")
    want = float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(global_norm(params_from_jax(g, pc)))
    assert abs(got - want) <= 1e-6 * want
    for peak, warmup, total in ((3e-3, 20, 100), (8e-3, 20, 150),
                                (1e-3, 0, 10)):
        ref_lr = jax.jit(ref_adamw.cosine_schedule(peak, warmup, total))
        lr = cosine_schedule(peak, warmup, total)
        for step in (0, 1, 10, warmup, warmup + 1, total // 2, total,
                     total + 5):
            want = float(ref_lr(jnp.asarray(step, jnp.int32)))
            assert abs(lr(step) - want) <= 1e-6 * abs(want), (step, want)


def test_global_norm_stays_finite_where_the_references_f32_sum_overflows():
    """Gradients of 2.9e19 (starcoder2-3b FULL's embedding at init): the
    reference's f32 sum of squares overflows to inf, which zeroes the clip
    factor; the port's f64 sum gives the norm, rounded to f32."""
    g = {"a": np.full(4, 3e19, np.float32), "b": np.full(9, -4e19, np.float32)}
    assert np.isinf(float(ref_adamw.global_norm(jax.tree.map(jnp.asarray,
                                                             g))))
    got = float(global_norm({k: torch.from_numpy(v) for k, v in g.items()}))
    want = float(np.float32(np.sqrt(4 * 9e38 + 9 * 16e38)))
    assert got == want
    state = adamw_init({"w": torch.zeros(2)})
    new, m = adamw_update(state, {"w": torch.tensor([3e19, -4e19])}, lr=0.1,
                          weight_decay=0.0)
    assert float(m["grad_norm"]) == float(np.float32(5e19))
    np.testing.assert_allclose(new.params["w"].detach().numpy(), [-0.1, 0.1],
                               rtol=1e-6)


# the reference's four properties (tests/test_optim.py), on the port

def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        loss = torch.sum((state.params["w"] - target) ** 2)
        g = torch.autograd.grad(loss, [state.params["w"]])[0]
        state, _ = adamw_update(state, {"w": g}, lr=0.05, weight_decay=0.0)
    np.testing.assert_allclose(state.params["w"].detach().numpy(),
                               target.numpy(), atol=0.05)


def test_clipping_bounds_update():
    state = adamw_init({"w": torch.zeros(3)})
    g = {"w": torch.tensor([1e6, 1e6, 1e6])}
    new, m = adamw_update(state, g, lr=1.0, clip_norm=1.0, weight_decay=0.0)
    assert float(m["grad_norm"]) > 1e5
    assert float(new.params["w"].abs().max()) < 2.0


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    assert lr(0) == 0.0
    assert abs(lr(10) - 1e-3) < 1e-9
    assert lr(100) < 2e-4


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 8, 48, 0),
                                                  (49152, 4, 64, 3)])
def test_lm_batches_are_the_references_bitwise(vocab, batch, seq, seed):
    """The port's batches are the reference's draws in order: against the
    reference's chain and generator stepped by hand, and against the
    first two batches of the reference's own batcher (its prefetch holds
    two before any can be dropped)."""
    ref_stream = ref_lm_data.MarkovTokenStream(vocab, seed)
    stream = MarkovTokenStream(vocab, seed)
    assert np.array_equal(stream.succ, ref_stream.succ)
    assert np.array_equal(stream.probs, ref_stream.probs)
    rng = np.random.default_rng(seed + 1)
    port = LMBatcher(vocab, batch, seq, seed=seed)
    ref = ref_lm_data.LMBatcher(vocab, batch, seq, seed=seed)
    try:
        ref_first = [next(iter(ref)) for _ in range(2)]
        got = [next(iter(port)) for _ in range(5)]
    finally:
        port.close()
        ref.close()
    for i, b in enumerate(got):
        toks = ref_stream.sample(rng, batch, seq)
        assert b["tokens"].dtype == b["labels"].dtype == np.int32
        assert np.array_equal(b["tokens"], toks[:, :-1].astype(np.int32))
        assert np.array_equal(b["labels"], toks[:, 1:].astype(np.int32))
        if i < 2:
            for k in ("tokens", "labels"):
                assert np.array_equal(b[k], ref_first[i][k])


def test_lm_batcher_close_stops_its_thread():
    data = LMBatcher(64, 2, 8, seed=0)
    next(iter(data))
    data.close()
    assert not data._thread.is_alive()


def test_driver_default_argv_is_the_examples():
    """``python -m repro_torch.launch.train`` with no arguments runs
    ``examples/train_lm.py``'s default."""
    from repro_torch.launch.train import DEFAULT_ARGV
    tree = ast.parse((ROOT / "examples" / "train_lm.py").read_text())
    lists = [ast.literal_eval(n.value) for n in ast.walk(tree)
             if isinstance(n, ast.Assign) and isinstance(n.value, ast.List)
             and any(getattr(t, "id", None) == "argv" for t in n.targets)]
    assert lists == [DEFAULT_ARGV]
