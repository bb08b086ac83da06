"""The port's MoE layer, MoE decoders and their serving against the
reference's, on the CPU.

deepseek-moe and qwen3-moe smoke (8 experts, top 2; deepseek with a
shared expert).  The layer takes seeded numpy inputs and the reference's
``moe_init`` weights; the models take the reference's
``init_params(PRNGKey(0))``, carried across by ``params_from_jax``.  The
reference's ``moe_apply`` runs jitted with no mesh (one dispatch group).

What is held, and why:

* the routes bitwise: each token's top-k experts in order, the stable sort
  of the flat expert ids and each entry's rank clipped at the capacity
  (read out of the reference's jitted ``moe_apply`` as it runs), also
  where the probabilities tie exactly (a zero router) and where entries
  pass the capacity and are dropped;
* the layer's output and its aux losses within ``sweep/diff.py``'s
  ``f32`` class (rtol 3e-5, atol 1e-6) in f32, and the output bitwise in
  bf16 (the port rounds where the reference's compiled layer does); the
  aux losses, f32 in both, within ``f32``;
* the layer's f32 gradients against ``jax.grad``: each leaf within 1e-3
  of its largest |grad| (the train-step tests' limit);
* the models' prefill and decode logits as ``test_torch_lm_model.py``
  holds the dense ones (f32 rtol 1e-3, atol 1e-3; bf16 an RMS 3e-2 of
  the reference's), and every token of an f32 serve run equal to the
  reference engine's.
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
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import (MoEConfig, Transformer, init_params,
                                params_from_jax, params_to_jax)
from repro_torch.models import layers as PL
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.__main__ import PROMPTS

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

MOE = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
DTYPES = ["float32", "bfloat16"]
F32_RTOL, F32_ATOL = 3e-5, 1e-6           # sweep/diff.py's "f32" class
GRAD_LIMIT = 1e-3
MODEL_RTOL, MODEL_ATOL, MODEL_BF16_RMS = 1e-3, 1e-3, 3e-2
B, S = 2, 24


def _cfgs(arch, dtype="float32", **moe):
    rc = ref_config(arch, smoke=True)
    pc = get_config(arch, smoke=True)
    return (dataclasses.replace(rc, dtype=dtype,
                                moe=dataclasses.replace(rc.moe, **moe)),
            dataclasses.replace(pc, dtype=dtype,
                                moe=dataclasses.replace(pc.moe, **moe)))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@functools.cache
def _layer_weights(arch, seed=1):
    rc, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, RL.moe_init(jax.random.PRNGKey(seed),
                                                rc.d_model, rc.moe))


def _port_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _inputs(d, dtype, seed=0, shape=(B, S)):
    a = np.random.default_rng(seed).normal(size=(*shape, d)) \
        .astype(np.float32)
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(_np(j).copy()).to(getattr(torch, dtype))


def _ref_moe(tree, x, m, record=None):
    """The reference's jitted ``moe_apply``; with ``record`` (a dict) its
    routes as it computes them: ``topv``, ``topi``, ``sort_idx`` (the
    stable argsort) and ``seg`` (the searchsorted segment starts)."""
    fn = functools.partial(RL.moe_apply, m=m)
    if record is None:
        return jax.jit(fn)(tree, x)
    top_k, argsort, searchsorted = (jax.lax.top_k, jnp.argsort,
                                    jnp.searchsorted)

    def keep(name, v):
        jax.debug.callback(lambda a: record.__setitem__(name, np.asarray(a)),
                           v)

    def rec_top_k(a, k):
        v, i = top_k(a, k)
        keep("topv", v)
        keep("topi", i)
        return v, i

    def rec_argsort(a, **kw):
        i = argsort(a, **kw)
        keep("sort_idx", i)
        return i

    def rec_searchsorted(a, v, **kw):
        i = searchsorted(a, v, **kw)
        keep("seg", i)
        return i
    jax.lax.top_k, jnp.argsort, jnp.searchsorted = (rec_top_k, rec_argsort,
                                                    rec_searchsorted)
    try:
        out = jax.jit(lambda p, x: fn(p, x))(tree, x)
        jax.block_until_ready(out)
    finally:
        jax.lax.top_k, jnp.argsort, jnp.searchsorted = (top_k, argsort,
                                                        searchsorted)
    return out


def _port_routes(params, x, m):
    """The port's routes for x: (topv, topi, sort_idx, rank_c, cap)."""
    b, s, d = x.shape
    _, _, topv, topi = PL.moe_router(params["router"], x.reshape(b * s, d),
                                     m.top_k)
    cap = PL.moe_capacity(b * s, m)
    sort_idx, _, rank_c = PL.moe_dispatch(topi, cap)
    return topv, topi, sort_idx, rank_c, cap


def _assert_routes(got, record, tk):
    topv, topi, sort_idx, rank_c, cap = got
    np.testing.assert_array_equal(topi.numpy(), record["topi"].reshape(-1, tk))
    np.testing.assert_array_equal(sort_idx.numpy(),
                                  record["sort_idx"].reshape(-1))
    seg = record["seg"].reshape(-1)
    rank = np.arange(seg.size) - seg
    want_rank = np.where(rank < cap, rank, cap)
    np.testing.assert_array_equal(rank_c.numpy(), want_rank)
    np.testing.assert_allclose(topv.numpy(), record["topv"].reshape(-1, tk),
                               rtol=F32_RTOL, atol=F32_ATOL)
    return int((want_rank == cap).sum())


def _assert_layer_close(got, want, dtype):
    out, aux = got
    w_out, w_aux = want
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(w_out), rtol=F32_RTOL,
                                   atol=F32_ATOL)
    else:
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(out), _np(w_out))
    assert set(aux) == set(w_aux) == {"moe_lb", "moe_z"}
    for k in aux:
        assert aux[k].dtype == torch.float32
        np.testing.assert_allclose(float(aux[k]), float(w_aux[k]),
                                   rtol=F32_RTOL, atol=F32_ATOL)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_count_the_references_parameters(arch, smoke):
    rc, pc = ref_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert pc.moe == MoEConfig(**dataclasses.asdict(rc.moe))
    assert pc.param_count() == rc.param_count()
    assert pc.active_param_count() == rc.active_param_count()
    if smoke:
        tree = ref_init_params(jax.random.PRNGKey(0), rc)
        port = init_params(pc, torch.Generator().manual_seed(0))
        n_ref = sum(a.size for a in jax.tree.leaves(tree))
        n_port = sum(t.numel() for t in jax.tree.leaves(port))
        assert n_port == n_ref == pc.param_count() + pc.d_model


def test_moe_init_shapes_and_scales():
    """The reference's shapes and fan-ins: the router over d, the experts'
    ``wi``/``wg`` over d and ``wo`` over f (axis 1), the shared MLP of
    width ``n_shared * d_ff_shared``."""
    _, pc = _cfgs("deepseek-moe-16b")
    m = dataclasses.replace(pc.moe, n_shared=2)
    p = PL.moe_init(torch.Generator().manual_seed(0), 64, m)
    assert {n: tuple(t.shape) for n, t in p.items() if n != "shared"} == {
        "router": (64, 8), "wi": (8, 64, 32), "wg": (8, 64, 32),
        "wo": (8, 32, 64)}
    assert {n: tuple(t.shape) for n, t in p["shared"].items()} == {
        "wi": (64, 64), "wg": (64, 64), "wo": (64, 64)}
    for name, fan_in in (("router", 64), ("wi", 64), ("wo", 32)):
        t = p[name] * np.sqrt(fan_in)
        assert float(t.abs().max()) <= 2.0 + 1e-6
        assert 0.7 < float(t.std()) < 1.0
    assert "shared" not in PL.moe_init(torch.Generator().manual_seed(0), 64,
                                       _cfgs("qwen3-moe-30b-a3b")[1].moe)


# ---------------------------------------------------------------- the layer

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_routes_and_output_match_the_reference(arch, dtype):
    rc, pc = _cfgs(arch, dtype)
    tree = _layer_weights(arch)
    xj, xp = _inputs(rc.d_model, dtype)
    record = {}
    want = _ref_moe(tree, xj, rc.moe, record)
    params = _port_tree(tree)
    assert _assert_routes(_port_routes(params, xp, pc.moe), record,
                          pc.moe.top_k) == 0       # capacity factor 8
    _assert_layer_close(PL.moe_apply(params, xp, pc.moe), want, dtype)


@pytest.mark.parametrize("arch", MOE)
def test_exact_ties_take_the_lowest_experts_first(arch):
    """A zero router: every probability is 1/E exactly, so every token
    takes experts 0..k-1 in order, as ``lax.top_k`` orders ties; with 48
    tokens on two experts and capacity max(ceil(48 * 2 / 8 * 1.25), 4) = 15
    each, all but 15 entries of each are dropped."""
    rc, pc = _cfgs(arch, capacity_factor=1.25)
    tree = dict(_layer_weights(arch), router=np.zeros((rc.d_model, 8),
                                                      np.float32))
    xj, xp = _inputs(rc.d_model, "float32", seed=2)
    record = {}
    want = _ref_moe(tree, xj, rc.moe, record)
    params = _port_tree(tree)
    routes = _port_routes(params, xp, pc.moe)
    k = pc.moe.top_k
    assert routes[4] == 15
    np.testing.assert_array_equal(routes[1].numpy(),
                                  np.tile(np.arange(k), (B * S, 1)))
    assert _assert_routes(routes, record, k) == k * (B * S - 15)
    _assert_layer_close(PL.moe_apply(params, xp, pc.moe), want, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_capacity_drops_match_the_reference(arch, dtype):
    """A capacity factor of 0.5 (cap max(ceil(48 * 2 / 8 * 0.5), 4) = 6):
    the busiest experts drop entries; the dropped ones read zeros."""
    rc, pc = _cfgs(arch, dtype, capacity_factor=0.5)
    tree = _layer_weights(arch, seed=3)
    xj, xp = _inputs(rc.d_model, dtype, seed=4)
    record = {}
    want = _ref_moe(tree, xj, rc.moe, record)
    params = _port_tree(tree)
    routes = _port_routes(params, xp, pc.moe)
    assert routes[4] == 6
    assert _assert_routes(routes, record, pc.moe.top_k) > 0
    _assert_layer_close(PL.moe_apply(params, xp, pc.moe), want, dtype)


@pytest.mark.parametrize("arch", MOE)
def test_moe_gradients_match_jax_grad(arch):
    """f32: the gradients of sum(out * r) + moe_lb + moe_z with respect to
    every weight and to x, under capacity drops (factor 0.5)."""
    rc, pc = _cfgs(arch, capacity_factor=0.5)
    tree = _layer_weights(arch, seed=5)
    xj, xp = _inputs(rc.d_model, "float32", seed=6)
    r = np.random.default_rng(7).normal(size=(B, S, rc.d_model)) \
        .astype(np.float32)

    def ref_loss(p, x):
        out, aux = RL.moe_apply(p, x, rc.moe)
        return jnp.sum(out * r) + aux["moe_lb"] + aux["moe_z"]
    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(tree, xj)
    params = jax.tree.map(lambda t: t.requires_grad_(True), _port_tree(tree))
    xp.requires_grad_(True)
    out, aux = PL.moe_apply(params, xp, pc.moe)
    loss = (out * torch.from_numpy(r)).sum() + aux["moe_lb"] + aux["moe_z"]
    leaves = jax.tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves + [xp])
    wants = jax.tree.leaves(want_p) + [want_x]
    for g, w in zip(grads, wants):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_LIMIT * np.abs(w).max(), (err, np.abs(w).max())


# ---------------------------------------------------------------- the models

@functools.cache
def _ref_params(arch, dtype):
    rc, _ = _cfgs(arch, dtype)
    return jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0),
                                                    rc))


def _assert_model_close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL)
    else:
        rms = np.sqrt(np.mean(np.square(got - want)))
        assert rms <= MODEL_BF16_RMS * np.sqrt(np.mean(np.square(want)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_the_reference(arch, dtype):
    rc, pc = _cfgs(arch, dtype)
    tree = _ref_params(arch, dtype)
    model = Transformer(pc, params_from_jax(tree, pc), device="cpu")
    toks = np.random.default_rng(1).integers(0, rc.vocab, (B, 28)) \
        .astype(np.int32)
    want, cw = jax.jit(lambda p, b: RT.prefill(p, b, rc, 64))(
        tree, {"tokens": jnp.asarray(toks[:, :20])})
    got, cg = model.prefill({"tokens": toks[:, :20]}, 64)
    _assert_model_close(got, want, dtype)
    decode = jax.jit(lambda p, c, t: RT.decode_step(p, c, t, rc))
    for t in range(20, 28):
        want, cw = decode(tree, cw, jnp.asarray(toks[:, t:t + 1]))
        got, cg = model.decode_step(cg, toks[:, t:t + 1])
        _assert_model_close(got, want, dtype)
    assert cg["len"] == int(cw["len"]) == 28


@pytest.mark.parametrize("arch", MOE)
def test_f32_serve_tokens_equal_the_references(arch):
    """The example's six requests on four slots (left-padded prompts whose
    padding takes capacity like any token, in both engines)."""
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


def test_served_moe_keeps_the_router_in_f32():
    """A bf16 model holds its experts, shared experts and attention in
    bf16 and its router (read as the reference's f32 master) and norms in
    f32; its parameter tree round-trips through the reference's stacked
    layout, the nested ``shared`` group included."""
    rc, pc = _cfgs("deepseek-moe-16b", "bfloat16")
    tree = _ref_params("deepseek-moe-16b", "bfloat16")
    model = Transformer(pc, params_from_jax(tree, pc), device="cpu")
    p = model.layers[0].params
    assert p["moe"]["router"].dtype == torch.float32
    assert p["moe"]["wi"].dtype == p["moe"]["shared"]["wo"].dtype \
        == p["mixer"]["wq"].dtype == torch.bfloat16
    assert p["norm2"]["scale"].dtype == torch.float32
    assert model.n_params() == pc.param_count() + pc.d_model
    drawn = init_params(pc, torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16)
    assert drawn["layers"][1]["moe"]["router"].dtype == torch.float32
    assert drawn["layers"][1]["moe"]["shared"]["wg"].dtype == torch.bfloat16
    back = params_to_jax(params_from_jax(tree, pc), pc)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


def test_jamba_still_raises_naming_the_mamba_item():
    """jamba smoke in the hybrid (its name is from before ROADMAP item 4d,
    when jamba raised naming it): a 20-token f32 prefill routes each token
    as the reference's prefill does in all four MoE layers (every other
    layer, after Mamba and attention mixers): the top-k experts in order,
    the stable sort of the flat expert ids and the clipped ranks bitwise,
    read out of the reference's jitted prefill as it runs; the logits
    within the model tolerance."""
    rc = dataclasses.replace(ref_config("jamba-1-5-large-398b", smoke=True),
                             dtype="float32")
    pc = dataclasses.replace(get_config("jamba-1-5-large-398b", smoke=True),
                             dtype="float32")
    tree = jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0),
                                                    rc))
    toks = np.random.default_rng(8).integers(0, rc.vocab, (B, 20)) \
        .astype(np.int32)
    record = {"topi": [], "sort_idx": [], "seg": []}
    top_k, argsort, searchsorted = (jax.lax.top_k, jnp.argsort,
                                    jnp.searchsorted)

    def keep(name, v):
        jax.debug.callback(lambda a: record[name].append(np.asarray(a)), v,
                           ordered=True)

    def rec_top_k(a, k):
        v, i = top_k(a, k)
        keep("topi", i)
        return v, i

    def rec_argsort(a, **kw):
        i = argsort(a, **kw)
        keep("sort_idx", i)
        return i

    def rec_searchsorted(a, v, **kw):
        i = searchsorted(a, v, **kw)
        keep("seg", i)
        return i
    jax.lax.top_k, jnp.argsort, jnp.searchsorted = (rec_top_k, rec_argsort,
                                                    rec_searchsorted)
    try:
        want, _ = jax.jit(lambda p, b: RT.prefill(p, b, rc, 32))(
            tree, {"tokens": jnp.asarray(toks)})
        jax.effects_barrier()
    finally:
        jax.lax.top_k, jnp.argsort, jnp.searchsorted = (top_k, argsort,
                                                        searchsorted)
    got_routes = []
    dispatch = PL.moe_dispatch

    def spy(topi, cap):
        out = dispatch(topi, cap)
        got_routes.append((topi, *out, cap))
        return out
    PL.moe_dispatch = spy
    try:
        model = Transformer(pc, params_from_jax(tree, pc), device="cpu")
        got, _ = model.prefill({"tokens": toks}, 32)
    finally:
        PL.moe_dispatch = dispatch
    assert len(got_routes) == len(record["topi"]) == 4
    k = pc.moe.top_k
    for (topi, sort_idx, _, rank_c, cap), w_topi, w_sort, w_seg in zip(
            got_routes, record["topi"], record["sort_idx"], record["seg"]):
        np.testing.assert_array_equal(topi.numpy(), w_topi.reshape(-1, k))
        np.testing.assert_array_equal(sort_idx.numpy(), w_sort.reshape(-1))
        seg = w_seg.reshape(-1)
        rank = np.arange(seg.size) - seg
        np.testing.assert_array_equal(rank_c.numpy(),
                                      np.where(rank < cap, rank, cap))
    _assert_model_close(got, want, "float32")
