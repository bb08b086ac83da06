"""The port's cross-pod gradient exchange against the reference's
``repro.optim.edge_exchange``, on the CPU.

* The stacked exchange: the same per-pod gradients and momentum (seeded
  numpy; f32 and bf16 gradients; a nested tree; sync and skip mixed; both
  imputations; telemetry on and off; P = 2 and 4) through the reference's
  jitted ``make_stacked_exchange`` (pods stacked on a leading axis) and
  the port's (a list of per-pod trees).  The exchanged gradients are
  bitwise the reference's at P = 2 and within f32 rtol 1e-6 at P = 4
  (both follow its compiled order: f32 sum in pod order times the f32
  1 / P, rounded to the gradients' type); the telemetry within rtol 1e-5
  (sums of squares in another order).
* The reference's own four cases (``tests/test_edge_exchange.py``).
* Stream keys: for every family of the zoo at smoke size, the port's
  streams over its per-layer tree equal the reference's
  ``full_sync_plan(init_params(...))`` keys and leaf sizes, in order;
  with two blocks of a period of 6 (gemma3) and with the encoder
  (whisper), the exchange over the port's tree is the reference's over
  its stacked tree.
* The controller: both fed the same telemetry windows give the same plan
  (every stream's decision).  The reference's IPM calls
  ``jax.experimental.enable_x64``, gone in jax 0.9: the ``x64`` fixture
  points the name at ``jax.enable_x64`` per test (ROADMAP queue 3,
  note a).
"""
import dataclasses

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init_params
from repro.optim import edge_exchange as ref_ex
from repro_torch.configs import get_config
from repro_torch.models import init_params, params_from_jax, params_to_jax
from repro_torch.optim import edge_exchange as ex

TEL_RTOL = 1e-5


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}, "e": (7, 6),
          "f": {"g": {"h": (4,)}}, "w": (9, 5)}


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _ref_leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _stacked_inputs(n_pods, seed, dtype):
    """(stacked per-pod gradients (P, ...) numpy, momentum numpy f32);
    the pods share a common part, as pods' gradients do."""
    rng = np.random.default_rng(seed)

    def grad(shape):
        common = rng.normal(0, 1, shape)
        return (common + 0.3 * rng.normal(0, 1, (n_pods, *shape))) \
            .astype(np.float32)
    g = _tree(grad)
    m = _tree(lambda s: (0.1 * rng.normal(0, 1, s)).astype(np.float32))
    if dtype == "bfloat16":     # values the bf16 type holds exactly
        g = jax.tree.map(lambda x: np.asarray(
            jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), g)
    return g, m


def _to_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _pod_trees(g_stacked, n_pods, dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return [jax.tree.map(lambda x: torch.from_numpy(x[p].copy()).to(tdt),
                         g_stacked) for p in range(n_pods)]


def _plan(keys, skip_every, measure, cls):
    return cls(sync={k: (i % skip_every != 1) if skip_every else True
                     for i, k in enumerate(keys)}, measure=measure)


def _run_both(g, m, n_pods, dtype, skip_every, imputation, measure):
    keys = [k for k, _ in _ref_leaves(m)]
    ref_fn = jax.jit(ref_ex.make_stacked_exchange(
        _plan(keys, skip_every, measure, ref_ex.ExchangePlan), imputation))
    want, want_m = ref_fn(_to_jax(g, dtype), _to_jax(m, "float32"))
    port_fn = ex.make_stacked_exchange(
        _plan(keys, skip_every, measure, ex.ExchangePlan), imputation)
    got, got_m = port_fn(_pod_trees(g, n_pods, dtype),
                         jax.tree.map(torch.from_numpy, m))
    return keys, (want, want_m), (got, got_m)


def _np(t):
    return t.detach().float().numpy()


CASES = [(2, "float32", 0, "momentum", True),
         (2, "float32", 2, "momentum", True),
         (2, "float32", 3, "zero", True),
         (2, "float32", 2, "momentum", False),
         (2, "bfloat16", 2, "momentum", True),
         (2, "bfloat16", 3, "zero", False),
         (4, "float32", 2, "momentum", True),
         (4, "float32", 3, "zero", False),
         (4, "bfloat16", 2, "momentum", True)]


@pytest.mark.parametrize("n_pods,dtype,skip_every,imputation,measure", CASES,
                         ids=[f"P{c[0]}-{c[1]}-skip{c[2]}-{c[3]}"
                              f"-{'measure' if c[4] else 'quiet'}"
                              for c in CASES])
def test_stacked_exchange_matches_the_reference(n_pods, dtype, skip_every,
                                                imputation, measure):
    g, m = _stacked_inputs(n_pods, 10 + n_pods + skip_every, dtype)
    keys, (want, want_m), (got, got_m) = _run_both(
        g, m, n_pods, dtype, skip_every, imputation, measure)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    plan = _plan(keys, skip_every, measure, ex.ExchangePlan)
    for (path, w), t, (_, mk) in zip(_ref_leaves(want),
                                     ex.tree_leaves(got), _ref_leaves(m)):
        assert t.dtype == tdt, path
        w = np.asarray(w, np.float32)
        if not plan.sync[path]:
            imputed = mk if imputation == "momentum" else np.zeros_like(mk)
            want_t = torch.from_numpy(imputed).to(tdt)
            assert torch.equal(t, want_t), path
        if n_pods == 2 or not plan.sync[path]:
            assert np.array_equal(_np(t), w), path
        else:
            np.testing.assert_allclose(_np(t), w, rtol=1e-6, atol=0,
                                       err_msg=path)
    assert sorted(got_m) == sorted(want_m)
    for name in want_m:
        assert got_m[name].dtype == torch.float32
        assert got_m[name].shape == (len(keys),)
        np.testing.assert_allclose(_np(got_m[name]),
                                   np.asarray(want_m[name]), rtol=TEL_RTOL,
                                   atol=0, err_msg=name)
        skipped = [i for i, k in enumerate(keys) if not plan.sync[k]]
        assert np.all(_np(got_m[name])[skipped] == 0.0)


def test_exchange_refuses_an_unknown_imputation():
    with pytest.raises(ValueError, match="imputation"):
        ex.make_stacked_exchange(ex.ExchangePlan(sync={}), "mean")


# ------------------------------------------- the reference's own four cases

def test_stacked_exchange_sync_and_skip():
    grads_p = [{"a": torch.tensor([1.0, 2.0]), "b": torch.tensor([10.0])},
               {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([20.0])}]
    momentum = {"a": torch.tensor([0.5, 0.5]), "b": torch.tensor([-1.0])}
    plan = ex.ExchangePlan(sync={"['a']": True, "['b']": False})
    out, metrics = ex.make_stacked_exchange(plan)(grads_p, momentum)
    np.testing.assert_allclose(out["a"], [2.0, 3.0])
    np.testing.assert_allclose(out["b"], [-1.0])
    assert metrics["pod_disagreement"].shape == (2,)
    assert float(metrics["pod_disagreement"][1]) == 0.0
    # the reference's numbers on the same case
    want, want_m = ref_ex.make_stacked_exchange(ref_ex.ExchangePlan(
        sync={"['a']": True, "['b']": False}))(
        {"a": jnp.asarray([[1.0, 2.0], [3.0, 4.0]]),
         "b": jnp.asarray([[10.0], [20.0]])},
        {"a": jnp.asarray([0.5, 0.5]), "b": jnp.asarray([-1.0])})
    for k in ("pod_disagreement", "pod_magnitude"):
        assert np.array_equal(metrics[k].numpy(), np.asarray(want_m[k]))


def test_full_sync_plan_covers_all():
    g = {"x": torch.zeros(3), "y": {"z": torch.zeros(2)}}
    plan = ex.full_sync_plan(g)
    assert len(plan.sync) == 2 and all(plan.sync.values())
    assert list(plan.sync) == list(ref_ex.full_sync_plan(
        {"x": jnp.zeros(3), "y": {"z": jnp.zeros(2)}}).sync)


def test_controller_respects_budget(x64):
    sizes = {f"t{i}": 1000 for i in range(6)}
    d = np.array([10.0, 9.0, 0.1, 0.1, 0.1, 0.1])
    m = np.array([10.0, 10.0, 10.0, 10.0, 10.0, 10.0])
    plans = []
    for mod in (ex, ref_ex):
        ctl = mod.EdgeGradController(sizes=sizes, dcn_budget_fraction=0.34,
                                     n_pods=2, window=5)
        ctl.observe({"pod_disagreement": d, "pod_magnitude": m})
        plans.append(ctl.replan(mod.ExchangePlan(
            sync={k: True for k in sizes})))
    synced = [k for k, v in plans[0].sync.items() if v]
    assert "t0" in synced and "t1" in synced
    assert len(synced) <= 3
    assert plans[0].sync == plans[1].sync and plans[0].window == 5


def test_controller_emergency_sync(x64):
    plans = []
    for mod in (ex, ref_ex):
        ctl = mod.EdgeGradController(sizes={"t0": 100},
                                     dcn_budget_fraction=0.0, n_pods=2)
        ctl.observe({"pod_disagreement": np.array([1.0]),
                     "pod_magnitude": np.array([1.0])})
        plans.append(ctl.replan(mod.ExchangePlan(sync={"t0": True})))
    assert any(plans[0].sync.values())
    assert plans[0].sync == plans[1].sync


# --------------------------------------------------------------- streams

def _ref_cfg(arch, **change):
    return dataclasses.replace(ref_config(arch, smoke=True), **change)


def _port_cfg(arch, **change):
    return dataclasses.replace(get_config(arch, smoke=True), **change)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stream_keys_and_sizes_are_the_references(arch):
    rc, pc = _ref_cfg(arch), _port_cfg(arch)
    abstract = jax.eval_shape(lambda k: ref_init_params(k, rc),
                              jax.random.PRNGKey(0))
    want = ref_ex.full_sync_plan(abstract)
    want_sizes = {p: int(np.prod(leaf.shape)) for p, leaf in zip(
        want.sync, jax.tree.leaves(abstract))}
    params = init_params(pc, None, device="meta")
    assert list(ex.full_sync_plan(params, pc).sync) == list(want.sync)
    sizes = ex.stream_sizes(params, pc)
    assert list(sizes) == list(want_sizes) and sizes == want_sizes
    # the stream of a block position holds its layers in block order
    leaves = ex.tree_leaves(params)
    streams = ex.stream_leaves(params, pc)
    key = "['blocks'][0]['norm1']['scale']"
    if key in streams:
        want_ids = [id(layer["norm1"]["scale"])
                    for layer in params["layers"][::pc.period]]
        assert [id(leaves[i]) for i in streams[key]] == want_ids


def test_stream_leaves_refuse_a_tree_of_another_depth():
    pc = _port_cfg("yi-9b")
    params = init_params(pc, None, device="meta")
    params["layers"] = params["layers"][:-1]
    with pytest.raises(ValueError, match="layers"):
        ex.stream_leaves(params, pc)


@pytest.mark.parametrize("arch,change", [
    ("gemma3-12b", {"n_layers": 12}),          # two blocks of period 6
    ("whisper-large-v3", {}),                  # the encoder's stack
    ("deepseek-moe-16b", {})],                 # the nested shared group
    ids=["gemma3-2blocks", "whisper", "deepseek-moe"])
def test_exchange_over_the_port_layout_is_the_references(arch, change):
    """Seeded gradients in the reference's stacked layout, the pods
    stacked in front: the reference's exchange over them, and the port's
    over the same values in its per-layer layout (``params_from_jax``),
    brought back by ``params_to_jax``: bitwise, telemetry within
    rtol 1e-5."""
    rc = _ref_cfg(arch, dtype="float32", **change)
    pc = _port_cfg(arch, dtype="float32", **change)
    abstract = jax.eval_shape(lambda k: ref_init_params(k, rc),
                              jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    n_pods = 2
    g = jax.tree.map(lambda a: rng.normal(0, 1, (n_pods, *a.shape))
                     .astype(np.float32), abstract)
    m = jax.tree.map(lambda a: rng.normal(0, 0.1, a.shape)
                     .astype(np.float32), abstract)
    keys = list(ref_ex.full_sync_plan(abstract).sync)
    plan = {k: i % 3 != 2 for i, k in enumerate(keys)}
    want, want_m = jax.jit(ref_ex.make_stacked_exchange(
        ref_ex.ExchangePlan(sync=plan)))(_to_jax(g, "float32"),
                                         _to_jax(m, "float32"))
    pods = [params_from_jax(jax.tree.map(lambda x: x[p], g), pc)
            for p in range(n_pods)]
    got, got_m = ex.make_stacked_exchange(ex.ExchangePlan(sync=plan),
                                          cfg=pc)(pods, params_from_jax(m, pc))
    for (path, w), t in zip(_ref_leaves(want),
                            jax.tree.leaves(params_to_jax(got, pc))):
        assert np.array_equal(t, np.asarray(w)), path
    for name in want_m:
        np.testing.assert_allclose(got_m[name].numpy(),
                                   np.asarray(want_m[name]), rtol=TEL_RTOL,
                                   err_msg=name)
    assert ex.synced_bytes(ex.ExchangePlan(sync=plan), pods[0], pc)[1] == \
        4 * sum(int(np.prod(a.shape)) for a in jax.tree.leaves(abstract))


# ------------------------------------------------------------- controller

def _windows(k, steps, seed, size=1.0):
    """``steps`` telemetry rows of k streams: a few streams on which the
    pods disagree strongly, most agreeing (f32, as the step reports), of
    magnitudes around ``size``."""
    rng = np.random.default_rng(seed)
    scale = np.where(rng.random(k) < 0.3, 1.0, 0.05)
    rows = []
    for _ in range(steps):
        mag = (rng.gamma(2.0, 1.0, k) + 0.5) * size
        dis = scale * mag * rng.uniform(0.2, 1.5, k)
        rows.append({"pod_disagreement": dis.astype(np.float32),
                     "pod_magnitude": mag.astype(np.float32)})
    return rows


# (k streams, budget, pods, windows of two steps); k = 12, 27 and 56 are
# starcoder2's, whisper's and gemma3's stream counts at smoke size.  The
# port's IPM emulates the reference's compiled f64 order on the host, ~25
# s a plan at k = 56 here, so the larger k take one window.
CONTROLLER = [(6, 0.34, 2, 2), (6, 1.0, 4, 2), (12, 0.0, 2, 1),
              (12, 0.5, 2, 2), (12, 0.34, 4, 1), (27, 0.5, 4, 1),
              (27, 1.0, 2, 1), (56, 0.5, 2, 1)]


@pytest.mark.parametrize("k,budget,n_pods,n_windows", CONTROLLER,
                         ids=[f"k{c[0]}-b{c[1]}-P{c[2]}" for c in CONTROLLER])
def test_controller_plans_are_the_references(x64, k, budget, n_pods,
                                             n_windows):
    rng = np.random.default_rng(k)
    sizes = {f"['s{i:02d}']": int(rng.integers(16, 50000))
             for i in range(k)}
    windows = _windows(k, 2 * n_windows, seed=k + n_pods)
    plans = []
    for mod in (ex, ref_ex):
        ctl = mod.EdgeGradController(sizes=sizes, dcn_budget_fraction=budget,
                                     n_pods=n_pods, window=2)
        plan = mod.ExchangePlan(sync={p: True for p in sizes})
        for i, w in enumerate(windows):
            ctl.observe(w)
            if i % 2 == 1:
                plan = ctl.replan(plan)
        plans.append(plan)
        assert ctl._count == 0 and ctl._disagreement is None
    assert plans[0].sync == plans[1].sync
    assert list(plans[0].sync) == list(sizes)
    assert any(plans[0].sync.values())


@pytest.mark.filterwarnings("ignore:overflow:RuntimeWarning",
                            "ignore:invalid value:RuntimeWarning")
def test_controller_plans_at_full_width_magnitudes(x64):
    """starcoder2-3b FULL's squared gradient norms at its initialization
    reach ~1e22 (its grad norms ~1e11 on the card), so both controllers'
    f32 fourth moments and variances of the variance overflow to inf:
    the plans still agree, stream for stream."""
    k = 12
    sizes = {f"['s{i:02d}']": 1000 * (i + 1) for i in range(k)}
    plans = []
    for mod in (ex, ref_ex):
        ctl = mod.EdgeGradController(sizes=sizes, dcn_budget_fraction=0.4)
        for w in _windows(k, 2, seed=3, size=1e21):
            ctl.observe(w)
        plans.append(ctl.replan(mod.ExchangePlan(
            sync={p: True for p in sizes})))
    assert plans[0].sync == plans[1].sync
    assert 0 < sum(plans[0].sync.values()) < k


def test_controller_reads_the_steps_tensors():
    """``observe`` takes the step's f32 tensors; with no telemetry (a plan
    that does not measure) it keeps nothing, and ``replan`` keeps the
    current plan."""
    ctl = ex.EdgeGradController(sizes={"a": 4, "b": 4})
    ctl.observe({})
    plan = ex.ExchangePlan(sync={"a": True, "b": False})
    assert ctl.replan(plan) is plan
    ctl.observe({"pod_disagreement": torch.tensor([1.0, 2.0]),
                 "pod_magnitude": torch.tensor([3.0, 4.0])})
    ctl.observe({"pod_disagreement": torch.tensor([1.0, 2.0]),
                 "pod_magnitude": torch.tensor([3.0, 4.0])})
    assert ctl._count == 2 and ctl._disagreement.dtype == np.float32
    assert np.array_equal(ctl._magnitude, [6.0, 8.0])
