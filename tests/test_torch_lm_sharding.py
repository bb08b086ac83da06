"""LM sharding's pure parts against the reference, with no ranks: the
partition rules on every smoke family's parameters, the mesh's layout of
ranks, and the cuts of a batch and of a leaf.

The reference's ``param_partition_spec`` and ``tree_pspecs`` take any
object with ``axis_names`` and ``shape``, so the port's
:class:`~repro_torch.launch.mesh.LMMesh` (built here without process
groups) is given to both.  Every leaf's spec is held equal: on the
port's per-layer tree (layer ``i`` is block ``i // period`` of position
``i % period``, its spec the reference leaf's without the block axis)
and on the reference's stacked layout.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init_params
from repro.parallel import sharding as RS
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import (LMMesh, _slices, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import init_params, train_state_template
from repro_torch.models.transformer import refuse_model_split
from repro_torch.parallel import sharding as PS

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ARCHS = [a.replace("_", "-") for a in ARCH_IDS]
MESHES = {"data2-model2": (("data", "model"), (2, 2)),
          "pod2-data2-model2": (("pod", "data", "model"), (2, 2, 2))}


def _mesh(name, rank=0) -> LMMesh:
    axes, sizes = MESHES[name]
    return LMMesh(axes, sizes, rank)


def _ref_specs(arch, mesh) -> dict:
    shapes = jax.eval_shape(lambda k: ref_init_params(k, ref_config(
        arch, smoke=True)), jax.random.PRNGKey(0))
    specs = RS.tree_pspecs(shapes, mesh)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _reference_path(path: str, cfg) -> str:
    """The reference leaf of a port leaf's path."""
    for prefix, stacked, period in (("['encoder']['layers']",
                                     "['encoder']['blocks']", None),
                                    ("['layers']", "['blocks']",
                                     cfg.period)):
        if path.startswith(prefix):
            rest = path[len(prefix) + 1:]
            i, tail = rest.split("]", 1)
            block = "" if period is None else f"[{int(i) % period}]"
            return stacked + block + tail
    return path


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_are_the_references(arch, mesh_name):
    mesh = _mesh(mesh_name)
    want = _ref_specs(arch, mesh)
    cfg = get_config(arch, smoke=True)
    # the port's per-layer tree: each leaf's spec is its reference leaf's
    # without the block axis
    got = PS.flat_pspecs(init_params(cfg, None, device="meta"), mesh)
    seen = set()
    for path, spec in got.items():
        ref = _reference_path(path, cfg)
        assert want[ref] == (None,) + spec if "blocks" in ref \
            else want[ref] == spec, (path, ref, spec, want[ref])
        seen.add(ref)
    assert seen == set(want)
    # the reference's stacked layout, as a checkpoint holds it
    stacked = PS.flat_pspecs(train_state_template(cfg).params, mesh)
    assert stacked == want
    # some leaf is split over each axis the mesh splits parameters over
    axes = {a for s in got.values() for a in s if a is not None}
    assert axes == {"data", "model"}


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen3-moe-30b-a3b",
                                  "gemma3-12b"])
def test_tree_forms_and_the_gathered_layout(arch):
    mesh = _mesh("data2-model2")
    params = init_params(get_config(arch, smoke=True), None, device="meta")
    trees = {"specs": PS.tree_pspecs(params, mesh),
             "gathered": PS.gathered_shardings(params, mesh),
             "shardings": PS.tree_shardings(params, mesh)}
    flat = dict(PS.leaf_paths(params))

    def at(tree, path):
        for key in path[1:-1].split("]["):
            tree = tree[int(key) if key.isdigit() else key.strip("'")]
        return tree
    for path, spec in PS.flat_pspecs(params, mesh).items():
        assert at(trees["specs"], path) == spec
        assert len(spec) == flat[path].dim()
        assert at(trees["gathered"], path) == tuple(
            None if a == "data" else a for a in spec)
        assert at(trees["shardings"], path) == PS.Sharding(mesh, spec)


def test_the_rules_and_their_filter_follow_the_mesh():
    mesh = _mesh("data2-model2")
    assert PS.active_mesh() is None and PS.rule_axes("batch") == ()
    with PS.mesh_context(mesh):
        assert PS.active_mesh() is mesh
        assert PS.rule_axes("batch") == ("data",)    # no pod axis
        assert PS.rule_axes("vocab") == ("model",)
        assert PS.rule_axes("seq") == ()
        with PS.mesh_context(mesh, {"batch": ("pod", "data")}):
            assert PS.rule_axes("batch") == ("data",)
    assert PS.active_mesh() is None
    x = torch.ones(2)
    assert PS.logical_sharding_constraint(x, ("batch",)) is x
    assert PS.batch_axes(_mesh("pod2-data2-model2")) == ("pod", "data")
    assert PS.shard_map_compat(len, mesh=mesh) is len


def test_the_mesh_lays_ranks_out_rank_major():
    """``jax.make_mesh``'s device order: the last axis fastest."""
    sizes = (2, 3, 2)
    want = np.arange(12).reshape(sizes)
    for rank in range(12):
        m = LMMesh(("pod", "data", "model"), sizes, rank)
        p, d, k = (int(c) for c in np.argwhere(want == rank)[0])
        assert (m.coord("pod"), m.coord("data"), m.coord("model")) == \
            (p, d, k)
        assert m.index(("pod", "data")) == p * 3 + d
    assert _slices(sizes, (2,))[0] == [0, 1]
    assert _slices(sizes, (1,)) == [list(want[p, :, k]) for p in range(2)
                                    for k in range(2)]
    assert _slices(sizes, (0, 1))[1] == list(want[:, :, 1].reshape(-1))
    m = LMMesh(("data", "model"), (4, 2), 5)
    assert m.shape == {"data": 4, "model": 2} and m.world == 8
    assert m.size(("pod", "data")) == 4 and m.group(()) is None


def test_a_lone_process_has_the_one_rank_mesh():
    m = make_local_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.groups == {}
    with pytest.raises(ValueError, match="do not split"):
        make_local_mesh(model_parallel=2)
    with pytest.raises(RuntimeError, match="needs 256"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512"):
        make_production_mesh(multi_pod=True)


def test_a_leaf_is_cut_along_its_split_dims():
    mesh_name = "pod2-data2-model2"
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    parts = {}
    for rank in range(8):
        m = _mesh(mesh_name, rank)
        sh = PS.Sharding(m, ("data", "model", None))
        parts[rank] = sh.shard(t)
        d, k = m.coord("data"), m.coord("model")
        assert torch.equal(parts[rank], t[4 * d:4 * d + 4, 3 * k:3 * k + 3])
        # a leaf split over data and model is counted by each of its
        # shards once a pod; a replicated one by the first rank only
        assert sh.owned(("data", "model"))
        assert PS.Sharding(m, (None, None, None)).owned(
            ("data", "model")) == (d == 0 and k == 0)


@pytest.mark.parametrize("pod_region", [False, True])
@pytest.mark.parametrize("micro", [1, 2])
def test_a_rank_takes_its_rows_of_each_microbatch(micro, pod_region):
    """The whole batch's microbatch ``i`` (a pod's, in the exchange's pod
    region) is the ranks' ``i``-th microbatches concatenated in batch-rank
    order."""
    from repro_torch.launch.steps import _split_microbatches
    B = 16
    batch = {"tokens": np.arange(B * 3).reshape(B, 3)}
    ranks = {}
    for rank in range(8):
        m = _mesh("pod2-data2-model2", rank)
        shards = PS.LMShards(m, {})
        mb = _split_microbatches(shards.local_batch(batch, micro,
                                                    pod_region), micro)
        ranks[(m.coord("pod"), m.coord("data"), m.coord("model"))] = mb
    pods = _split_microbatches(batch, 2) if pod_region else [batch]
    for p, pod in enumerate(pods):
        for i, want in enumerate(_split_microbatches(pod, micro)):
            for k in range(2):
                order = ([(p, d) for d in range(2)] if pod_region else
                         [(q, d) for q in range(2) for d in range(2)])
                got = np.concatenate([ranks[(q, d, k)][i]["tokens"]
                                      for q, d in order])
                assert np.array_equal(got, want["tokens"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1-5-large-398b",
                                  "whisper-large-v3"])
def test_model_parallel_refuses_mamba_and_the_encoder(arch):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="item 4f-iii"):
        refuse_model_split(cfg, LMMesh(("data", "model"), (1, 2)))
    refuse_model_split(cfg, LMMesh(("data", "model"), (2, 1)))


def test_the_active_mesh_is_seen_from_other_threads():
    """Autograd runs a CUDA backward, and recomputes a checkpointed
    block's forward, on a thread of its own: that thread must see the
    mesh (and the dispatch groups) the forward ran under, or the
    recomputed block would drop its collectives."""
    import threading
    from repro_torch.models import layers as L
    mesh = _mesh("data2-model2")
    seen = {}

    def look():
        seen["mesh"] = PS.active_mesh()
        seen["groups"] = L.moe_groups(48)[0]
    with PS.mesh_context(mesh):
        t = threading.Thread(target=look)
        t.start()
        t.join()
    assert seen["mesh"] is mesh
    with L.dispatch_groups(4):
        t = threading.Thread(target=look)
        t.start()
        t.join()
    assert seen == {"mesh": None, "groups": 4}
