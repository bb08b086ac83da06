"""The MoE's grouped dispatch (the reference's ``_moe_batch_axes`` with
G > 1) in one process, against the reference.

The reference cuts the T tokens into G groups, one per batch shard, when
``T % G == 0`` and ``T / G >= 8``; each group sorts and buckets its own
tokens with the capacity of ``T / G`` tokens, and the aux losses are over
all T.  Its mesh path does not run on this container's jax (ROADMAP
queue 3, note c), but a group's dispatch is the reference's
``moe_apply`` on that group's tokens alone, and the aux losses are its
all-token formula.  So the port's ``moe_apply`` under
``dispatch_groups(G)`` is held against the reference's jitted
``moe_apply`` on each group:

* the routes bitwise: each token's top-k experts, the stable sort of the
  group's flat expert ids and each entry's rank clipped at the group's
  capacity, so the same entries drop (a capacity factor of 0.5 drops
  some in every case);
* the layer's output bitwise in bf16 and within ``sweep/diff.py``'s
  ``f32`` class in f32 (the limits of ``test_torch_lm_moe.py``); the
  port's grouped output bitwise its own one-group layer on each group;
* the aux losses within the ``f32`` class of the reference's layer on
  all T tokens, and bitwise the port's one-group layer on all T.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import layers as PL
from test_torch_lm_moe import (MOE, _assert_routes, _cfgs, _inputs,
                               _layer_weights, _np, _port_tree, _ref_moe)

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

B, S = 2, 24


def _spied_dispatch(params, x, m, groups):
    """The port's grouped layer, with each group's routes as it takes
    them: (out, aux, [(sort_idx, sorted_e, rank_c)], topv, topi)."""
    calls, routed = [], {}
    dispatch, router = PL.moe_dispatch, PL.moe_router

    def spy_dispatch(topi, cap):
        out = dispatch(topi, cap)
        calls.append((out, cap))
        return out

    def spy_router(*a):
        out = router(*a)
        routed["topv"], routed["topi"] = out[2], out[3]
        return out
    PL.moe_dispatch, PL.moe_router = spy_dispatch, spy_router
    try:
        with PL.dispatch_groups(groups):
            out, aux = PL.moe_apply(params, x, m)
    finally:
        PL.moe_dispatch, PL.moe_router = dispatch, router
    return out, aux, calls, routed["topv"], routed["topi"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("arch", MOE)
def test_each_group_is_the_references_layer_on_its_tokens(arch, groups,
                                                          dtype):
    rc, pc = _cfgs(arch, dtype, capacity_factor=0.5)
    m, k = pc.moe, pc.moe.top_k
    tree = _layer_weights(arch, seed=3)
    params = _port_tree(tree)
    xj, xp = _inputs(rc.d_model, dtype, seed=4, shape=(B, S))
    out, aux, calls, topv, topi = _spied_dispatch(params, xp, m, groups)
    T, d = B * S, rc.d_model
    tg = T // groups
    assert len(calls) == groups
    drops = 0
    flat_j, flat_p = xj.reshape(T, d), xp.reshape(T, d)
    for g, ((sort_idx, _, rank_c), cap) in enumerate(calls):
        rows = slice(g * tg, (g + 1) * tg)
        assert cap == PL.moe_capacity(tg, m) == max(
            int(np.ceil(tg * k / m.n_experts * m.capacity_factor)), 4)
        record = {}
        want = _ref_moe(tree, flat_j[rows].reshape(1, tg, d), rc.moe, record)
        drops += _assert_routes((topv[rows], topi[rows], sort_idx, rank_c,
                                 cap), record, k)
        got = out.reshape(T, d)[rows]
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want[0]).reshape(tg, d),
                                       rtol=3e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(_np(got),
                                          _np(want[0]).reshape(tg, d))
        own, _ = PL.moe_apply(params, flat_p[rows].reshape(1, tg, d), m)
        assert torch.equal(got, own.reshape(tg, d))
    assert drops > 0
    # the aux losses over all T tokens
    all_tokens = _ref_moe(tree, xj, rc.moe)
    for name in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux[name]),
                                   float(all_tokens[1][name]),
                                   rtol=3e-5, atol=1e-6)
    _, one = PL.moe_apply(params, xp, m)
    assert all(torch.equal(aux[n], one[n]) for n in one)


@pytest.mark.parametrize("groups,expect", [(1, 1), (2, 2), (6, 6), (7, 1),
                                           (8, 1)])
def test_groups_need_a_whole_count_of_at_least_eight_tokens(groups, expect):
    """48 tokens: 6 groups of 8 split, 7 do not divide them and 8 would
    hold 6 tokens each, so both dispatch as one group, as the
    reference's ``_moe_batch_axes`` decides."""
    assert PL.moe_groups(48)[0] == 1
    with PL.dispatch_groups(groups):
        assert PL.moe_groups(48)[0] == expect


def test_the_output_follows_the_groups():
    """Grouping changes which entries fit: at a capacity factor of 0.5
    one group of 48 tokens and four of 12 drop different entries, so the
    two outputs differ."""
    rc, pc = _cfgs("qwen3-moe-30b-a3b", "float32", capacity_factor=0.5)
    params = _port_tree(_layer_weights("qwen3-moe-30b-a3b", seed=3))
    _, xp = _inputs(rc.d_model, "float32", seed=4, shape=(B, S))
    one, _ = PL.moe_apply(params, xp, pc.moe)
    with PL.dispatch_groups(4):
        four, _ = PL.moe_apply(params, xp, pc.moe)
    assert not np.array_equal(_np(one), _np(four))
