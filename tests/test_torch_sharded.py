"""The port's site sharding against ``repro.parallel.sharding``,
``repro.planning.sharded`` and ``repro.runtime.sharded``, at world size 1
(no process group; the gloo ranks are ``test_torch_sharded_ranks.py``).

The reference runs on one JAX device here, where its sharded engine and
runtime are bitwise its unsharded ones.  The port's sharded paths are
held to the live reference's reports exactly, and to the port's
unsharded runs bitwise, padding included: padded rows are dead sites
that no live output reads.
"""
import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.experiment import Experiment as RefExperiment
from repro.api.registry import ENGINES as REF_ENGINES
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.core.types import PlannerConfig as RefPlannerConfig
from repro.data.streams import fleet_like as ref_fleet_like
from repro.data.streams import fleet_windows as ref_fleet_windows
from repro.parallel.sharding import pad_site_axis as ref_pad_site_axis
from repro.parallel.sharding import site_pad as ref_site_pad
from repro.runtime.step import sample_fleet as ref_sample_fleet
from repro.sweep.report import serialize_report as ref_serialize
from repro_torch.adaptive import AdaptiveSpec
from repro_torch.adaptive.policy import gate_init, gate_update
from repro_torch.api.experiment import Experiment
from repro_torch.api.registry import ENGINES
from repro_torch.api.scenario import ScenarioConfig, TopologySpec
from repro_torch.core.types import PlannerConfig
from repro_torch.data.streams import fleet_like
from repro_torch.parallel import (SiteGroup, SiteShard, pad_site_axis,
                                  site_group, site_pad)
from repro_torch.runtime import ShardedScanRuntime
from repro_torch.runtime.controller import CtrlParams, controller_budgets
from repro_torch.runtime.state import init_state
from repro_torch.runtime.step import sample_fleet
from repro_torch.sweep.diff import diff_reports
from repro_torch.sweep.report import serialize_report

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
E = 6


def _golden(name: str) -> dict:
    return json.loads((GOLDENS / f"{name}.json").read_text())


def _case(name: str) -> dict:
    """The sharded scan cases of ``test_torch_sharded_ranks.py``."""
    base = _golden("fleet_scan_sharded")["scenario"]
    return {"rebalance": base,
            "static": dict(base, controller=dict(base["controller"],
                                                 mode="static")),
            "chaos": dict(base, chaos=_golden("fleet_scan_chaos_join")
                          ["scenario"]["chaos"]),
            "adaptive": dict(_golden("fleet_scan_adaptive_ph")["scenario"],
                             runtime="scan_sharded")}[name]


def _run(d: dict, **change):
    return Experiment.from_scenario(ScenarioConfig.from_dict(dict(d,
                                                                  **change)),
                                    device="cpu")


def _same_report(got: dict, want: dict) -> None:
    for key in ("wan_bytes", "gaps", "bytes_history", "budget_history",
                "controller_demand"):
        np.testing.assert_array_equal(got[key], want[key], key)
    for q, v in want["site_nrmse"].items():
        np.testing.assert_array_equal(got["site_nrmse"][q], v, q)
    for key in ("planner_invocations", "plans_reused", "drift_fires"):
        assert got.get(key) == want.get(key), key
    for f in dataclasses.fields(want["final_state"].controller):
        np.testing.assert_array_equal(
            getattr(got["final_state"].controller, f.name).numpy(),
            getattr(want["final_state"].controller, f.name).numpy(), f.name)


# --------------------------------------------------------------- helpers

@pytest.mark.parametrize("n", [1, 5, 6, 12, 1023, 1024])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_site_pad_and_pad_site_axis_are_the_reference_s(n, d):
    assert site_pad(n, d) == ref_site_pad(n, d)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want = np.asarray(ref_pad_site_axis(jnp.asarray(x), n + site_pad(n, d),
                                        fill=2.0))
    np.testing.assert_array_equal(pad_site_axis(x, len(want), fill=2.0),
                                  want)
    np.testing.assert_array_equal(
        pad_site_axis(torch.as_tensor(x), len(want), fill=2.0).numpy(), want)


def test_without_a_process_group_the_world_is_one_rank():
    import torch.distributed as dist
    import repro_torch.runtime  # noqa: F401
    assert not dist.is_initialized()
    assert site_group() == SiteGroup(rank=0, world=1, gloo=None)


def test_a_shard_of_one_rank_holds_every_row_and_gathers_none():
    shard = SiteShard(SiteGroup(), n_sites=6, n_padded=9)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    rows = shard.local_rows(x)
    assert (shard.rows, shard.offset, rows.shape) == (9, 0, (9, 2))
    assert not rows[6:].any()
    got, live = shard.gather_sites(rows, np.arange(9) < 6)
    np.testing.assert_array_equal(got, x)
    assert live.all() and live.shape == (6,)
    dev = torch.tensor(0.25)
    assert shard.max_over_sites(dev) is dev
    with pytest.raises(ValueError, match="multiple of the 4-rank"):
        SiteShard(SiteGroup(rank=0, world=4), n_sites=6, n_padded=6)
    with pytest.raises(ValueError, match="n_padded"):
        SiteShard(SiteGroup(), n_sites=6, n_padded=5)


# --------------------------------------------------------------- the step

@pytest.mark.parametrize("rows,offset", [(2, 0), (2, 2), (2, 4), (2, 6),
                                         (1, 3), (8, 0)])
def test_a_sliced_draw_is_the_reference_s(rows, offset):
    """A rank's rows of the fleet's Fisher-Yates draw (E = 6 padded to 8),
    one-row shards included, bitwise the reference's ``sample_slice``
    draw and the unsharded draw's rows."""
    rng = np.random.default_rng(7)
    values = rng.normal(2.0, 1.0, (8, 4, 64)).astype(np.float32)
    values[E:] = 0.0
    n_real = rng.integers(1, 40, (8, 4)).astype(np.int32)
    n_real[E:] = 0
    sl = slice(offset, offset + rows)
    got = sample_fleet(11, 5, torch.as_tensor(values[sl]),
                       torch.as_tensor(n_real[sl]), (E, 8, offset)).numpy()
    want = np.asarray(ref_sample_fleet(11, 5, jnp.asarray(values[sl]),
                                       jnp.asarray(n_real[sl]),
                                       sample_slice=(E, 8, offset)))
    np.testing.assert_array_equal(got, want)
    full = sample_fleet(11, 5, torch.as_tensor(values[:E]),
                        torch.as_tensor(n_real[:E])).numpy()
    real = slice(offset, min(offset + rows, E))
    np.testing.assert_array_equal(got[:real.stop - offset], full[real])
    assert not got[real.stop - offset:].any()


@pytest.mark.parametrize("mode", ["rebalance", "static"])
@pytest.mark.parametrize("n_padded", [6, 7, 9])
def test_sharded_budgets_water_fill_the_unpadded_fleet(mode, n_padded):
    """The budgets of a shard's rows are the unsharded controller's; its
    padded rows are dead and get 0."""
    rng = np.random.default_rng(3)
    p = CtrlParams(total_budget=240.0, n_sites=E, mode=mode)
    state = init_state(E, 4, p.equal_share, device="cpu").controller
    state.demand = torch.as_tensor(rng.uniform(0.05, 2.0, E)
                                   .astype(np.float32))
    state.seen = torch.tensor(True)
    live = torch.as_tensor(np.arange(E) != 2)
    want = controller_budgets(state, p, live=live).numpy()
    shard = SiteShard(SiteGroup(), E, n_padded)
    local = dataclasses.replace(
        state, demand=shard.local_rows(state.demand),
        last_budgets=shard.local_rows(state.last_budgets))
    got = controller_budgets(local, p, live=shard.local_rows(live),
                             shard=shard).numpy()
    np.testing.assert_array_equal(got[:E], want)
    assert not got[E:].any()


def test_padded_rows_add_nothing_to_the_gate():
    """Zero padded rows (zero values, zero assumed correlation) leave the
    gate's deviation max, and so its decisions, as they are."""
    spec = AdaptiveSpec(detector="threshold", threshold=0.05, halflife=4.0)
    vals, _ = fleet_like(n_sites=E, n_regions=2, k=4, n_points=64 * 5,
                         seed=4)
    shard = SiteShard(SiteGroup(), E, 9)
    gate, gate_p = gate_init(E, 4, device="cpu"), gate_init(9, 4,
                                                             device="cpu")
    decided = []
    for t in range(5):
        v = torch.as_tensor(np.ascontiguousarray(vals[:, :, t * 64:
                                                      (t + 1) * 64]))
        c = torch.full((E, 4), 64, dtype=torch.int32)
        gate, replan = gate_update(spec, gate, v, c)
        gate_p, replan_p = gate_update(spec, gate_p, shard.local_rows(v),
                                       shard.local_rows(c, fill=64),
                                       shard=shard)
        assert bool(replan) == bool(replan_p)
        decided.append(bool(replan))
        for f in ("det_accum", "det_age", "windows_since", "replans",
                  "fires"):
            assert torch.equal(getattr(gate, f), getattr(gate_p, f)), f
    assert decided[0]


# -------------------------------------------------------------- the engine

def test_sharded_plan_fleet_is_the_batched_one_and_the_reference_s():
    """E = 12, one straggled stream (the reference's engine test): the
    sharded plan is the batched one bitwise, and the reference's (one
    JAX device) in every allocation field and to the last bit in the
    floats."""
    e, k, w = 12, 4, 64
    vals, _ = ref_fleet_like(e, 3, k, n_points=2 * w, seed=1)
    x = ref_fleet_windows(vals, w)[0]
    counts = np.full((e, k), w, np.int64)
    counts[2, 1] = 0
    budgets = np.full(e, 0.25 * k * w)
    got = ENGINES.get("sharded").plan_fleet(
        x, counts, budgets, PlannerConfig(solver="closed_form"),
        device="cpu")
    batched = ENGINES.get("batched").plan_fleet(
        x, counts, budgets, PlannerConfig(solver="closed_form"),
        device="cpu")
    ref = REF_ENGINES.get("sharded").plan_fleet(
        x, counts, budgets, RefPlannerConfig(solver="closed_form"))
    assert got.keys() == batched.keys()
    for f, a in got.items():
        np.testing.assert_array_equal(a, batched[f], f)
        np.testing.assert_array_equal(a, np.asarray(ref[f]).astype(a.dtype),
                                      f)


def test_the_sharded_engine_runs_through_experiment():
    """The reference's engine scenario (pred_err demand, AVG only) through
    both front doors: the event loop on the sharded engine gives the
    reference's report exactly."""
    d = {"data": {"dataset": "fleet", "n_points": 128, "window": 64,
                  "seed": 2, "options": {"k": 4}},
         "budget_fraction": 0.25,
         "planner": {"solver": "closed_form", "engine": "sharded"},
         "topology": {"n_regions": 2, "sites_per_region": 3, "seed": 2},
         "controller": {"demand_signal": "pred_err"}, "queries": ["AVG"]}
    ex = Experiment.from_scenario(ScenarioConfig.from_dict(d), device="cpu")
    assert ex.runtime.engine.name == "sharded"
    got = serialize_report(ex.run(), name="engine", tolerance="exact")
    want = ref_serialize(RefExperiment.from_scenario(
        RefScenario.from_dict(d)).run(), name="engine", tolerance="exact")
    assert diff_reports(want, got) == []
    assert got["counters"]["wan_bytes"] < got["counters"]["full_bytes"]


# ------------------------------------------------------------- the runtime

@pytest.mark.parametrize("name", ["fleet_scan_sharded",
                                  "fleet_event_sharded_static"])
def test_the_sharded_goldens_are_the_live_reference_s(name):
    """World size 1: each sharded golden's report is the live reference's
    (one JAX device), every counter and float exactly."""
    g = _golden(name)
    got = serialize_report(
        _run(g["scenario"]).run(), name=name, tolerance="exact")
    want = ref_serialize(RefExperiment.from_scenario(
        RefScenario.from_dict(g["scenario"])).run(), name=name,
        tolerance="exact")
    assert diff_reports(want, got) == []


@pytest.mark.parametrize("extra", [0, 1, 3])
@pytest.mark.parametrize("case", ["rebalance", "static", "chaos",
                                  "adaptive"])
def test_padding_is_invariant(case, extra):
    """``pad_sites`` = E + extra: the padded rows are dead sites, and the
    run is the unsharded scan's bitwise."""
    d = _case(case)
    ex = _run(d)
    windows = ex.make_windows()
    rt = dataclasses.replace(ex.runtime, pad_sites=E + extra)
    assert rt.shard.n_padded == E + extra
    _same_report(rt.run(windows),
                 _run(d, runtime="scan").runtime.run(windows))


def test_construction_rejections():
    """The reference's refusals, in its words."""
    single = _golden("single_scan")["scenario"]
    for cls in (ScenarioConfig, RefScenario):
        with pytest.raises(ValueError, match="nothing to shard"):
            cls.from_dict(dict(single, runtime="scan_sharded"))
    rt = _run(_case("rebalance")).runtime
    with pytest.raises(ValueError, match=r"pad_sites \(4\) must be >= "
                                         r"n_sites \(6\)"):
        dataclasses.replace(rt, pad_sites=E - 2)
    one = TopologySpec(n_regions=1, sites_per_region=1).build(4)
    with pytest.raises(ValueError, match="needs a fleet of >= 2 sites"):
        dataclasses.replace(rt, topology=one)
    with pytest.raises(ValueError, match="nothing to shard"):
        ShardedScanRuntime(cfg=rt.cfg, ctrl=rt.ctrl, device="cpu")
