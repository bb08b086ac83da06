"""The port's chaos fault injection against the live JAX reference.

Both packages run on the same numpy inputs, made from a seed.  The
liveness tables are host numpy and bitwise (random flaps included, and a
resumed run's slice); the masked controller is held bitwise for all-live,
all-dead and mixed masks; the two chaos goldens (``fleet_scan_chaos_join``
and ``fleet_scan_chaos_region``, the latter at E = 64 and N = 288) give
every counter and every float of the live reference's report.  The
reference runs once per golden, in a module fixture.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.chaos import ChaosSpec as RefSpec
from repro.chaos import chaos_metrics as ref_chaos_metrics
from repro.chaos import liveness_table as ref_liveness_table
from repro.chaos import padded_liveness_table as ref_padded_table
from repro.runtime import controller as ref_ctrl
from repro.runtime.state import ControllerState as RefControllerState
from repro.runtime.scan import ScanRuntime as RefScanRuntime
from repro.sweep.report import serialize_report as ref_serialize
from repro_torch.api.experiment import Experiment
from repro_torch.api.registry import FAULTS
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.chaos import (ChaosSpec, chaos_metrics, liveness_table,
                               make_chaos_carry, padded_liveness_table)
from repro_torch.runtime.controller import (CtrlParams, controller_budgets,
                                            controller_update, water_fill)
from repro_torch.runtime.sharded import ShardedScanRuntime
from repro_torch.runtime.state import ControllerState, state_from_numpy
from repro_torch.sweep.report import serialize_report

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
CHAOS_GOLDENS = ("fleet_scan_chaos_join", "fleet_scan_chaos_region")
# the live reference (CPU, jax 0.9); the committed goldens say 10752 and
# 1052136 WAN bytes (ROADMAP.md queue 3, note b)
LIVE = {"fleet_scan_chaos_join": (10732, 5, 3),
        "fleet_scan_chaos_region": (1053280, 320, 320)}

SPECS = {
    "flaps": dict(flaps=((3, 1, "down"), (6, 1, "up"), (0, 4, "down"))),
    "outage": dict(outages=((2, 5, 1),)),
    "joins": dict(joins=((4, 0), (7, 5))),
    "random": dict(flap_prob=0.2, flap_len=3, seed=11),
    "all": dict(flaps=((9, 2, "down"), (12, 2, "up")),
                outages=((5, 4, 0),), joins=((3, 7),), flap_prob=0.05,
                flap_len=2, seed=3),
}


def _golden(name: str) -> dict:
    return json.loads((GOLDENS / f"{name}.json").read_text())["scenario"]


def _region_of(e: int, n_regions: int) -> np.ndarray:
    return np.repeat(np.arange(n_regions), e // n_regions)


@pytest.mark.parametrize("name", list(SPECS))
def test_liveness_table_is_the_references(name):
    """The (T, E) table bitwise, and a slice starting mid-run equal to the
    full table's rows (the random flaps are keyed on absolute windows)."""
    ref, port = RefSpec(**SPECS[name]), ChaosSpec(**SPECS[name])
    region_of = _region_of(8, 2)
    want = ref_liveness_table(ref, 20, 8, region_of)
    got = liveness_table(port, 20, 8, region_of)
    assert got.dtype == bool and np.array_equal(got, want)
    part = liveness_table(port, 9, 8, region_of, first_window=11)
    assert np.array_equal(part, want[11:])
    assert np.array_equal(
        padded_liveness_table(port, 20, 8, 12, region_of),
        ref_padded_table(ref, 20, 8, 12, region_of))
    assert port.to_dict() == ref.to_dict()
    assert ChaosSpec.from_dict(port.to_dict()) == port


def test_spec_validation_and_registry():
    assert sorted(FAULTS.names()) == ["flap", "join", "outage", "random"]
    assert ChaosSpec().is_trivial
    assert not ChaosSpec(**SPECS["joins"]).is_trivial
    for bad in (dict(flaps=((1, 0, "sideways"),)), dict(outages=((0, 0, 1),)),
                dict(joins=((-1, 0),)), dict(flap_prob=1.0),
                dict(flap_len=0)):
        with pytest.raises(ValueError):
            ChaosSpec(**bad)
    with pytest.raises(ValueError, match="unknown ChaosSpec fields"):
        ChaosSpec.from_dict({"faults": []})
    with pytest.raises(ValueError, match="topology has 6 sites"):
        ChaosSpec(joins=((1, 6),)).validate_topology(6, 2)
    with pytest.raises(ValueError, match="2 regions"):
        ChaosSpec(outages=((1, 1, 2),)).validate_topology(6, 2)


def test_scenario_takes_a_chaos_spec_and_refuses_what_it_cannot_run():
    d = _golden("fleet_scan_chaos_join")
    sc = ScenarioConfig.from_dict(d)
    assert isinstance(sc.chaos, ChaosSpec)
    assert sc.chaos.to_dict() == RefScenario.from_dict(d).chaos.to_dict()
    with pytest.raises(ValueError, match="topology has 6 sites"):
        ScenarioConfig.from_dict(dict(d, chaos={"joins": [[1, 6]]}))
    single = _golden("single_scan")
    with pytest.raises(ValueError, match="requires a fleet topology"):
        ScenarioConfig.from_dict(dict(single, chaos={"joins": [[1, 0]]}))
    # the sharded scan takes the spec too, and runs it as the scan does
    sharded = Experiment.from_scenario(ScenarioConfig.from_dict(
        dict(d, runtime="scan_sharded")), device="cpu")
    assert isinstance(sharded.runtime, ShardedScanRuntime)
    assert sharded.runtime.chaos == sc.chaos
    want = Experiment.from_scenario(sc, device="cpu").run()
    got = sharded.run()
    assert (got.wan_bytes, got.gaps) == (want.wan_bytes, want.gaps)
    np.testing.assert_array_equal(got.raw["budget_history"],
                                  want.raw["budget_history"])


# ------------------------------------------------------------- controller

def _ctrl(mode="rebalance", discount=None):
    return CtrlParams(total_budget=240.0, n_sites=6, mode=mode,
                      cost_discount=discount)


def _states(seed: int):
    rng = np.random.default_rng(seed)
    demand = rng.uniform(0.05, 2.0, 6).astype(np.float32)
    r2 = rng.uniform(0.0, 1.0, 6).astype(np.float32)
    lag = np.zeros(6, np.float32)
    last = rng.uniform(10, 60, 6).astype(np.float32)
    ref = RefControllerState(
        demand=jnp.asarray(demand), r2=jnp.asarray(r2), lag=jnp.asarray(lag),
        lag_seen=jnp.ones(6, bool), seen=jnp.asarray(True),
        last_budgets=jnp.asarray(last))
    port = ControllerState(
        demand=torch.as_tensor(demand), r2=torch.as_tensor(r2),
        lag=torch.as_tensor(lag), lag_seen=torch.ones(6, dtype=torch.bool),
        seen=torch.tensor(True), last_budgets=torch.as_tensor(last))
    return ref, port, rng


MASKS = {"all_live": [True] * 6, "all_dead": [False] * 6,
         "mixed": [True, False, True, True, False, True]}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("mode", ["rebalance", "static", "cost_aware"])
def test_masked_controller_is_the_references(mask, mode):
    """budgets(live=) and update(live=) bitwise the reference's; the dead
    sites' budgets are 0 and their EWMAs hold; an all-live mask gives the
    unmasked result bitwise."""
    discount = (CtrlParams.make_cost_discount([1.0, 2.0, 0.5, 1.5, 3.0, 1.0])
                if mode == "cost_aware" else None)
    p = _ctrl("static" if mode == "static" else "rebalance", discount)
    ref_p = ref_ctrl.CtrlParams(total_budget=240.0, n_sites=6,
                                mode=p.mode, cost_discount=discount)
    ref_s, port_s, rng = _states(len(mask) + len(mode))
    live = np.asarray(MASKS[mask])
    want = np.asarray(ref_ctrl.controller_budgets(ref_s, ref_p,
                                                  live=jnp.asarray(live)))
    got = controller_budgets(port_s, p, live=torch.as_tensor(live))
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy()[~live] == 0).all()
    if mask == "all_live":
        assert torch.equal(got, controller_budgets(port_s, p))

    obs = np.where(live, rng.uniform(0.01, 0.3, 6), np.nan).astype(np.float32)
    r2 = np.where(live, rng.uniform(0, 1, 6), np.nan).astype(np.float32)
    obj = rng.uniform(0.0, 0.2, 6).astype(np.float32)
    ref_new = ref_ctrl.controller_update(
        ref_s, ref_p, jnp.asarray(want), jnp.asarray(obs), jnp.asarray(r2),
        jnp.asarray(obj), live=jnp.asarray(live))
    before = port_s.demand.clone()
    controller_update(port_s, p, got, torch.as_tensor(obs),
                      torch.as_tensor(r2), torch.as_tensor(obj),
                      live=torch.as_tensor(live))
    for f in ("demand", "r2", "lag", "lag_seen", "seen", "last_budgets"):
        assert np.array_equal(getattr(port_s, f).numpy(),
                              np.asarray(getattr(ref_new, f))), f
    assert torch.equal(port_s.demand[~torch.as_tensor(live)],
                       before[~torch.as_tensor(live)])


@pytest.mark.parametrize("e", [4, 6, 40, 100])
def test_water_fill_is_the_references(e):
    """Zero and NaN demand, and fleets past one 32-wide reduction window:
    bitwise the reference's f32 water-fill."""
    rng = np.random.default_rng(e)
    lo = np.full(e, 2.0, np.float32)
    hi = np.full(e, 30.0, np.float32)
    total = 10.0 * e
    b = water_fill(np.zeros(e, np.float32), total, lo, hi)
    assert np.array_equal(b, np.full(e, 10.0, np.float32))
    for d in (np.where(np.arange(e) % 2, np.nan, 1.0).astype(np.float32),
              rng.uniform(0.01, 5.0, e).astype(np.float32)):
        b = water_fill(d, total, lo, hi)
        want = ref_ctrl.water_fill(jnp.asarray(d), total, jnp.asarray(lo),
                                   jnp.asarray(hi))
        assert b.dtype == np.float32 and np.isfinite(b).all()
        assert np.array_equal(b, np.asarray(want))


# ------------------------------------------------- the goldens, end to end

@pytest.fixture(scope="module")
def reference():
    """The live reference's run of each chaos golden: its report and its
    serialized report."""
    out = {}
    for name in CHAOS_GOLDENS:
        rep = RefExperiment.from_scenario(
            RefScenario.from_dict(_golden(name))).run()
        out[name] = (rep, ref_serialize(rep, name=name, tolerance="f32"))
    return out


@pytest.fixture(scope="module")
def port():
    return {name: Experiment.from_scenario(
        ScenarioConfig.from_dict(_golden(name)), device="cpu").run()
        for name in CHAOS_GOLDENS}


@pytest.mark.parametrize("name", CHAOS_GOLDENS)
def test_chaos_golden_is_the_live_reference(reference, port, name):
    """Every counter, float and stream summary of the serialized report
    equal; the byte, budget and liveness histories bitwise."""
    ref, ref_ser = reference[name]
    rep = port[name]
    wan, down, gap = LIVE[name]
    assert (rep.wan_bytes, rep.raw["down_site_windows"],
            rep.raw["gap_served_cells"]) == (wan, down, gap)
    ser = serialize_report(rep, name=name, tolerance="f32")
    assert ser["counters"] == ref_ser["counters"]
    assert ser["floats"] == ref_ser["floats"]
    assert ser["streams"] == ref_ser["streams"]
    for k in ("bytes_history", "budget_history", "liveness"):
        assert np.array_equal(np.asarray(rep.raw[k]),
                              np.asarray(ref.raw[k])), k
    for k in ("outage_nrmse", "steady_nrmse", "availability_by_region"):
        assert rep.raw[k] == ref.raw[k], k


def test_chaos_metrics_are_the_references():
    rng = np.random.default_rng(5)
    live = liveness_table(ChaosSpec(**SPECS["all"]), 16, 8,
                          _region_of(8, 2))
    hist = rng.uniform(10, 40, (16, 8)) * live
    est = {q: np.where(rng.uniform(size=(16, 8, 3)) < 0.9,
                       rng.normal(size=(16, 8, 3)), np.nan)
           for q in ("AVG", "VAR")}
    tru = {q: rng.normal(size=(16, 8, 3)) + 2.0 for q in ("AVG", "VAR")}
    args = (live, hist, 25.0, est, tru, ("AVG", "VAR"), _region_of(8, 2),
            ("r0", "r1"))
    got, want = chaos_metrics(*args), ref_chaos_metrics(*args)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


def test_step_masks_dead_sites(port):
    """On the region golden: a dead cell has budget 0 and ships 0 bytes;
    a dead site's served estimate repeats its last live one (NaN before
    any); the final totals count only live windows."""
    rep = port["fleet_scan_chaos_region"]
    live = np.asarray(rep.raw["liveness"]).astype(bool)
    budgets = np.asarray(rep.raw["budget_history"])
    nbytes = np.asarray(rep.raw["bytes_history"])
    assert (~live).sum() == 320
    assert (budgets[~live] == 0).all() and (nbytes[~live] == 0).all()
    assert (budgets[live] >= 2).all() and (nbytes[live] > 0).all()
    window = _golden("fleet_scan_chaos_region")["data"]["window"]
    count = np.asarray(rep.raw["stream_totals"]["count"])
    assert np.array_equal(count[:, 0], live.sum(axis=0) * float(window))


def test_estimates_path_gap_serves_from_the_carry():
    """collect='estimates': the served tables come from the step's chaos
    carry: a dead site repeats its last live estimate, NaN before any."""
    d = _golden("fleet_scan_chaos_join")
    ex = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                  collect="estimates", device="cpu")
    windows = ex.make_windows()
    stacked = []
    from repro_torch.runtime import scan as scan_mod
    orig = scan_mod._stack_outputs
    scan_mod._stack_outputs = lambda outs: stacked.append(orig(outs)) \
        or stacked[-1]
    try:
        rep = ex.run(windows)
    finally:
        scan_mod._stack_outputs = orig
    live = np.asarray(rep.raw["liveness"]).astype(bool)
    est = stacked[0]["est"]["AVG"]
    # site 0 joins at window 2: nothing served before; site 4 goes down at 3
    assert np.isnan(est[:2, 0]).all() and np.isfinite(est[2:, 0]).all()
    assert not live[3:, 4].any()
    for t in range(3, len(windows)):
        assert np.array_equal(est[t, 4], est[2, 4])
    served = rep.raw["final_state"].chaos.served["AVG"].numpy()
    assert np.array_equal(served, est[-1])


def test_state_from_reference_with_a_chaos_carry():
    """The reference's carry after 3 windows of the join golden, chaos
    carry included, resumed in the port: the reference's byte and budget
    histories and its served memory, bitwise."""
    d = _golden("fleet_scan_chaos_join")
    ref_sc = RefScenario.from_dict(d)
    rt = RefScanRuntime.from_scenario(ref_sc)
    windows = RefExperiment.from_scenario(ref_sc).make_windows()
    full = rt.run(windows)
    head = RefScanRuntime.from_scenario(ref_sc).run(windows, n_windows=3)
    carry = jax.tree.map(np.asarray, head["final_state"])
    state = state_from_numpy(carry, device="cpu")
    assert state.window_id == 3 and state.chaos is not None
    assert torch.equal(state.chaos.live, torch.as_tensor(carry.chaos.live))
    ex = Experiment.from_scenario(ScenarioConfig.from_dict(d), device="cpu")
    tail = ex.runtime.run([np.asarray(w) for w in windows],
                          n_windows=len(windows) - 3, state=state)
    for k in ("bytes_history", "budget_history", "liveness"):
        assert np.array_equal(tail[k], np.asarray(full[k])[3:]), k
    end = jax.tree.map(np.asarray, full["final_state"])
    for q, v in end.chaos.served.items():
        assert np.array_equal(tail["final_state"].chaos.served[q].numpy(), v,
                              equal_nan=True), q
    assert np.array_equal(tail["final_state"].controller.demand.numpy(),
                          end.controller.demand)


def test_trivial_spec_runs_unmasked():
    """A spec that injects nothing runs the unmasked step: the report has
    no chaos keys and equals the run without a spec."""
    d = _golden("fleet_scan_chaos_join")
    with_spec = Experiment.from_scenario(
        ScenarioConfig.from_dict(dict(d, chaos={})), device="cpu").run()
    without = Experiment.from_scenario(
        ScenarioConfig.from_dict(dict(d, chaos=None)), device="cpu").run()
    assert "liveness" not in with_spec.raw
    assert with_spec.raw["final_state"].chaos is None
    assert np.array_equal(with_spec.raw["bytes_history"],
                          without.raw["bytes_history"])
    carry = make_chaos_carry(3, 2, ("AVG",), device="cpu")
    assert carry.live.all() and torch.isnan(carry.served["AVG"]).all()
