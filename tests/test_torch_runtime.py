"""The port's fleet scan runtime against the live JAX reference.

The ``fleet_scan`` golden scenario runs through both front doors on the
CPU.  WAN bytes and the per-window byte and budget histories must match
bitwise; NRMSE tables are held to the sweep's f32 class.  The committed
golden report is not the oracle: the reference no longer reproduces it
(ROADMAP.md queue 3, note b), so the reference is run live.  The
single-edge scans and the mean and multi families have files of their
own (``test_torch_single_edge.py``, ``test_torch_model_families.py``).
"""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.runtime.scan import ScanRuntime as RefScanRuntime
from repro.sweep.diff import TOLERANCE_CLASSES
from repro_torch.api.experiment import Experiment
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.runtime.state import state_from_numpy

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

F32_RTOL, F32_ATOL = TOLERANCE_CLASSES["f32"]
SCENARIO = json.loads((pathlib.Path(__file__).parent / "goldens" / "scenarios"
                       / "fleet_scan.json").read_text())["scenario"]
LIVE_REFERENCE_WAN_BYTES = 11080


@pytest.fixture(scope="module")
def windows():
    return RefExperiment.from_scenario(
        RefScenario.from_dict(SCENARIO)).make_windows()


@pytest.fixture(scope="module")
def reference(windows):
    """The reference's reports, one per front-door configuration."""
    sc = RefScenario.from_dict(SCENARIO)
    out = {}
    for uk in (None, True):
        out[("payloads", uk)] = RefExperiment.from_scenario(
            sc, use_kernel=uk, interpret=bool(uk)).run(windows).raw
    rt = RefScanRuntime.from_scenario(sc, collect="estimates")
    out[("estimates", None)] = rt.run(windows)
    return out


def _port(collect="payloads", use_kernel=None, runtime="scan"):
    d = dict(SCENARIO, runtime=runtime)
    return Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                    use_kernel=use_kernel, collect=collect,
                                    device="cpu")


def _assert_same_run(got: dict, want: dict):
    assert got["wan_bytes"] == want["wan_bytes"]
    np.testing.assert_array_equal(got["bytes_history"], want["bytes_history"])
    np.testing.assert_array_equal(got["budget_history"],
                                  want["budget_history"])
    assert got["wan_bytes_by_region"] == want["wan_bytes_by_region"]
    for q, v in want["fleet_nrmse"].items():
        np.testing.assert_allclose(got["fleet_nrmse"][q], v, rtol=F32_RTOL,
                                   atol=F32_ATOL, err_msg=q)
        np.testing.assert_allclose(got["site_nrmse"][q], want["site_nrmse"][q],
                                   rtol=F32_RTOL, atol=F32_ATOL, err_msg=q)
    for reg, qs in want["region_nrmse"].items():
        for q, v in qs.items():
            np.testing.assert_allclose(got["region_nrmse"][reg][q], v,
                                       rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("use_kernel", [None, True],
                         ids=["legacy_fit", "fused_fit"])
def test_fleet_scan_matches_live_reference(windows, reference, use_kernel):
    report = _port(use_kernel=use_kernel).run()     # the port's own windows
    want = reference[("payloads", use_kernel)]
    assert want["wan_bytes"] == LIVE_REFERENCE_WAN_BYTES
    assert report.wan_bytes == LIVE_REFERENCE_WAN_BYTES
    _assert_same_run(report.raw, want)
    assert report.full_bytes == want["full_bytes"]
    np.testing.assert_allclose(report.wan_cost, want["wan_cost"], rtol=1e-12)


@pytest.mark.parametrize("window,k,n_regions,sites", [(100, 4, 2, 3),
                                                      (256, 8, 2, 4)])
def test_other_fleet_shapes_match_reference(window, k, n_regions, sites):
    """Window lengths off and on the 32-wide reduction grid, wider k."""
    d = json.loads(json.dumps(SCENARIO))
    d["data"].update(window=window, n_points=4 * window, options={"k": k})
    d["topology"].update(n_regions=n_regions, sites_per_region=sites)
    want = RefExperiment.from_scenario(RefScenario.from_dict(d)).run().raw
    got = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                   device="cpu").run().raw
    _assert_same_run(got, want)


def test_port_windows_are_bitwise_the_reference(windows):
    got = _port().make_windows()
    assert len(got) == len(windows)
    for a, b in zip(got, windows):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_estimates_mode_matches_reference(windows, reference):
    report = _port(collect="estimates").run(windows)
    _assert_same_run(report.raw, reference[("estimates", None)])


def test_scan_steps_equals_scan(windows):
    a = _port(collect="payloads", runtime="scan").run(windows).raw
    b = _port(collect="payloads", runtime="scan_steps").run(windows).raw
    assert a["mode"] == "scan" and b["mode"] == "steps"
    np.testing.assert_array_equal(a["bytes_history"], b["bytes_history"])
    np.testing.assert_array_equal(a["budget_history"], b["budget_history"])
    for q in a["site_nrmse"]:
        np.testing.assert_array_equal(a["site_nrmse"][q], b["site_nrmse"][q])


def test_resume_from_reference_carry(windows, reference):
    """The reference's carry after 3 windows, resumed in the port for the
    remaining 3, reproduces the reference's 6-window bytes."""
    sc = RefScenario.from_dict(SCENARIO)
    head = RefScanRuntime.from_scenario(sc).run(windows, n_windows=3)
    carry = jax.tree.map(np.asarray, head["final_state"])
    state = state_from_numpy(carry, device="cpu")
    assert state.window_id == 3
    tail = _port().run(windows, n_windows=3, state=state).raw
    want = reference[("payloads", None)]
    full = np.asarray(want["bytes_history"])
    np.testing.assert_array_equal(tail["bytes_history"], full[3:3 + 3])
    np.testing.assert_array_equal(tail["budget_history"],
                                  np.asarray(want["budget_history"])[3:6])
    assert int(head["wan_bytes"]) + tail["wan_bytes"] == want["wan_bytes"]
    assert state.window_id == 6


@pytest.mark.parametrize("change,item", [
    ({"runtime": "scan_sharded"}, "Sharding"),
    ({"planner": dict(SCENARIO["planner"], engine="sharded")}, "Sharding"),
])
def test_unported_scenarios_name_their_roadmap_item(change, item):
    """Nothing is left unported: the sharded runtime and the sharded
    engine (ROADMAP's ``item``) run ``fleet_scan`` as the scan does,
    bitwise (world size 1)."""
    sc = ScenarioConfig.from_dict(dict(SCENARIO, **change))
    got = Experiment.from_scenario(sc, device="cpu").run(n_windows=3)
    want = Experiment.from_scenario(ScenarioConfig.from_dict(SCENARIO),
                                    device="cpu").run(n_windows=3)
    assert got.wan_bytes == want.wan_bytes
    for key in ("bytes_history", "budget_history"):
        np.testing.assert_array_equal(got.raw[key], want.raw[key], key)
    for q, v in want.nrmse_per_stream.items():
        np.testing.assert_array_equal(got.nrmse_per_stream[q], v, q)


@pytest.mark.parametrize("change,match", [
    ({"runtime": "event", "adaptive": {"detector": "always"},
      "planner": dict(SCENARIO["planner"], solver="slsqp")},
     "solver 'slsqp' is host-only"),
    ({"method": "srs"}, "needs runtime='event'"),
    ({"planner": dict(SCENARIO["planner"], solver="ipm")},
     "solver 'ipm' is host-only"),
    ({"planner": dict(SCENARIO["planner"], engine="host")},
     "needs the 'batched' or 'sharded'"),
], ids=["adaptive_slsqp", "scan_baseline", "scan_ipm", "scan_host_engine"])
def test_scenarios_the_reference_refuses_are_refused(change, match):
    d = dict(SCENARIO, **change)
    with pytest.raises(ValueError, match=match):
        RefExperiment.from_scenario(RefScenario.from_dict(d))
    with pytest.raises(ValueError, match=match):
        Experiment.from_scenario(ScenarioConfig.from_dict(d), device="cpu")


def test_reference_scan_plan_differs_from_its_standalone_plan(windows):
    """ROADMAP queue 3, note d: inside its scan the reference compiles the
    window counts as constants and its f32 statistics round differently,
    which moves one ``n_imputed`` of ``fleet_scan`` window 1.  The port
    reproduces both plans: ``n_static`` for the scan, counts as data for
    the standalone call."""
    import jax.numpy as jnp
    import torch

    from repro.planning.batched import fleet_plan as ref_fleet_plan
    from repro.runtime.state import init_state
    from repro_torch.planning.batched import fleet_plan

    rt = RefScanRuntime.from_scenario(RefScenario.from_dict(SCENARIO))
    pool = jnp.asarray(np.stack(windows))
    _, ys = rt._scan_fn(None)(init_state(6, 4, float(rt.ctrl.equal_share)),
                              jnp.arange(6, dtype=jnp.int32), pool)
    budgets = np.array(ys["budgets"][1])
    counts = np.full((6, 4), 64, np.int32)
    in_scan = np.asarray(ys["n_imputed"][1])
    alone = np.asarray(ref_fleet_plan(jnp.asarray(windows[1]),
                                      jnp.asarray(counts),
                                      jnp.asarray(budgets)).n_imputed)
    assert in_scan[3, 2] == 3 and alone[3, 2] == 4
    args = (torch.as_tensor(windows[1]), torch.as_tensor(counts),
            torch.as_tensor(budgets))
    np.testing.assert_array_equal(
        fleet_plan(*args, n_static=64).n_imputed.numpy(), in_scan)
    np.testing.assert_array_equal(fleet_plan(*args).n_imputed.numpy(), alone)
