"""The fleet host engine (``engine="host"``, alias ``"host_loop"``) in the
port, against the live JAX reference on the CPU.

The host engine plans each site of a fleet window with the host planner
(its f64 IPM included) and returns the sites' payloads, samples drawn,
every site under the window's one key ``seed ^ window_id`` as in the
reference.  On ``fleet_event_host_engine``'s windows its payloads and
per-site ``r2`` are bitwise the reference's, and so is ``host_loop_plan``;
``FleetRuntime`` takes the plans that carry payloads as the reference
does (no draw of its own, the chaos mask only on plans with ``n_real``):
every table, counter and ``r2`` equal on the golden, under chaos, with
device sampling asked for, and with stragglers.  Adaptive re-planning
refuses host-engine plans in both packages.

The reference's IPM needs ``jax.experimental.enable_x64``, which JAX 0.9
removed: the ``x64`` fixture points it at ``jax.enable_x64`` per test.
"""
import json
import pathlib

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.runtime.report as ref_report_mod
import repro_torch.runtime.report as report_mod
from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.core.types import PlannerConfig as RefPlannerConfig
from repro.planning import ENGINES as REF_ENGINES
from repro.planning.engine import host_loop_plan as ref_host_loop_plan
from repro_torch.api.experiment import Experiment, FleetRuntime
from repro_torch.api.registry import ENGINES
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.core.types import PlannerConfig
from repro_torch.planning import HOST_ENGINE, HostEngine, host_loop_plan

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
MODEL_FIELDS = ("coeffs", "loc", "scale", "explained_var")


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _golden() -> dict:
    return json.loads((GOLDENS / "fleet_event_host_engine.json")
                      .read_text())["scenario"]


def _cfg(cls, **change):
    return cls(**dict(_golden()["planner"], **change))


WINDOWS = [np.asarray(w, np.float32) for w in RefExperiment.from_scenario(
    RefScenario.from_dict(_golden())).make_windows()]


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _same_payload(got, want):
    assert got.window_id == want.window_id
    for f in ("n_real", "n_imputed", "predictor"):
        _same(getattr(got, f), getattr(want, f))
    for g, w in zip(got.real_values, want.real_values, strict=True):
        _same(g, w)
    for f in ("mean", "var"):
        _same(got.stats_digest[f], want.stats_digest[f])
    assert (got.model is None) == (want.model is None)
    for f in MODEL_FIELDS if got.model is not None else ():
        _same(getattr(got.model, f), getattr(want.model, f))


def test_the_engine_registry_holds_the_host_engine():
    assert ENGINES.get("host") is ENGINES.get("host_loop") is HOST_ENGINE
    assert isinstance(HOST_ENGINE, HostEngine)
    assert set(REF_ENGINES.names()) - set(ENGINES.names()) == set()


@pytest.mark.parametrize("wid", range(len(WINDOWS)))
def test_plan_fleet_is_the_reference_s(wid, x64):
    w = WINDOWS[wid]
    e, k, n = w.shape
    counts = np.full((e, k), n, np.int64)
    if wid % 2:
        counts[wid % e, 1] = 0                  # a straggled stream
    budgets = np.floor(np.linspace(12.0, 70.0, e))
    for model in ("cubic", "mean"):
        want = REF_ENGINES.get("host").plan_fleet(
            w, counts, budgets, _cfg(RefPlannerConfig, model=model),
            window_id=wid)
        got = ENGINES.get("host_loop").plan_fleet(
            w, counts, budgets, _cfg(PlannerConfig, model=model),
            window_id=wid, device="cpu")
        assert set(got) == set(want) == {"payloads", "r2"}
        for g, r in zip(got["payloads"], want["payloads"], strict=True):
            _same_payload(g, r)
        assert got["r2"].dtype == want["r2"].dtype
        _same(got["r2"], want["r2"])
        assert (got["r2"] == 0).all() == (model == "mean")


def test_host_loop_plan_is_the_reference_s(x64):
    w = WINDOWS[1]
    e, k, n = w.shape
    counts = np.full((e, k), n, np.int64)
    budgets = np.full(e, 40.0)
    got = host_loop_plan(w, counts, budgets, _cfg(PlannerConfig),
                         device="cpu")
    want = ref_host_loop_plan(w, counts, budgets, _cfg(RefPlannerConfig))
    for g, r in zip(got, want, strict=True):
        _same(g, r)
    assert got[0].dtype == want[0].dtype == got[1].dtype == np.int64


def test_every_site_of_a_window_draws_with_one_key(x64):
    """As in the reference, ``plan_fleet`` passes no key: two sites with
    the same window draw the same samples."""
    w = np.stack([WINDOWS[0][0], WINDOWS[0][0]])
    counts = np.full(w.shape[:2], w.shape[2], np.int64)
    out = HOST_ENGINE.plan_fleet(w, counts, np.full(2, 30.0),
                                 _cfg(PlannerConfig), window_id=3,
                                 device="cpu")
    a, b = out["payloads"]
    for x, y in zip(a.real_values, b.real_values, strict=True):
        _same(x, y)


# ------------------------------------------------------------ the runtime

def _straggler(wid, s, i):
    return (wid + s + 2 * i) % 7 == 0


RUNS = {
    "golden": ({}, None, "host"),
    # a flapping site: its plan is made, its payload never sent
    "chaos": ({"chaos": {"flaps": [[1, 2, "down"], [3, 2, "up"]]}}, None,
              "host"),
    # device sampling is skipped for plans that carry payloads
    "device_sampling": ({}, None, "device"),
    "stragglers": ({"planner": {"engine": "host_loop"}}, _straggler, "host"),
}


def _spy(module, monkeypatch) -> dict:
    seen = {}
    real = module.aggregate_fleet

    def spy(**kw):
        seen.update(kw)
        return real(**kw)

    monkeypatch.setattr(module, "aggregate_fleet", spy)
    return seen


def _record_r2(runtime) -> list:
    r2s = []
    real = runtime.engine.plan_fleet

    def plan_fleet(*a, **kw):
        out = real(*a, **kw)
        r2s.append(np.array(out["r2"]))
        return out

    runtime.engine = type("Spy", (), {"plan_fleet": staticmethod(plan_fleet),
                                      "name": runtime.engine.name})()
    return r2s


@pytest.mark.parametrize("case", sorted(RUNS))
def test_fleet_runtime_on_the_host_engine_is_the_reference_s(case, x64,
                                                             monkeypatch):
    change, straggler, sampling = RUNS[case]
    d = _golden()
    for key, v in change.items():
        d[key] = dict(d.get(key) or {}, **v)
    ref_ex = RefExperiment.from_scenario(RefScenario.from_dict(d),
                                         straggler_drop=straggler)
    ex = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                  straggler_drop=straggler, device="cpu")
    assert isinstance(ex.runtime, FleetRuntime)
    ref_ex.runtime.sampling = ex.runtime.sampling = sampling
    r2_ref, r2 = _record_r2(ref_ex.runtime), _record_r2(ex.runtime)
    seen_ref = _spy(ref_report_mod, monkeypatch)
    seen = _spy(report_mod, monkeypatch)
    rep_ref = ref_ex.run(WINDOWS)
    rep = ex.run(WINDOWS)
    for key in ("est", "est_q", "tru"):
        for q in seen_ref[key]:
            _same(seen[key][q], seen_ref[key][q])
    for key in ("ages", "bytes_per_site", "cost_per_site", "budget_history",
                "arrival_lag_ms"):
        _same(seen[key], seen_ref[key])
    for key in ("gaps", "revisions", "late_drops", "duplicates",
                "retransmits", "plan_windows", "total_tuples"):
        assert seen[key] == seen_ref[key], key
    assert len(r2) == len(r2_ref) == len(WINDOWS)
    for g, w in zip(r2, r2_ref):
        _same(g, w)
    assert rep.wan_bytes == rep_ref.wan_bytes
    assert rep.nrmse == rep_ref.nrmse
    if case == "golden":
        assert rep.wan_bytes == 4796           # the live reference's
    if case == "chaos":
        assert (np.asarray(seen["budget_history"])[1:3, 2] == 0).all()


@pytest.mark.parametrize("engine", ["host", "host_loop"])
def test_adaptive_refuses_host_engine_plans(engine):
    d = dict(_golden(), adaptive={"detector": "always"},
             planner=dict(_golden()["planner"], engine=engine))
    msg = "adaptive re-planning cannot reuse host-engine plans"
    with pytest.raises(ValueError, match=msg):
        RefExperiment.from_scenario(RefScenario.from_dict(d))
    with pytest.raises(ValueError, match=msg):
        Experiment.from_scenario(ScenarioConfig.from_dict(d), device="cpu")


def test_the_batched_engine_sends_host_only_solvers_to_the_host_engine():
    from repro.planning.engine import UnsupportedPlanConfig as RefUnsupported
    from repro_torch.planning import UnsupportedPlanConfig
    msg = "or engine='host'"
    with pytest.raises(RefUnsupported, match=msg):
        REF_ENGINES.get("batched").check(RefPlannerConfig(solver="ipm"))
    with pytest.raises(UnsupportedPlanConfig, match=msg):
        ENGINES.get("batched").check(PlannerConfig(solver="ipm"))
