"""The paper's baseline samplers (SRS, ApproxIoT, S-VOILA, Neyman-cost)
and the MEDIAN query in the port, against the live JAX reference on the
CPU.

* The allocators (``core/samplers.py``) are host numpy in both packages:
  equal on counts, budgets, sigmas and costs drawn by Hypothesis, and on
  ties, a zero share sum, a budget above the total and a zero cost.
* ``plan_with_baseline`` draws its samples with the port's threefry
  permutations under the reference's key (``seed ^ (window_id * 9176)``)
  and takes its sigmas from the window's variances: every ``n_real``,
  sample and stats digest equal on the ``single_event_baseline_srs``
  golden's windows and on Fig. 5's (smartcity, 4096 points, windows of
  256, seed 9), with and without stragglers.
* ``EdgeNode``'s baseline branch, whole baseline runs on Fig. 5's setting,
  ``median`` and ``quantile``, and the scan's refusal of a baseline.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.core import planner as ref_planner
from repro.core import queries as ref_queries
from repro.core import samplers as ref_samplers
from repro.core.types import PlannerConfig as RefPlannerConfig
from repro.core.types import WindowBatch as RefWindowBatch
from repro.streaming.runtime import EdgeNode as RefEdgeNode
from repro.sweep.report import serialize_report as ref_serialize
from repro_torch.api.experiment import Experiment
from repro_torch.api.registry import BASELINES, SAMPLERS
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.core import planner, queries, samplers
from repro_torch.core.types import PlannerConfig, WindowBatch
from repro_torch.runtime.scan import ScanRuntime
from repro_torch.streaming import EdgeNode
from repro_torch.sweep.diff import diff_reports
from repro_torch.sweep.report import serialize_report

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
METHODS = ["approx_iot", "neyman_cost", "s_voila", "srs"]
# benchmarks/fig5_smartcity.py's data
FIG5 = {"dataset": "smartcity", "n_points": 4096, "window": 256, "seed": 9,
        "options": {}}


def _golden(name: str) -> dict:
    return json.loads((GOLDENS / f"{name}.json").read_text())["scenario"]


def _windows(data: dict) -> list:
    d = dict(_golden("single_event_baseline_srs"), data=data)
    return [dataclasses.replace(w, values=np.array(w.values))
            for w in RefExperiment.from_scenario(RefScenario.from_dict(d))
            .make_windows()]


GOLDEN_WINDOWS = _windows(_golden("single_event_baseline_srs")["data"])
FIG5_WINDOWS = _windows(FIG5)


def test_the_registries_hold_the_reference_s_names():
    """Every registry under the reference's key, with every one of the
    reference's names (sharding ported the last two)."""
    from repro.api import registry as ref_registry
    from repro_torch.api import registry
    assert SAMPLERS.names() == ref_registry.SAMPLERS.names()
    assert BASELINES.names() == ref_registry.BASELINES.names() == \
        tuple(METHODS)
    port, ref = registry.populate(), ref_registry.populate()
    assert port.keys() == ref.keys()
    missing = {key: set(ref[key].names()) - set(port[key].names())
               for key in ref}
    assert {k: v for k, v in missing.items() if v} == {}
    for key in ref:
        assert set(port[key].names()) <= set(ref[key].names()), key


# ------------------------------------------------------------- allocators

counts_st = st.lists(st.integers(0, 300), min_size=1, max_size=9)


def _same(got, want):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@settings(database=None, max_examples=150, deadline=None)
@given(counts=counts_st, budget=st.integers(0, 2000),
       fracs=st.lists(st.floats(-1.0, 50.0), min_size=9, max_size=9))
def test_largest_remainder_is_the_reference_s(counts, budget, fracs):
    cap = np.asarray(counts, np.int32)
    frac = np.asarray(fracs[:len(counts)], np.float64)
    _same(samplers._largest_remainder(frac, budget, cap),
          ref_samplers._largest_remainder(frac, budget, cap))


@settings(database=None, max_examples=150, deadline=None)
@given(counts=counts_st, budget=st.integers(0, 2000))
def test_srs_and_stratified_are_the_reference_s(counts, budget):
    n = np.asarray(counts, np.int32)
    _same(samplers.srs_allocation(n, budget),
          ref_samplers.srs_allocation(n, budget))
    _same(samplers.stratified_allocation(n, budget),
          ref_samplers.stratified_allocation(n, budget))


@settings(database=None, max_examples=150, deadline=None)
@given(counts=counts_st, budget=st.floats(0.0, 3000.0),
       sigmas=st.lists(st.floats(0.0, 100.0, width=32), min_size=9,
                       max_size=9),
       costs=st.lists(st.floats(0.05, 8.0), min_size=9, max_size=9))
def test_svoila_and_neyman_cost_are_the_reference_s(counts, budget, sigmas,
                                                    costs):
    n = np.asarray(counts, np.float64)
    sigma = np.asarray(sigmas[:len(counts)], np.float32)
    cost = np.asarray(costs[:len(counts)], np.float64)
    _same(samplers.svoila_allocation(n, sigma, int(budget)),
          ref_samplers.svoila_allocation(n, sigma, int(budget)))
    _same(samplers.neyman_cost_allocation(n, sigma, cost, budget),
          ref_samplers.neyman_cost_allocation(n, sigma, cost, budget))


EDGE_CASES = {
    # equal remainders everywhere: the tie order decides who gets the rest
    "ties": (np.full(6, 10, np.int32), np.ones(6, np.float32), 31, None),
    "zero_share_sum": (np.array([0, 0, 0, 0], np.int32),
                       np.zeros(4, np.float32), 3, None),
    "some_empty": (np.array([0, 7, 0, 3], np.int32),
                   np.array([1.0, 0.0, 2.0, 5.0], np.float32), 5, None),
    "budget_above_total": (np.array([3, 5, 2], np.int32),
                           np.array([1.0, 2.0, 0.5], np.float32), 50, None),
    "zero_cost": (np.array([40, 40, 40], np.int32),
                  np.array([1.0, 2.0, 3.0], np.float32), 30,
                  np.array([0.0, 1.0, 2.0])),
}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_baseline_allocators_on_edge_cases(case, method):
    counts, sigma, budget, cost = EDGE_CASES[case]
    want = ref_planner.BASELINES.get(method)(counts, sigma, budget, cost)
    got = BASELINES.get(method)(counts, sigma, budget, cost)
    _same(got, want)
    assert got.sum() <= max(budget, 0) or method == "neyman_cost"
    assert (got <= counts).all()


# ---------------------------------------------------- plan_with_baseline

def _cases():
    out = []
    for label, windows in (("golden", GOLDEN_WINDOWS),
                           ("fig5", FIG5_WINDOWS)):
        for w in windows:
            values = np.asarray(w.values)
            k, n = values.shape
            counts = np.full(k, n, np.int32)
            if w.window_id % 2:          # a straggler and a short stream
                counts[w.window_id % k] = 0
                counts[(w.window_id + 1) % k] = 37
            out.append((label, w.window_id, values, counts))
    return out


CASES = _cases()


def _same_payload(got, want):
    assert got.window_id == want.window_id
    _same(got.n_real, np.asarray(want.n_real))
    _same(got.n_imputed, np.asarray(want.n_imputed))
    _same(got.predictor, np.asarray(want.predictor))
    assert got.model is want.model is None
    assert got.mean_imputation and want.mean_imputation
    assert len(got.real_values) == len(want.real_values)
    for g, w in zip(got.real_values, want.real_values):
        _same(g, w)
    for f in ("mean", "var"):
        _same(got.stats_digest[f], np.asarray(want.stats_digest[f]))
    assert got.wan_bytes() == want.wan_bytes()


@pytest.mark.parametrize("method", METHODS)
def test_plan_with_baseline_is_the_reference_s(method):
    for label, wid, values, counts in CASES:
        k = len(counts)
        budget = max(int(0.26 * counts.sum()), 2)
        cost = (None if wid % 3 else
                tuple(1.0 + 0.5 * (i % 3) for i in range(k)))
        want = ref_planner.plan_with_baseline(
            RefWindowBatch.from_numpy(values, counts, wid), budget, method,
            seed=4, cost=cost)
        got = planner.plan_with_baseline(
            WindowBatch.from_numpy(values, counts, wid), budget, method,
            seed=4, cost=cost, device="cpu")
        _same_payload(got, want)


@pytest.mark.parametrize("method", ["s_voila", "neyman_cost"])
def test_the_sigmas_are_read_from_the_variances(method, monkeypatch):
    """The sigma-driven allocators get the reference's sigmas bitwise (the
    allocations above could hide a last-bit gap)."""
    seen = {"port": [], "ref": []}
    for name, mod, reg in (("port", samplers, BASELINES),
                           ("ref", ref_samplers, ref_planner.BASELINES)):
        fn = getattr(mod, f"{'svoila' if method == 's_voila' else method}"
                     f"_allocation")

        def spy(n, sigma, *rest, _fn=fn, _name=name):
            seen[_name].append(np.array(sigma))
            return _fn(n, sigma, *rest)

        monkeypatch.setattr(mod, fn.__name__, spy)
    for label, wid, values, counts in CASES[:8]:
        budget = max(int(0.26 * counts.sum()), 2)
        ref_planner.plan_with_baseline(
            RefWindowBatch.from_numpy(values, counts, wid), budget, method)
        planner.plan_with_baseline(
            WindowBatch.from_numpy(values, counts, wid), budget, method,
            device="cpu")
    assert len(seen["port"]) == len(seen["ref"]) == 8
    for g, w in zip(seen["port"], seen["ref"]):
        _same(g, w)


def test_an_unknown_baseline_lists_the_registered_ones():
    w = WindowBatch.from_numpy(np.ones((3, 8), np.float32))
    with pytest.raises(KeyError, match="registered baseline planners: "
                       "'approx_iot'"):
        planner.plan_with_baseline(w, 4, "reservoir", device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_edge_node_baseline_branch_is_the_reference_s(method):
    def drop(wid, i):
        return (wid + 2 * i) % 5 == 0

    cost = (1.0, 2.0, 0.5, 1.5, 1.0, 3.0)[:GOLDEN_WINDOWS[0].values.shape[0]]
    want_node = RefEdgeNode(cfg=RefPlannerConfig(seed=6,
                                                 cost_per_sample=cost),
                            budget_fraction=0.3, method=method,
                            straggler_drop=drop)
    got_node = EdgeNode(cfg=PlannerConfig(seed=6, cost_per_sample=cost),
                        budget_fraction=0.3, method=method,
                        straggler_drop=drop, device="cpu")
    for w in FIG5_WINDOWS[:6]:
        want = want_node.process_window(w)
        got = got_node.process_window(
            WindowBatch.from_numpy(np.asarray(w.values),
                                   np.asarray(w.counts), w.window_id))
        _same_payload(got, want)
    assert got_node.plan_seconds > 0
    with pytest.raises(KeyError, match="unknown method 'reservoir'"):
        EdgeNode(cfg=PlannerConfig(), budget_fraction=0.3,
                 method="reservoir", device="cpu")


# Fig. 5's setting, every baseline beside the model it is compared with
@pytest.mark.parametrize("method", [*METHODS, "model"])
def test_fig5_baseline_run_is_the_live_reference(method, monkeypatch):
    import jax
    import jax.experimental
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)
    d = dict(_golden("single_event_baseline_srs"), data=FIG5,
             method=method, budget_fraction=0.26,
             queries=["AVG", "VAR", "MIN", "MAX", "MEDIAN"])
    d["planner"] = dict(d["planner"], solver="closed_form")
    want = ref_serialize(RefExperiment.from_scenario(
        RefScenario.from_dict(d)).run(), name=method, tolerance="exact")
    rep = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                   device="cpu").run()
    got = serialize_report(rep, name=method, tolerance="exact")
    assert diff_reports(want, got) == []
    assert 0 < rep.wan_bytes < rep.full_bytes


# ---------------------------------------------------------------- queries

@pytest.mark.parametrize("n", [0, 1, 2, 7, 64, 255])
def test_median_and_quantile_are_the_reference_s(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got, want = queries.median(x), ref_queries.median(x)
    assert got == want or (np.isnan(got) and np.isnan(want))
    assert queries.QUERIES["MEDIAN"] is queries.median
    for q in (0.0, 0.1, 0.5, 0.99, 1.0):
        got, want = queries.quantile(x, q), ref_queries.quantile(x, q)
        assert got == want or (np.isnan(got) and np.isnan(want))


# --------------------------------------------------------------- refusals

def test_the_scan_refuses_a_baseline_as_the_reference_does():
    from repro.runtime.scan import ScanRuntime as RefScanRuntime
    d = dict(_golden("single_event_baseline_srs"), runtime="scan")
    scenario_level = "baseline method 'srs' needs runtime='event'"
    with pytest.raises(ValueError, match=scenario_level):
        RefScanRuntime.from_scenario(RefScenario.from_dict(d))
    with pytest.raises(ValueError, match=scenario_level):
        Experiment.from_scenario(ScenarioConfig.from_dict(d), device="cpu")
    # the runtime's own check, behind the scenario's
    from repro.runtime.scan import ScanRuntime as RefRuntime
    from repro_torch.core.types import PlannerConfig as Cfg
    from repro_torch.runtime.controller import CtrlParams
    from repro.runtime.controller import CtrlParams as RefCtrlParams
    with pytest.raises(ValueError, match="baselines need runtime='event'"):
        RefRuntime(cfg=RefPlannerConfig(), ctrl=RefCtrlParams(
            total_budget=1.0, n_sites=1, mode="static"), method="srs")
    with pytest.raises(ValueError, match="baselines need runtime='event'"):
        ScanRuntime(cfg=Cfg(), ctrl=CtrlParams(total_budget=1.0, n_sites=1,
                                               mode="static"),
                    method="srs", device="cpu")
    with pytest.raises(KeyError, match="unknown method 'reservoir'"):
        ScenarioConfig.from_dict(dict(d, method="reservoir"))
