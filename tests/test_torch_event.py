"""The port's fleet event loop against the live JAX reference.

Both packages run on the same numpy inputs, made from a seed, on the CPU.
The event loop is host numpy around two device calls (the plan and, under
``sampling="device"``, the samples), so everything here is held bitwise:

* ``water_fill`` and the host ``BudgetController`` (f64) over seeded
  sequences of ``budgets`` and ``update`` calls, in every mode;
* ``AsyncTransport`` and ``ReorderCloudNode`` on one seeded payload
  sequence: delivery times, counters and served reconstructions;
* ``FleetRuntime`` at small width, under host and device sampling: per-site
  WAN bytes and cost, budget history, the revised and at-query estimate
  tables, window ages and counters;
* adaptive re-planning and chaos on the event loop;
* the port's event loop fed the port's scan plans (the injected-plans
  harness of the reference's ``tests/test_scan_runtime.py``) against the
  port's scan report;
* the refusals of what the port cannot run yet.
"""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch

import repro.runtime.report as ref_report_mod
import repro_torch.runtime.report as report_mod
from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.core.types import CompactModel as RefModel
from repro.core.types import EdgePayload as RefPayload
from repro.fleet.controller import BudgetController as RefController
from repro.fleet.controller import water_fill as ref_water_fill
from repro.runtime.step import draw_fleet_samples as ref_draw
from repro.streaming.events import AsyncTransport as RefTransport
from repro.streaming.events import ReorderCloudNode as RefCloud
from repro.sweep.report import serialize_report as ref_serialize
from repro_torch.adaptive import AdaptivePolicy, AdaptiveSpec
from repro_torch.api.experiment import Experiment, FleetRuntime
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.core.types import CompactModel, EdgePayload
from repro_torch.fleet.controller import BudgetController, water_fill
from repro_torch.runtime.step import draw_fleet_samples
from repro_torch.streaming import AsyncTransport, ReorderCloudNode
from repro_torch.sweep.diff import diff_reports
from repro_torch.sweep.report import serialize_report

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
E, K, W = 8, 4, 64


def _golden(name: str) -> dict:
    return json.loads((GOLDENS / f"{name}.json").read_text())["scenario"]


def _same(a, b) -> None:
    """Bitwise, NaN-equal (and signed-zero-equal) array equality."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    if a.dtype.kind == "f":
        assert np.array_equal(np.signbit(a), np.signbit(b))


# ------------------------------------------------------------ controller

def _ctrl_kwargs(case: str, rng) -> dict:
    kw = dict(total_budget=0.3 * E * K * W, n_sites=E)
    if case == "static":
        kw["mode"] = "static"
    elif case in ("pred_err", "max_err"):
        kw["demand_signal"] = case
    elif case == "link_cost":
        kw.update(link_cost=rng.uniform(0.5, 3.0, E), cost_aware=True)
    elif case == "query_split":
        kw.update(query_split=0.3, tail_demand_signal="max_err",
                  link_cost=rng.uniform(0.5, 3.0, E), cost_aware=True)
    elif case == "capacity":
        kw["site_capacity"] = rng.uniform(20.0, 120.0, E)
    return kw


CTRL_CASES = ["static", "obs_err", "pred_err", "max_err", "link_cost",
              "query_split", "capacity", "arrival_lag", "live", "degenerate"]


@pytest.mark.parametrize("case", CTRL_CASES)
def test_budget_controller_matches_reference_bitwise(case):
    """Twelve windows of ``budgets`` then ``update``: every budget and every
    EWMA the reference's, bit for bit."""
    rng = np.random.default_rng(CTRL_CASES.index(case))
    kw = _ctrl_kwargs(case, rng)
    port, ref = BudgetController(**kw), RefController(**kw)
    for t in range(12):
        live = None
        if case == "live":
            live = rng.uniform(size=E) > 0.3
            if t == 5:
                live[:] = False          # an all-dead fleet ships nothing
            elif t == 6:
                live[:] = True           # all-live is the legacy path
        got, want = port.budgets(live=live), ref.budgets(live=live)
        _same(got, want)
        obs = rng.uniform(0.0, 0.3, E)
        obs[rng.integers(E)] = np.nan
        objective = rng.uniform(0.0, 2.0, E).astype(np.float32)
        r2 = rng.uniform(-0.2, 1.1, E).astype(np.float32)
        lag = tail = None
        if case == "arrival_lag":
            lag = rng.uniform(0.0, 90.0, E)
            lag[rng.uniform(size=E) > 0.6] = np.nan
        if case == "query_split":
            tail = rng.uniform(0.0, 0.5, E)
        if case == "degenerate":
            obs[:3] = np.inf
            obs[3:5] = 0.0
            objective = None if t % 2 else objective * 0.0
        args = dict(objective=objective, arrival_lag=lag,
                    obs_err_tail=tail, live=live)
        port.update(obs, r2, **args)
        ref.update(obs, r2, **args)
        for f in ("_demand", "_demand_tail", "_r2", "_lag", "_lag_seen"):
            _same(getattr(port, f), getattr(ref, f))
    _same(port.arrival_lag_ms, ref.arrival_lag_ms)
    _same(port.correlation_strength, ref.correlation_strength)


@pytest.mark.parametrize("case", ["plain", "inf", "all_zero", "tight_box",
                                  "negative"])
def test_water_fill_matches_reference_bitwise(case):
    rng = np.random.default_rng(3)
    d = rng.uniform(0.1, 5.0, 16)
    lo, hi = np.full(16, 10.0), np.full(16, 90.0)
    if case == "inf":
        d[[2, 7]] = np.inf
    elif case == "all_zero":
        d[:] = 0.0
    elif case == "tight_box":
        hi = rng.uniform(10.0, 30.0, 16)
    elif case == "negative":
        d[::3] = -1.0
    _same(water_fill(d, 640.0, lo, hi), ref_water_fill(d, 640.0, lo, hi))


# ------------------------------------------------------- transport, cloud

def _payloads(n: int, seed: int = 5):
    """The same seeded payload sequence in both packages' types."""
    rng = np.random.default_rng(seed)
    out = []
    for wid in range(n):
        nr = rng.integers(0, 20, K)
        ns = rng.integers(0, 30, K)
        pred = rng.integers(0, K, K)
        fields = dict(
            window_id=wid, n_real=nr, n_imputed=ns,
            real_values=[rng.standard_normal(int(m)).astype(np.float32)
                         for m in nr],
            mean_imputation=False, predictor=pred,
            stats_digest={"mean": rng.standard_normal(K).astype(np.float32),
                          "var": rng.uniform(0.5, 2, K).astype(np.float32)},
            sent_at_ms=wid * 100.0)
        model = dict(coeffs=rng.standard_normal((K, 4)).astype(np.float32),
                     loc=rng.standard_normal(K).astype(np.float32),
                     scale=rng.uniform(0.5, 2, K).astype(np.float32),
                     explained_var=rng.uniform(0, 1, K).astype(np.float32),
                     predictor=pred)
        out.append((EdgePayload(model=CompactModel(**model), **fields),
                    RefPayload(model=RefModel(**model), **fields)))
    return out


TRANSPORT_CASES = {
    "drops": dict(drop_prob=0.3, latency_ms=40.0),
    "jitter": dict(drop_prob=0.5, latency_ms=40.0, jitter_ms=300.0),
    "bandwidth": dict(latency_ms=40.0, bandwidth_bytes_per_ms=5.0),
    "retransmit_unarmed": dict(latency_ms=50.0, jitter_ms=40.0,
                               retransmit_timeout_ms=200.0, max_retries=3),
    "retransmit_armed": dict(drop_prob=0.4, latency_ms=200.0,
                             jitter_ms=400.0, retransmit_timeout_ms=150.0,
                             max_retries=3),
    "late_in_deadline": dict(latency_ms=150.0, jitter_ms=20.0),
    "late_past_deadline": dict(latency_ms=150.0, jitter_ms=200.0),
    "duplicates": dict(latency_ms=300.0, retransmit_timeout_ms=100.0,
                       max_retries=2),
}


def _drive(transport_cls, cloud_cls, case: str, pick: int) -> list:
    """Send 30 windows a period apart, answer each window's query at its
    due time, drain the rest; the trace of every event and answer."""
    kw = TRANSPORT_CASES[case]
    deadline = 80.0 if case.startswith("late") else math.inf
    t = transport_cls(seed=9, **kw)
    c = cloud_cls(query_names=("AVG", "VAR"), window_period_ms=100.0,
                  deadline_ms=deadline)
    trace = []

    def ingest(until):
        for ev in t.drain(until):
            out = c.ingest_event(ev.payload, now_ms=ev.at_ms)
            rec = [] if out.reconstruction is None else out.reconstruction
            trace.append(("event", ev.at_ms, ev.seq, out.kind,
                          out.window_id, out.staleness_ms,
                          [r.tobytes() for r in rec]))

    for wid, pair in enumerate(_payloads(30)):
        p = pair[pick]
        sent = t.send(p, now_ms=wid * 100.0)
        trace.append(("sent", wid, sent is None, t.in_flight))
        ingest(wid * 100.0 + 100.0)
        rec, age, served = c.serve(wid, wid * 100.0 + 100.0)
        trace.append(("serve", wid, age, served,
                      {q: v.tobytes() for q, v in c.query(rec).items()}))
    ingest(math.inf)
    missing = c.finalize(30)
    trace.append(("counters", t.bytes_sent, t.bytes_cost, t.payloads_sent,
                  t.payloads_dropped, t.retransmits, t.latency_total_ms,
                  c.gaps, c.revisions, c.late_drops, c.duplicates,
                  c.stale_serves, c.windows_seen, missing))
    return trace


def _nan_safe(trace):
    return json.dumps(trace, default=repr).replace("NaN", "nan")


@pytest.mark.parametrize("case", sorted(TRANSPORT_CASES))
def test_transport_and_cloud_match_reference_bitwise(case):
    got = _drive(AsyncTransport, ReorderCloudNode, case, 0)
    want = _drive(RefTransport, RefCloud, case, 1)
    assert _nan_safe(got) == _nan_safe(want)
    (_, _, _, _, dropped, retransmits, _, _, revisions, late_drops,
     duplicates, _, _, _) = got[-1]
    if case == "retransmit_armed":
        assert retransmits > 0 and dropped > 0
    if case == "late_in_deadline":
        assert revisions > 0 and late_drops == 0
    if case == "late_past_deadline":
        assert late_drops > 0
    if case == "duplicates":
        assert duplicates == retransmits == 2 * 30


def test_jitter_never_moves_the_drop_sequence():
    """The jitter generator is its own stream: the drops of a jittered link
    are the drops of the same link without jitter (the reference's
    ``test_jitter_rng_does_not_perturb_drop_sequence``), in both packages."""
    pairs = _payloads(40)
    drops = {}
    for name, cls in (("port", AsyncTransport), ("ref", RefTransport)):
        for jitter in (0.0, 300.0):
            t = cls(seed=4, drop_prob=0.5, jitter_ms=jitter)
            drops[name, jitter] = [
                t.send(pairs[w][name == "ref"], now_ms=w * 100.0) is None
                for w in range(40)]
    assert len({tuple(v) for v in drops.values()}) == 1


def test_retransmits_under_jitter_are_deterministic_and_the_reference():
    """Retransmit attempts draw their drop again and their own jitter: two
    runs give the same schedule, and it is the reference's."""
    runs = [_drive(AsyncTransport, ReorderCloudNode, "retransmit_armed", 0)
            for _ in range(2)]
    assert _nan_safe(runs[0]) == _nan_safe(runs[1])
    assert _nan_safe(runs[0]) == _nan_safe(
        _drive(RefTransport, RefCloud, "retransmit_armed", 1))


# ---------------------------------------------------------- fleet runtime

def _scenario(**change) -> dict:
    d = {
        "data": {"dataset": "fleet", "n_points": 4 * W, "window": W,
                 "seed": 1, "options": {"k": K}},
        "planner": {"solver": "closed_form", "seed": 3},
        "topology": {"n_regions": 2, "sites_per_region": E // 2, "seed": 1},
        "controller": {"mode": "rebalance"},
        "queries": ["AVG", "VAR"],
        "budget_fraction": 0.3,
        "runtime": "event",
    }
    for key, v in change.items():
        d[key] = dict(d.get(key) or {}, **v) if isinstance(v, dict) else v
    return d


def _straggler(wid, s, i):
    return s == 2 and i == 1 or (wid + s + i) % 11 == 0


FLEET_CASES = {
    # tests/test_fleet.py::test_fleet_experiment_with_faults, widened
    "drops_stragglers": (_scenario(topology={"drop_prob": 0.5}), _straggler),
    # tests/test_async_transport.py: links of 30-60 ms, a 20 ms period
    "hetero_latency": (_scenario(topology={"latency_scale": 1.0},
                                 transport={"window_period_ms": 20.0}),
                       None),
    "retransmit": (_scenario(topology={"drop_prob": 0.3, "jitter_ms": 30.0,
                                       "bandwidth_bytes_per_ms": 5.0},
                             transport={"window_period_ms": 100.0,
                                        "retransmit_timeout_ms": 150.0,
                                        "max_retries": 3,
                                        "staleness_deadline_ms": 250.0}),
                   None),
    "query_split": (_scenario(controller={"query_split": 0.3},
                              topology={"latency_scale": 0.0}), None),
}


def _spy(module, monkeypatch) -> dict:
    """Capture the tables ``FleetRuntime.run`` hands to ``aggregate_fleet``."""
    seen = {}
    real = module.aggregate_fleet

    def spy(**kw):
        seen.update(kw)
        return real(**kw)

    monkeypatch.setattr(module, "aggregate_fleet", spy)
    return seen


def _run_both(d, straggler, sampling, monkeypatch):
    ref_ex = RefExperiment.from_scenario(RefScenario.from_dict(d),
                                         straggler_drop=straggler)
    windows = ref_ex.make_windows()
    port_ex = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                       straggler_drop=straggler,
                                       device="cpu")
    assert isinstance(port_ex.runtime, FleetRuntime)
    ref_ex.runtime.sampling = port_ex.runtime.sampling = sampling
    seen_ref = _spy(ref_report_mod, monkeypatch)
    seen_port = _spy(report_mod, monkeypatch)
    rep_ref = ref_ex.run(windows)
    rep = port_ex.run(windows)
    return rep, rep_ref, seen_port, seen_ref, port_ex, ref_ex


def _assert_same_tables(seen, seen_ref):
    for key in ("est", "est_q", "tru"):
        assert seen[key].keys() == seen_ref[key].keys()
        for q in seen[key]:
            _same(seen[key][q], seen_ref[key][q])
    for key in ("ages", "bytes_per_site", "cost_per_site", "budget_history",
                "arrival_lag_ms"):
        _same(seen[key], seen_ref[key])
    for key in ("gaps", "revisions", "late_drops", "duplicates",
                "retransmits", "plan_windows", "total_tuples"):
        assert seen[key] == seen_ref[key], key


@pytest.mark.parametrize("sampling", ["host", "device"])
@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_fleet_runtime_matches_reference_bitwise(case, sampling,
                                                 monkeypatch):
    d, straggler = FLEET_CASES[case]
    rep, rep_ref, seen, seen_ref, _, _ = _run_both(d, straggler, sampling,
                                                   monkeypatch)
    _assert_same_tables(seen, seen_ref)
    assert rep.wan_bytes == rep_ref.wan_bytes
    assert rep.wan_cost == rep_ref.wan_cost
    assert rep.nrmse == rep_ref.nrmse
    assert rep.freshness_ms == rep_ref.freshness_ms
    for q in rep.nrmse_per_stream:
        _same(rep.nrmse_per_stream[q], rep_ref.nrmse_per_stream[q])
    # the fault each case is about is real
    if case == "drops_stragglers":
        assert rep.gaps > 0
    if case == "hetero_latency":
        assert rep.revisions >= 1 and rep.freshness_ms["p99_ms"] > 0
    if case == "retransmit":
        assert rep.retransmits > 0


def test_device_samples_are_the_reference_s():
    rng = np.random.default_rng(4)
    values = rng.standard_normal((E, K, W)).astype(np.float32)
    n_real = rng.integers(0, W + 1, (E, K)).astype(np.int32)
    got = draw_fleet_samples(7, 3, values, n_real, device="cpu")
    _same(got, np.asarray(ref_draw(7, 3, values, n_real)))


# ----------------------------------------------------- adaptive and chaos

@pytest.fixture(scope="module")
def adaptive_golden():
    d = _golden("fleet_event_adaptive_threshold")
    ref = RefExperiment.from_scenario(RefScenario.from_dict(d)).run()
    port = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                    device="cpu").run()
    return port, ref


def test_adaptive_threshold_golden_counters_are_the_reference_s(
        adaptive_golden):
    port, ref = adaptive_golden
    keys = ("planner_invocations", "plans_reused", "drift_fires",
            "detection_lag_windows", "plan_windows")
    assert {k: port.raw[k] for k in keys} == {k: ref.raw[k] for k in keys}
    assert port.raw["planner_invocations"] == 6
    assert port.wan_bytes == ref.wan_bytes == 21264
    _same(port.raw["budget_history"], ref.raw["budget_history"])


def test_always_detector_is_the_plain_event_loop(monkeypatch):
    d, straggler = FLEET_CASES["drops_stragglers"]
    plain = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                     straggler_drop=straggler, device="cpu")
    windows = plain.make_windows()
    seen = _spy(report_mod, monkeypatch)
    r0 = plain.run(windows)
    t0 = dict(seen)
    adapt = Experiment.from_scenario(
        ScenarioConfig.from_dict(dict(d, adaptive={"detector": "always"})),
        straggler_drop=straggler, device="cpu")
    r1 = adapt.run(windows)
    _assert_same_tables(seen, t0)
    assert r1.wan_bytes == r0.wan_bytes and r1.nrmse == r0.nrmse
    assert r1.raw["planner_invocations"] == len(windows)
    assert r1.raw["plans_reused"] == 0


def test_adaptive_policy_reuses_the_cached_plan_itself():
    rng = np.random.default_rng(2)
    values = rng.standard_normal((3, K, 32)).astype(np.float32)
    counts = np.full((3, K), 32)
    pol = AdaptivePolicy(AdaptiveSpec(detector="never"), device="cpu")
    made = []

    def plan_cb():
        made.append({"n_real": np.ones((3, K))})
        return made[-1]

    plans = [pol.step(values, counts, plan_cb) for _ in range(4)]
    assert len(made) == 1
    assert all(p is made[0] for p, _ in plans)
    assert [r for _, r in plans] == [True, False, False, False]
    assert pol.counters()["plans_reused"] == 3


def _chaos_scenario(chaos):
    return _scenario(data={"n_points": 8 * W},
                     topology={"sites_per_region": 3}, chaos=chaos)


@pytest.mark.parametrize("chaos,site,seen_windows,down,stale", [
    ({"flaps": [[3, 1, "down"]]}, 1, 3, 5, 5),    # dark from window 3 on
    ({"joins": [[5, 2]]}, 2, 3, 5, 0),           # silent before window 5
])
def test_chaos_on_the_event_loop_is_the_reference_s(chaos, site,
                                                    seen_windows, down,
                                                    stale, monkeypatch):
    """A dark site ships nothing and is gap-served from its last window; a
    joining site is silent before its join (the reference's
    ``tests/test_chaos.py`` cases), with every table the reference's."""
    d = _chaos_scenario(chaos)
    rep, rep_ref, seen, seen_ref, ex, ex_ref = _run_both(d, None, "host",
                                                         monkeypatch)
    _assert_same_tables(seen, seen_ref)
    rt = ex.runtime
    assert rt.clouds[site].windows_seen == seen_windows
    assert rt.clouds[site].stale_serves == stale
    assert rep.raw["down_site_windows"] == down
    assert rep.raw["gap_served_cells"] == stale
    assert rep.raw["liveness"].shape == (8, 6)
    for k in ("down_site_windows", "gap_served_cells", "recovery_windows"):
        assert rep.raw[k] == rep_ref.raw[k]
    for k in ("availability_by_region", "outage_nrmse", "steady_nrmse"):
        assert json.dumps(rep.raw[k], sort_keys=True) == \
            json.dumps(rep_ref.raw[k], sort_keys=True)
    if "flaps" in chaos:
        assert rt.transports[site].bytes_sent < rt.transports[0].bytes_sent


# ---------------------------------------------- injected plans (the port)

class _InjectedPlans:
    """An engine serving the scan's own per-window plan arrays to the event
    loop: given the same plans, every byte and estimate goes through the
    event loop's host code, so the reports must be equal bit for bit."""

    name = "injected"

    def __init__(self, ys):
        self.fields = ("r2", "objective", "n_real", "n_imputed", "predictor",
                       "coeffs", "loc", "scale", "explained_var", "mean",
                       "var")
        self.ys = ys

    def check(self, cfg):
        pass

    def plan_fleet(self, values, counts, budgets, cfg, *, window_id, **kw):
        return {f: np.asarray(self.ys[f][window_id]) for f in self.fields}


def test_event_loop_reproduces_the_port_scan_given_its_plans():
    """Zero-latency links, a static controller, device sampling: the event
    loop fed the scan's plans gives the scan's report."""
    d = _scenario(topology={"latency_scale": 0.0},
                  controller={"mode": "static"},
                  queries=["AVG", "VAR", "MIN", "MAX"])
    scan = Experiment.from_scenario(
        ScenarioConfig.from_dict(dict(d, runtime="scan")), device="cpu")
    windows = scan.make_windows()
    stash = {}
    replay = scan.runtime._replay

    def spy(ys, *a, **kw):
        stash["ys"] = ys
        return replay(ys, *a, **kw)

    scan.runtime._replay = spy
    rep_s = scan.run(windows)
    ev = Experiment.from_scenario(ScenarioConfig.from_dict(d), device="cpu")
    ev.runtime.sampling = "device"
    ev.runtime.engine = _InjectedPlans(stash["ys"])
    rep_e = ev.run(windows)
    assert rep_e.wan_bytes == rep_s.wan_bytes
    assert rep_e.wan_cost == rep_s.wan_cost
    for q in ("AVG", "VAR", "MIN", "MAX"):
        _same(rep_e.nrmse_per_stream[q], rep_s.nrmse_per_stream[q])
    _same(np.asarray(rep_e.raw["budget_history"], np.float32),
          np.asarray(rep_s.raw["budget_history"], np.float32))


# -------------------------------------------------------------- refusals

@pytest.mark.parametrize("change,item", [
    ({"planner": {"engine": "sharded"}}, "Sharding"),
])
def test_what_the_event_loop_cannot_run_names_its_item(change, item):
    """Nothing is left: the engine ROADMAP's ``item`` ported runs in the
    event loop, bitwise the batched engine's run (world size 1)."""
    sc = ScenarioConfig.from_dict(_scenario(**change))
    ex = Experiment.from_scenario(sc, device="cpu")
    assert ex.runtime.engine.name == change["planner"]["engine"]
    got = serialize_report(ex.run(), name=item, tolerance="exact")
    want = serialize_report(Experiment.from_scenario(ScenarioConfig.from_dict(
        _scenario()), device="cpu").run(), name=item, tolerance="exact")
    assert diff_reports(want, got) == []


@pytest.mark.parametrize("change", [
    {"topology": None, "data": {"dataset": "turbine", "n_points": 256,
                                "window": 64, "seed": 1, "options": {}},
     "planner": {"iid_mode": "thinning"}},
    {"planner": {"engine": "host"}},
    {"method": "srs"},                   # a fleet plans with planner.model
], ids=["thinning", "host_engine", "fleet_ignores_method"])
def test_what_the_event_loop_runs_since_slice_12_is_the_reference_s(change):
    d = _scenario(**change)
    want = ref_serialize(RefExperiment.from_scenario(
        RefScenario.from_dict(d)).run(), name="x", tolerance="exact")
    got = serialize_report(Experiment.from_scenario(
        ScenarioConfig.from_dict(d), device="cpu").run(), name="x",
        tolerance="exact")
    assert diff_reports(want, got) == []


def test_a_fleet_needs_the_host_engine_for_a_host_only_solver():
    d = _scenario(planner={"solver": "ipm"})
    msg = "solver 'ipm' is host-only"
    with pytest.raises(ValueError, match=msg):
        RefExperiment.from_scenario(RefScenario.from_dict(d))
    with pytest.raises(ValueError, match=msg):
        Experiment.from_scenario(ScenarioConfig.from_dict(d), device="cpu")


def test_the_scan_refuses_stragglers_and_the_query_split():
    scan = _scenario(topology={"latency_scale": 0.0}, runtime="scan")
    with pytest.raises(ValueError, match="straggler_drop needs"):
        Experiment.from_scenario(ScenarioConfig.from_dict(scan),
                                 straggler_drop=_straggler, device="cpu")
    split = dict(scan, controller={"query_split": 0.3})
    with pytest.raises(ValueError, match="per-query controller split"):
        Experiment.from_scenario(ScenarioConfig.from_dict(split),
                                 device="cpu")
    ev = Experiment.from_scenario(ScenarioConfig.from_dict(_scenario()),
                                  device="cpu")
    with pytest.raises(ValueError, match="no carry"):
        ev.run(state=object())


def test_event_dataclass_fields_follow_the_reference():
    """The port's FleetRuntime takes the reference's knobs (``device`` in
    place of ``interpret``)."""
    from repro.api.experiment import FleetRuntime as RefFleetRuntime
    ref = {f.name for f in dataclasses.fields(RefFleetRuntime)}
    port = {f.name for f in dataclasses.fields(FleetRuntime)}
    assert port == ref - {"interpret"} | {"device"}
