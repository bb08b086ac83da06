"""The port's adaptive re-planning against the live JAX reference.

Every comparison runs both packages on the same numpy inputs, made from
a seed.  The drift gate decides through f32 arithmetic and its counters
are held bitwise, so everything the gate carries is held bitwise too: the
EW sums, the correlation snapshot, the detector scalars.  The port gets
there by evaluating the reference's compiled order (the Gram in four
multiply-add chains, ``decay * acc + sums`` as one fused multiply-add,
the correlation's merged division; ``repro_torch.adaptive.stats``).

The adaptive golden (``fleet_scan_adaptive_ph``) is held to the live
reference's WAN bytes, byte and budget histories and counters bitwise,
and its NRMSE tables to its ``f32`` class.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adaptive import AdaptiveSpec as RefSpec
from repro.adaptive import drift as ref_drift
from repro.adaptive import gate_init as ref_gate_init
from repro.adaptive import gate_update as ref_gate_update
from repro.adaptive import stats as ref_ew
from repro.api.experiment import Experiment as RefExperiment
from repro.api.registry import UnknownComponentError as RefUnknown
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.data.streams import fleet_like as ref_fleet_like
from repro.sweep.diff import TOLERANCE_CLASSES
from repro_torch.adaptive import (AdaptiveSpec, EWStats, GateState,
                                  det_init, detector_update, ew_corr, ew_cov,
                                  ew_decay, ew_from_dict, ew_init,
                                  ew_to_dict, ew_update, gate_counters,
                                  gate_init, gate_update, window_sums)
from repro_torch.api.experiment import Experiment
from repro_torch.api.registry import UnknownComponentError
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.core.stats import corr_from_sums
from repro_torch.data.streams import fleet_like, fleet_windows
from repro_torch.runtime.state import state_from_numpy

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

F32 = TOLERANCE_CLASSES["f32"]
GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
GOLDEN = "fleet_scan_adaptive_ph"
# the live reference on the golden (CPU, jax 0.9)
LIVE_WAN_BYTES = 21096
LIVE_COUNTERS = {"planner_invocations": 6, "plans_reused": 6,
                 "drift_fires": 7}


def _golden(**adaptive) -> dict:
    d = json.loads((GOLDENS / f"{GOLDEN}.json").read_text())["scenario"]
    if adaptive:
        d["adaptive"] = dict(d["adaptive"], **adaptive)
    return d


def _golden_windows() -> np.ndarray:
    """The golden's 12 windows, (T, E, k, N) f32."""
    d = _golden()
    data, topo = d["data"], d["topology"]
    vals, _ = fleet_like(n_sites=topo["n_regions"] * topo["sites_per_region"],
                         n_regions=topo["n_regions"],
                         n_points=data["n_points"], seed=data["seed"],
                         window=data["window"], **data["options"])
    return np.stack(fleet_windows(vals, data["window"]))


def _random_windows(e, k, n, windows, seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(50.0, 5.0, (windows, e, k, n)).astype(np.float32)
    return vals, np.full((windows, e, k), n, np.int32)


def _bits(x) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref) -> bool:
    p = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    return np.array_equal(_bits(p), _bits(ref))


def _ref_spec(spec: AdaptiveSpec) -> RefSpec:
    return RefSpec(**spec.to_dict())


# ------------------------------------------------------------ EW estimator

@pytest.mark.parametrize("halflife", [None, 12.0, 3.0])
@pytest.mark.parametrize("shape", [(3, 5, 130), (6, 4, 64), (2, 8, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ew_update_matches_reference_bitwise(shape, halflife):
    vals, counts = _random_windows(*shape, windows=5, seed=sum(shape))
    counts[2, 0, 1] = shape[2] // 2          # one ragged stream
    ref = ref_ew.ew_init(*shape[:2])
    port = ew_init(*shape[:2], device="cpu")
    d = ew_decay(halflife)
    assert d == ref_ew.ew_decay(halflife)
    # jitted, as both of the reference's runtimes run the gate
    ref_update = jax.jit(ref_ew.ew_update, static_argnums=3)
    for v, c in zip(vals, counts):
        ref = ref_update(ref, jnp.asarray(v), jnp.asarray(c), d)
        port = ew_update(port, torch.as_tensor(v), torch.as_tensor(c), d)
    for f in ("weight", "s1", "s2", "xxt"):
        assert _same(getattr(port, f), getattr(ref, f)), f
    assert _same(ew_corr(port), jax.jit(ref_ew.ew_corr)(ref))
    assert _same(ew_cov(port), jax.jit(ref_ew.ew_cov)(ref))


def test_ew_decay_one_equals_the_batch_sums_bitwise():
    vals, counts = _random_windows(3, 4, 64, windows=4, seed=5)
    state = ew_init(3, 4, device="cpu")
    cf = s1 = s2 = xxt = 0.0
    for v, c in zip(vals, counts):
        v, c = torch.as_tensor(v), torch.as_tensor(c)
        state = ew_update(state, v, c, ew_decay(None))
        dc, d1, d2, dx = window_sums(v, c)
        cf, s1, s2, xxt = cf + dc, s1 + d1, s2 + d2, xxt + dx
    for got, want in ((state.weight, cf), (state.s1, s1), (state.s2, s2),
                      (state.xxt, xxt)):
        assert torch.equal(got, want)
    mom = torch.stack([s1, s2, torch.zeros_like(s1), torch.zeros_like(s1)],
                      dim=-1)
    assert torch.equal(ew_corr(state), corr_from_sums(mom, xxt, cf))


def test_ew_dict_round_trip_bitwise():
    vals, counts = _random_windows(2, 3, 16, windows=3, seed=9)
    state = ew_init(2, 3, device="cpu")
    for v, c in zip(vals, counts):
        state = ew_update(state, torch.as_tensor(v), torch.as_tensor(c),
                          ew_decay(4.0))
    d = json.loads(json.dumps(ew_to_dict(state)))
    back = ew_from_dict(d, device="cpu")
    for f in dataclasses.fields(EWStats):
        assert torch.equal(getattr(back, f.name), getattr(state, f.name))
    # the reference reads the same dict to the same buffers
    ref = ref_ew.ew_from_dict(d)
    for f in dataclasses.fields(EWStats):
        assert _same(getattr(back, f.name), getattr(ref, f.name))
    with pytest.raises(ValueError, match="halflife"):
        ew_decay(0.0)


# --------------------------------------------------------------- detectors

@pytest.mark.parametrize("name", ["threshold", "page_hinkley", "always",
                                  "never"])
def test_detectors_match_reference_bitwise(name):
    spec = AdaptiveSpec(detector=name, threshold=0.1, ph_delta=0.02,
                        ph_lambda=0.3)
    rspec = _ref_spec(spec)
    rng = np.random.default_rng(3)
    devs = np.concatenate([rng.uniform(0.0, 0.06, 8),
                           rng.uniform(0.05, 0.3, 12),
                           np.float32([0.1, 0.02, 0.3, 0.0])])
    devs = devs.astype(np.float32)
    st, rst = det_init(device="cpu"), ref_drift.det_init()
    for dv in devs:
        st, fire, lag = detector_update(name, st, torch.tensor(dv), spec)
        rst, rfire, rlag = ref_drift.detector_update(name, rst,
                                                     jnp.float32(dv), rspec)
        assert _same(st["accum"], rst["accum"])
        assert int(st["age"]) == int(rst["age"])
        assert bool(fire) == bool(rfire) and int(lag) == int(rlag)
    with pytest.raises(UnknownComponentError, match="page_hinkley"):
        detector_update("cusum", st, torch.tensor(0.0), spec)


# ------------------------------------------------------------------- gate

@pytest.mark.parametrize("adaptive", [
    {},                                            # the golden's page_hinkley
    {"detector": "threshold", "threshold": 0.05},
    {"detector": "always", "min_replan_interval": 1},
    {"detector": "never"},
    {"halflife": None, "min_replan_interval": 1},
], ids=["golden", "threshold", "always", "never", "no_decay"])
def test_gate_update_matches_reference_bitwise(adaptive):
    spec = AdaptiveSpec.from_dict(_golden(**adaptive)["adaptive"])
    rspec = _ref_spec(spec)
    wins = _golden_windows()
    t, e, k, n = wins.shape
    counts = np.full((e, k), n, np.int32)
    step = jax.jit(lambda g, v, c: ref_gate_update(rspec, g, v, c))
    gate, rgate = gate_init(e, k, device="cpu"), ref_gate_init(e, k)
    for w in wins:
        gate, replan = gate_update(spec, gate, torch.as_tensor(w),
                                   torch.as_tensor(counts))
        rgate, rreplan = step(rgate, jnp.asarray(w), jnp.asarray(counts))
        assert bool(replan) == bool(rreplan)
        for f in dataclasses.fields(GateState):
            if f.name != "ew":
                assert _same(getattr(gate, f.name),
                             getattr(rgate, f.name)), f.name
        for f in dataclasses.fields(EWStats):
            assert _same(getattr(gate.ew, f.name),
                         getattr(rgate.ew, f.name)), f.name
    assert gate_counters(gate) == {
        "planner_invocations": int(rgate.replans),
        "plans_reused": int(rgate.reuses), "drift_fires": int(rgate.fires),
        "detection_lag_windows": (float(int(rgate.lag_sum))
                                  / int(rgate.lag_events)
                                  if int(rgate.lag_events) else 0.0)}


# ------------------------------------------------- spec and scenario checks

@pytest.mark.parametrize("bad", [
    {"halflife": 0.0}, {"halflife": -2.0}, {"threshold": 0.0},
    {"ph_delta": -0.1}, {"ph_lambda": 0.0}, {"min_replan_interval": 0},
])
def test_adaptive_spec_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as ref_exc:
        RefSpec(**bad)
    with pytest.raises(ValueError) as exc:
        AdaptiveSpec(**bad)
    assert str(exc.value) == str(ref_exc.value)


def test_adaptive_spec_round_trip_and_names():
    spec = AdaptiveSpec(detector="page_hinkley", halflife=None,
                        ph_delta=0.03, min_replan_interval=3)
    d = json.loads(json.dumps(spec.to_dict()))
    assert AdaptiveSpec.from_dict(d) == spec
    assert d == RefSpec.from_dict(d).to_dict()
    with pytest.raises(ValueError, match="unknown AdaptiveSpec fields"):
        AdaptiveSpec.from_dict({**d, "window": 3})
    with pytest.raises(UnknownComponentError, match="never"):
        AdaptiveSpec(detector="cusum")
    with pytest.raises(RefUnknown):
        RefSpec(detector="cusum")


def _single_edge(d):
    d["topology"] = None
    d["data"] = {"dataset": "smartcity", "n_points": 256, "window": 64}


def _host_engine(d):
    d["planner"] = dict(d["planner"], engine="host_loop")


def _chaos(d):
    d["chaos"] = {"joins": [[3, 1]]}


def _trivial_chaos(d):
    d["chaos"] = {}


@pytest.mark.parametrize("change,match", [
    (_single_edge, "fleet topology"), (_host_engine, "host"),
    (_chaos, "cannot be combined"), (_trivial_chaos, None),
], ids=["single_edge", "host_engine", "chaos", "trivial_chaos"])
def test_scenario_refusals_match_the_reference(change, match):
    d = _golden()
    change(d)
    if match is None:                     # a trivial chaos spec is fine
        RefScenario.from_dict(d)
        assert ScenarioConfig.from_dict(d).adaptive == \
            AdaptiveSpec.from_dict(d["adaptive"])
        return
    with pytest.raises(ValueError, match=match):
        RefScenario.from_dict(d)
    with pytest.raises(ValueError, match=match):
        ScenarioConfig.from_dict(d)


# ----------------------------------------------------- drifting generator

def test_fleet_like_schedule_is_bitwise_the_reference():
    d = _golden()["data"]
    kw = dict(n_sites=6, n_regions=2, k=4, n_points=d["n_points"],
              seed=d["seed"], window=d["window"],
              strength_schedule=d["options"]["strength_schedule"])
    got, meta = fleet_like(**kw)
    want, rmeta = ref_fleet_like(**kw)
    assert _same(got, want)
    assert meta["strength_schedule"] == rmeta["strength_schedule"]
    # a degenerate schedule is the unscheduled generator, bitwise
    flat, _ = fleet_like(n_sites=6, n_regions=2, k=4, n_points=512, seed=4,
                         window=64,
                         strength_schedule=[(0, np.linspace(0.9, 0.15, 2))])
    plain, _ = fleet_like(n_sites=6, n_regions=2, k=4, n_points=512, seed=4)
    assert _same(flat, plain)


@pytest.mark.parametrize("kw,match", [
    ({"strength_schedule": [(0, [0.9, 0.15])]}, "window"),
    ({"window": 64, "strength_schedule": [(0, [0.9])]}, "per region"),
    ({"window": 64, "strength_schedule": [(-1, [0.9, 0.15])]}, ">= 0"),
])
def test_fleet_like_schedule_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        ref_fleet_like(4, 2, 3, n_points=256, **kw)
    with pytest.raises(ValueError, match=match):
        fleet_like(4, 2, 3, n_points=256, **kw)


# ------------------------------------------------------------- end to end

RUNS = {"golden": {}, "always": {"detector": "always",
                                 "min_replan_interval": 1},
        "never": {"detector": "never"}}


@pytest.fixture(scope="module")
def runs():
    """The live reference and the port on the golden, under its own
    detector and under always (interval 1) and never."""
    out = {}
    for name, adaptive in RUNS.items():
        d = _golden(**adaptive)
        out[name] = (
            RefExperiment.from_scenario(RefScenario.from_dict(d)).run(),
            Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                     device="cpu").run())
    d = _golden()
    del d["adaptive"]
    out["plain"] = (None, Experiment.from_scenario(
        ScenarioConfig.from_dict(d), device="cpu").run())
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_adaptive_scan_matches_live_reference(runs, name):
    ref, port = runs[name]
    assert port.wan_bytes == ref.wan_bytes
    if name == "golden":
        assert port.wan_bytes == LIVE_WAN_BYTES
        assert {k: port.raw[k] for k in LIVE_COUNTERS} == LIVE_COUNTERS
    for k in ("planner_invocations", "plans_reused", "drift_fires",
              "detection_lag_windows", "plan_windows"):
        assert port.raw[k] == ref.raw[k], k
    for k in ("bytes_history", "budget_history"):
        assert np.array_equal(np.asarray(port.raw[k]),
                              np.asarray(ref.raw[k])), k
    rtol, atol = F32
    for q, table in ref.nrmse_per_stream.items():
        np.testing.assert_allclose(port.nrmse_per_stream[q], table,
                                   rtol=rtol, atol=atol)


def test_always_replans_every_window_and_never_once(runs):
    _, always = runs["always"]
    _, plain = runs["plain"]
    T = len(always.raw["bytes_history"])
    assert always.raw["planner_invocations"] == T
    assert always.raw["plans_reused"] == 0
    for k in ("bytes_history", "budget_history"):
        assert np.array_equal(always.raw[k], plain.raw[k])
    for q in plain.nrmse_per_stream:
        assert np.array_equal(always.nrmse_per_stream[q],
                              plain.nrmse_per_stream[q])
    _, never = runs["never"]
    assert never.raw["planner_invocations"] == 1
    assert never.raw["plans_reused"] == T - 1
    assert never.raw["drift_fires"] == 0


def test_resume_from_the_reference_carry_is_bitwise(runs):
    """The reference runs the golden's first windows; its carry (gate, EW
    sums, cached plan) comes across through ``state_from_numpy`` and the
    port finishes the run: bitwise the port's uninterrupted run."""
    _, full = runs["golden"]
    d = _golden()
    ref_ex = RefExperiment.from_scenario(RefScenario.from_dict(d))
    windows = ref_ex.make_windows()
    cut = 5
    head = ref_ex.runtime.run(windows, n_windows=cut)
    carry = jax.tree.map(np.asarray, head["final_state"])
    state = state_from_numpy(carry, device="cpu")
    assert state.adaptive is not None and state.window_id == cut
    ex = Experiment.from_scenario(ScenarioConfig.from_dict(d), device="cpu")
    tail = ex.runtime.run([np.asarray(w) for w in windows],
                          n_windows=len(windows) - cut, state=state)
    assert head["wan_bytes"] + tail["wan_bytes"] == full.wan_bytes
    for k in ("bytes_history", "budget_history"):
        assert np.array_equal(tail[k], full.raw[k][cut:]), k
    for k in ("planner_invocations", "plans_reused", "drift_fires"):
        assert tail[k] == full.raw[k], k
    end = full.raw["final_state"].adaptive.gate
    got = tail["final_state"].adaptive.gate
    for f in dataclasses.fields(GateState):
        if f.name != "ew":
            assert torch.equal(getattr(got, f.name), getattr(end, f.name))


def test_a_chaos_carry_still_raises():
    """A reference chaos carry now comes across (tests/test_torch_chaos.py
    resumes one); an object that is not one still raises."""
    import types
    d = _golden()
    del d["adaptive"]
    d["chaos"] = {"joins": [[2, 0]]}
    sc = RefScenario.from_dict(d)
    windows = RefExperiment.from_scenario(sc).make_windows()
    head = RefExperiment.from_scenario(sc).runtime.run(windows, n_windows=2)
    carry = jax.tree.map(np.asarray, head["final_state"])
    state = state_from_numpy(carry, device="cpu")
    assert torch.equal(state.chaos.live, torch.as_tensor(
        np.array(carry.chaos.live)))
    assert sorted(state.chaos.served) == sorted(carry.chaos.served)
    broken = types.SimpleNamespace(**{f: getattr(carry, f) for f in
                                      ("window_id", "controller", "totals",
                                       "adaptive")}, chaos=object())
    with pytest.raises(AttributeError):
        state_from_numpy(broken, device="cpu")
