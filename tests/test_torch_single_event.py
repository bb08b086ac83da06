"""The single-edge event path (``runtime="event"``, one edge) against the
live JAX reference, in-process on the CPU.

Each of the five ``single_event_*`` goldens the port runs is run by both
packages and its serialized reports diffed in the golden's own class
(``exact``): every counter and float equal.  Beside them, the same edge
with stragglers (``straggler_drop``) and with a one-site topology (its
link's WAN).  The goldens the port cannot run yet name their ROADMAP
item.

The reference's IPM needs ``jax.experimental.enable_x64``, which JAX 0.9
removed: the module fixture points it at ``jax.enable_x64`` while the
reference runs and removes it afterwards (ROADMAP.md queue 3, note a).
"""
import dataclasses
import json
import pathlib

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.sweep.report import serialize_report as ref_serialize
from repro_torch.api.experiment import Experiment, SingleEdgeRuntime
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.sweep.diff import diff_reports
from repro_torch.sweep.report import serialize_report

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
NAMES = ["single_event_cubic", "single_event_drop_gaps",
         "single_event_jitter_bandwidth", "single_event_latency_revise",
         "single_event_retransmit"]
# the live reference's WAN bytes (CPU, jax 0.9, the x64 workaround)
LIVE_WAN_BYTES = {"single_event_cubic": 4662,
                  "single_event_drop_gaps": 1554,
                  "single_event_jitter_bandwidth": 2496,
                  "single_event_latency_revise": 3736,
                  "single_event_retransmit": 10878}


def _scenario(name: str) -> dict:
    return json.loads((GOLDENS / f"{name}.json").read_text())


def _straggler(wid, i):
    return (wid + i) % 3 == 0


def _one_site(d: dict) -> dict:
    """The retransmit golden's edge behind a one-site topology: its link
    (latency, cost, drops, jitter, bandwidth) becomes the uplink."""
    return dict(d, transport={**d["transport"], "latency_ms": 0.0,
                              "drop_prob": 0.0},
                topology={"n_regions": 1, "sites_per_region": 1, "seed": 4,
                          "drop_prob": 0.3, "latency_scale": 1.0,
                          "jitter_ms": 40.0,
                          "bandwidth_bytes_per_ms": 20.0})


EXTRA = {"straggler": ("single_event_retransmit", None, _straggler),
         "one_site": ("single_event_cubic", _one_site, None)}


@pytest.fixture(scope="module")
def reference():
    """The live reference's serialized report of every case."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                  raising=False)
    out = {}
    try:
        for case in NAMES + sorted(EXTRA):
            name, change, drop = EXTRA.get(case, (case, None, None))
            g = _scenario(name)
            d = g["scenario"] if change is None else change(g["scenario"])
            rep = RefExperiment.from_scenario(RefScenario.from_dict(d),
                                              straggler_drop=drop).run()
            out[case] = (d, drop, g["tolerance"],
                         ref_serialize(rep, name=case,
                                       tolerance=g["tolerance"]))
    finally:
        patch.undo()
    return out


def _port(d, drop, name, tolerance):
    ex = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                  straggler_drop=drop, device="cpu")
    assert isinstance(ex.runtime, SingleEdgeRuntime)
    rep = ex.run()
    return rep, serialize_report(rep, name=name, tolerance=tolerance)


@pytest.mark.parametrize("case", NAMES + sorted(EXTRA))
def test_single_edge_event_run_is_the_live_reference(reference, case):
    d, drop, tolerance, want = reference[case]
    rep, got = _port(d, drop, case, tolerance)
    assert diff_reports(want, got) == []
    if case in LIVE_WAN_BYTES:
        assert got["counters"]["wan_bytes"] == LIVE_WAN_BYTES[case]
    raw = rep.raw
    assert raw["plan_seconds"] >= raw["device_seconds"] > 0
    assert raw["solve_seconds"] > 0


def test_the_x64_workaround_is_scoped(reference):
    """The module fixture restored JAX: its IPM raises again without the
    workaround, and the port never needed it."""
    assert reference
    assert not hasattr(jax.experimental, "enable_x64")


def test_a_cycled_pool_keeps_the_clock():
    """``run(n_windows=T)`` cycles the scenario's windows, each under its
    own window id, so no replayed window reads as a duplicate."""
    d = _scenario("single_event_cubic")["scenario"]
    ex = Experiment.from_scenario(ScenarioConfig.from_dict(d), device="cpu")
    rep = ex.run(n_windows=5)
    assert rep.duplicates == 0 and rep.gaps == 0
    assert np.asarray(rep.raw["window_age_ms"]).shape == (5,)
    with pytest.raises(ValueError, match="no carry"):
        ex.run(state=object())


@pytest.mark.parametrize("name,item", [
    ("fleet_event_sharded_static", "Sharding"),
    ("fleet_scan_sharded", "Sharding"),
])
def test_what_is_not_ported_names_its_item(name, item):
    """The last two goldens, ported by ROADMAP's ``item``, build on the
    sharded engine and runtime and are no longer listed as not ported."""
    from repro_torch.planning import ShardedEngine
    from repro_torch.runtime import ShardedScanRuntime
    from repro_torch.sweep import load_scenario_file, not_ported
    sc = ScenarioConfig.from_dict(_scenario(name)["scenario"])
    ex = Experiment.from_scenario(sc, device="cpu")
    if sc.runtime == "scan_sharded":
        assert isinstance(ex.runtime, ShardedScanRuntime)
    else:
        assert isinstance(ex.runtime.engine, ShardedEngine)
    assert not_ported(load_scenario_file(GOLDENS / f"{name}.json")) is None


def test_plain_links_and_clouds_are_upgraded(monkeypatch):
    """A ``SingleEdgeRuntime`` built from a plain ``Transport`` and
    ``CloudNode`` runs them on the event clock (``AsyncTransport.
    from_transport``) and mirrors the cloud's counters back, as the
    reference's does."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)
    from repro.api.experiment import SingleEdgeRuntime as RefRuntime
    from repro.core.types import PlannerConfig as RefPlannerConfig
    from repro.streaming.runtime import CloudNode as RefCloud
    from repro.streaming.runtime import EdgeNode as RefEdge
    from repro.streaming.runtime import Transport as RefTransport
    from repro_torch.core.types import PlannerConfig
    from repro_torch.streaming import AsyncTransport, CloudNode, EdgeNode
    from repro_torch.streaming import Transport
    d = _scenario("single_event_cubic")["scenario"]
    windows = RefExperiment.from_scenario(RefScenario.from_dict(d)) \
        .make_windows()
    ref_cloud = RefCloud(query_names=("AVG", "VAR"))
    RefRuntime(edge=RefEdge(cfg=RefPlannerConfig(seed=2),
                            budget_fraction=0.3),
               cloud=ref_cloud,
               transport=RefTransport(drop_prob=0.5, seed=3,
                                      latency_ms=1500.0)).run(windows)
    cloud = CloudNode(query_names=("AVG", "VAR"))
    rt = SingleEdgeRuntime(edge=EdgeNode(cfg=PlannerConfig(seed=2),
                                         budget_fraction=0.3, device="cpu"),
                           cloud=cloud,
                           transport=Transport(drop_prob=0.5, seed=3,
                                               latency_ms=1500.0))
    assert isinstance(rt.transport, AsyncTransport)
    assert rt.transport.latency_ms == 1500.0
    r = rt.run([dataclasses.replace(w, values=np.array(w.values))
                for w in windows])
    assert (cloud.gaps, cloud.windows_seen) == (ref_cloud.gaps,
                                                ref_cloud.windows_seen)
    assert r["wan_bytes"] == rt.transport.bytes_sent > 0
