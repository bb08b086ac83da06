"""Variants of the fleet scan golden against the live JAX reference.

``fleet_scan_steps_static`` (the static controller) and ``fleet_scan``
with one field changed at a time: the controller's demand signal and
link-cost awareness, the dependence measure, the model family, the
epsilon policy, each query alone, the weight mode, homogeneous links,
the i.i.d. mode, the lag count and one stream a site.  The reference
runs live in a module fixture (its committed reports are not the
oracle: ROADMAP.md queue 3, note b).  WAN bytes and the byte and budget
histories are held bitwise, the NRMSE tables to the goldens' ``f32``
class.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.sweep.diff import TOLERANCE_CLASSES
from repro_torch.api.experiment import Experiment
from repro_torch.api.scenario import ScenarioConfig

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

F32 = TOLERANCE_CLASSES["f32"]
GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
# the live reference (CPU, jax 0.9)
STEPS_STATIC_WAN_BYTES = 3792


def _golden(name: str) -> dict:
    return json.loads((GOLDENS / f"{name}.json").read_text())["scenario"]


def _fleet_scan(section=None, **change) -> dict:
    d = _golden("fleet_scan")
    if section is None:
        d.update(change)
    elif section == "options":
        d["data"] = dict(d["data"], options=dict(d["data"]["options"],
                                                 **change))
    else:
        d[section] = dict(d[section], **change)
    return d


VARIANTS = {
    "steps_static": _golden("fleet_scan_steps_static"),
    "demand_pred_err": _fleet_scan("controller", demand_signal="pred_err"),
    "demand_max_err": _fleet_scan("controller", demand_signal="max_err"),
    "link_cost_aware": _fleet_scan("controller", link_cost_aware=True),
    "pearson": _fleet_scan("planner", dependence="pearson"),
    "linear": _fleet_scan("planner", model="linear"),
    "alpha": _fleet_scan("planner", epsilon_policy="alpha"),
    "exact_mse": _fleet_scan("planner", epsilon_policy="exact_mse"),
    "query_avg": _fleet_scan(queries=["AVG"]),
    "query_var": _fleet_scan(queries=["VAR"]),
    "query_min": _fleet_scan(queries=["MIN"]),
    "query_max": _fleet_scan(queries=["MAX"]),
    "weight_uniform": _fleet_scan("planner", weight_mode="uniform"),
    "homogeneous_links": _fleet_scan("topology", hetero_links=False),
    "iid": _fleet_scan("planner", iid_mode="iid"),
    "m_lags_3": _fleet_scan("planner", m_lags=3),
    "k_1": _fleet_scan("options", k=1),
}


@pytest.fixture(scope="module")
def reference():
    """The live reference's report of every variant."""
    return {name: RefExperiment.from_scenario(RefScenario.from_dict(d)).run()
            for name, d in VARIANTS.items()}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_scan_variant_matches_live_reference(reference, name):
    ref = reference[name]
    port = Experiment.from_scenario(ScenarioConfig.from_dict(VARIANTS[name]),
                                    device="cpu").run()
    if name == "steps_static":
        assert port.wan_bytes == STEPS_STATIC_WAN_BYTES
    assert port.wan_bytes == ref.wan_bytes
    assert port.wan_bytes_by_region == ref.wan_bytes_by_region
    for k in ("bytes_history", "budget_history"):
        assert np.array_equal(np.asarray(port.raw[k]),
                              np.asarray(ref.raw[k])), k
    rtol, atol = F32
    assert set(port.nrmse_per_stream) == set(ref.nrmse_per_stream)
    for q, table in ref.nrmse_per_stream.items():
        np.testing.assert_allclose(port.nrmse_per_stream[q], table,
                                   rtol=rtol, atol=atol)


# Windows of 32 tuples or fewer, and windows whose N % 4 leaves a tail
# (ROADMAP.md queue 3): the reference's compiled plan sums a short row's
# products as chains of fused multiply-adds, its dots take the first
# N - N % lanes products in lane chains and the rest as one more chain.
def _short(name: str, window: int) -> dict:
    d = _golden(name)
    d["data"] = dict(d["data"], window=window, n_points=6 * window)
    return d


SHORT = {**{f"fleet_scan_w{w}": _short("fleet_scan", w)
            for w in (16, 20, 24, 32, 100)},
         "fleet_scan_adaptive_ph_w32": _short("fleet_scan_adaptive_ph", 32)}


@pytest.fixture(scope="module")
def short_reference():
    return {name: RefExperiment.from_scenario(RefScenario.from_dict(d)).run()
            for name, d in SHORT.items()}


@pytest.mark.parametrize("name", list(SHORT))
def test_short_window_matches_live_reference(short_reference, name):
    ref = short_reference[name]
    port = Experiment.from_scenario(ScenarioConfig.from_dict(SHORT[name]),
                                    device="cpu").run()
    assert port.wan_bytes == ref.wan_bytes
    for k in ("bytes_history", "budget_history"):
        assert np.array_equal(np.asarray(port.raw[k]),
                              np.asarray(ref.raw[k])), k
    for q, table in ref.nrmse_per_stream.items():
        np.testing.assert_array_equal(port.nrmse_per_stream[q], table)


@pytest.mark.parametrize("n", [12, 17, 18, 19, 20, 22, 23, 28, 100, 102,
                               103])
def test_lane_sum_tail_is_the_compiled_dots(n):
    """A fleet's Gram block and one site's X^T X (4 lanes) and one site's
    X^T y (8 lanes) bitwise the compiled dots, whatever N % lanes."""
    import jax
    import torch

    from repro_torch.core.stats import lane_sum
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, 4, n)) * 3 + 1).astype(np.float32)
    f = rng.standard_normal((1, 4, n, 4)).astype(np.float32)
    gram = np.asarray(jax.jit(jax.vmap(lambda v: v @ v.T))(x))
    xty = np.asarray(jax.jit(jax.vmap(jax.vmap(lambda a, y: a.T @ y)))(
        f, x[:1]))
    xtx = np.asarray(jax.jit(jax.vmap(jax.vmap(lambda a: a.T @ a)))(f))
    t, ft = torch.from_numpy(x), torch.from_numpy(f).transpose(-1, -2)
    np.testing.assert_array_equal(
        lane_sum(t[..., :, None, :], t[..., None, :, :], 4).numpy(), gram)
    np.testing.assert_array_equal(
        lane_sum(ft, t[:1, :, None, :], 8).numpy(), xty)
    np.testing.assert_array_equal(
        lane_sum(ft[..., :, None, :], ft[..., None, :, :], 4).numpy(), xtx)
