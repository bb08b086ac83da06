"""The port's single-edge scan (E = 1) against the live JAX reference.

Covers the ``jax.random`` replica the E = 1 sampler needs (``split`` and
``permutation``), the sampler itself, the single-edge datasets and
windows, and the two single-edge golden scenarios under the three model
families that impute differently (cubic, mean, multi).  The committed
golden reports are not the oracle: the reference no longer reproduces
``single_scan_steps``'s (ROADMAP.md queue 3, note b), so it is run live.

Integers are held bitwise: sample sets, allocations, WAN bytes and the
per-window byte history.  Floats are held to the sweep's classes
(``repro.sweep.diff``), each test naming its class:

  * ``ulp`` where the port's value is the reference's up to the host's
    f64 arithmetic: every NRMSE table of the mean family, whose imputed
    values are the window mean;
  * ``f32`` for the families that evaluate a fitted model;
  * ``solve`` (rtol 1e-3) for the multi family's NRMSE tables and for
    the explained variances of the fitted families.  Inside its scan the
    reference sums a fit's 4 x 4 normal equations in yet another order
    than outside one, and the two-predictor system turns those last bits
    into up to 3.6e-4 relative in the NRMSE of a query whose error is
    small (ROADMAP.md queue 3, note e).
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
from repro.data import streams as ref_streams
from repro.runtime.scan import ScanRuntime as RefScanRuntime
from repro.runtime.state import init_state as ref_init_state
from repro.runtime.step import draw_fleet_samples
from repro.sweep.diff import TOLERANCE_CLASSES
from repro_torch.api.experiment import Experiment
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.data import streams
from repro_torch.runtime import threefry
from repro_torch.runtime.scan import ScanRuntime
from repro_torch.runtime.state import init_state
from repro_torch.runtime.step import (PAYLOAD_PLAN_FIELDS, make_window_step,
                                      sample_fleet)

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ULP = TOLERANCE_CLASSES["ulp"]
F32 = TOLERANCE_CLASSES["f32"]
SOLVE = (1e-3, 1e-6)
GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
# WAN bytes of the live reference (CPU, jax 0.9): cubic / mean / multi
LIVE_REFERENCE_WAN_BYTES = {
    "single_scan": {"model": 4662, "mean": 4662, "multi": 4662},
    "single_scan_steps": {"model": 3544, "mean": 3644, "multi": 3496},
}
FAMILIES = ("model", "mean", "multi")     # method "model" is cubic here
NRMSE_CLASS = {"model": F32, "mean": ULP, "multi": SOLVE}


def _scenario(name: str, method: str = "model", **change) -> dict:
    d = json.loads((GOLDENS / f"{name}.json").read_text())["scenario"]
    return dict(d, method=method, **change)


def _words(key) -> tuple:
    return tuple(int(v) for v in np.asarray(key))


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_split_equals_jax(seed):
    key = jax.random.PRNGKey(seed)
    for _ in range(3):
        want = tuple(_words(k) for k in jax.random.split(key))
        got = threefry.split(_words(key))
        assert got == want
        key = jax.random.split(key)[0]


@pytest.mark.parametrize("n,rounds", [(1, 0), (2, 1), (1625, 1), (1626, 2),
                                      (4096, 2)])
def test_permutation_rounds(n, rounds):
    assert threefry.permutation_rounds(n) == rounds


@pytest.mark.parametrize("n", [1, 2, 255, 256, 1625, 1626, 2048])
@pytest.mark.parametrize("seed", [0, 15, 2**31 - 1])
def test_permutation_equals_jax(seed, n):
    """0 rounds at n = 1, 1 up to n = 1625, 2 from 1626 on; three keys
    share one batched sort per round."""
    base = jax.random.PRNGKey(seed)
    keys = [jax.random.fold_in(base, i) for i in range(3)]
    want = np.stack([np.asarray(jax.random.permutation(k, n)) for k in keys])
    got = threefry.permutations([_words(k) for k in keys], n, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_permutation_breaks_ties_of_its_sort_keys_by_position():
    """Among 65536 draws of 32 bits two keys tie about every other round;
    the stable sort leaves tied elements in their running order, as
    ``lax.sort_key_val`` does."""
    n = 65536
    seed = next(s for s in range(20) if _has_tie(s, n))
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    got = threefry.permutations([_words(key)], n, device="cpu")[0]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.permutation(key, n)))


def _has_tie(seed: int, n: int) -> bool:
    key = threefry.fold_in(threefry.prng_key(seed), 1)
    for _ in range(threefry.permutation_rounds(n)):
        key, sub = threefry.split(key)
        bits = threefry.random_bits(sub, (n,), device="cpu")
        if len(torch.unique(bits)) < n:
            return True
    return False


@pytest.mark.parametrize("seed,wid,k,n", [(0, 0, 5, 256), (4, 3, 5, 128),
                                          (2**31 - 1, 11, 8, 1626),
                                          (15, 2, 3, 1)])
def test_single_edge_sample_fleet_equals_reference(seed, wid, k, n):
    rng = np.random.default_rng(wid + n)
    values = rng.normal(50.0, 5.0, (1, k, n)).astype(np.float32)
    n_real = rng.integers(0, n + 1, (1, k)).astype(np.int32)
    want = draw_fleet_samples(seed, wid, values, n_real)
    got = sample_fleet(seed, wid, torch.as_tensor(values),
                       torch.as_tensor(n_real)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------- datasets, windows

@pytest.mark.parametrize("name,kwargs", [
    ("home_like", {}), ("turbine_like", {}), ("turbine_like", {"k": 5}),
    ("smartcity_like", {}), ("mvn_pair", {"rho": 0.7})],
    ids=["home", "turbine", "turbine_k5", "smartcity", "mvn"])
def test_single_edge_datasets_are_bitwise_the_reference(name, kwargs):
    want, want_meta = getattr(ref_streams, name)(n_points=700, seed=3,
                                                 **kwargs)
    got, meta = getattr(streams, name)(n_points=700, seed=3, **kwargs)
    assert got.dtype == np.float32 and meta == want_meta
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_windows_from_matrix_equals_reference():
    vals, _ = streams.smartcity_like(n_points=700, seed=1)
    want = ref_streams.windows_from_matrix(vals, 256)
    got = streams.windows_from_matrix(vals, 256)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.values, np.asarray(b.values))
        np.testing.assert_array_equal(a.counts, np.asarray(b.counts))
        assert a.counts.dtype == np.int32 and a.k == b.k
        assert a.window_id == int(b.window_id) and a.n_max == b.n_max


def test_scenario_pairs_datasets_with_topologies():
    fleet_topo = {"n_regions": 2, "sites_per_region": 2}
    with pytest.raises(ValueError, match="fleet generator"):
        ScenarioConfig.from_dict({"data": {"dataset": "fleet"}})
    with pytest.raises(ValueError, match="single-edge"):
        ScenarioConfig.from_dict({"data": {"dataset": "smartcity"},
                                  "topology": fleet_topo})
    sc = ScenarioConfig.from_dict(_scenario("single_scan_steps"))
    vals, meta = sc.data.generate()
    assert vals.shape == (5, 512) and meta["name"] == "turbine"


# ------------------------------------------------------ the scan runtime

@pytest.fixture(scope="module")
def reference():
    """The live reference: payload replay and per-window scan outputs of
    both golden scenarios under the three families, and the estimates of
    ``single_scan``."""
    out = {}
    for name in LIVE_REFERENCE_WAN_BYTES:
        for fam in FAMILIES:
            sc = RefScenario.from_dict(_scenario(name, fam))
            windows = RefExperiment.from_scenario(sc).make_windows()
            rt = RefScanRuntime.from_scenario(sc)
            raw = rt.run(windows)
            out[(name, fam, "payloads")] = raw
            out[(name, fam, "ys")] = _reference_scan_outputs(rt, windows)
            if name == "single_scan":
                out[(name, fam, "estimates")] = RefScanRuntime.from_scenario(
                    sc, collect="estimates").run(windows)
    return out


def _reference_scan_outputs(rt, windows) -> dict:
    """The reference's per-window step outputs (the compiled scan is
    cached by ``rt.run``)."""
    k, n = windows[0].k, windows[0].n_max
    exec_b = rt._static_exec(k, n)
    pool = jnp.asarray(np.stack([np.asarray(w.values) for w in windows])
                       [:, None])
    _, ys = rt._scan_fn(exec_b)(ref_init_state(1, k, float(exec_b[0])),
                                jnp.arange(len(windows), dtype=jnp.int32),
                                pool)
    return jax.tree.map(np.asarray, ys)


def _port_scan_outputs(d: dict) -> list:
    """The port's per-window step outputs for a scenario dict."""
    ex = Experiment.from_scenario(ScenarioConfig.from_dict(d), device="cpu")
    rt = ex.runtime
    windows = ex.make_windows()
    k, n = windows[0].k, windows[0].n_max
    exec_b = rt._static_exec(k, n)
    pool = torch.as_tensor(np.stack([w.values for w in windows])[:, None])
    step = make_window_step(pool, seed=rt.cfg_eff.seed, plan_fn=rt._plan_fn,
                            qnames=rt.query_names, multi=rt.spec.multi,
                            mean=rt.spec.mean, ctrl=rt.ctrl,
                            static_exec_budgets=exec_b, collect="payloads")
    state = init_state(1, k, exec_b[0], device="cpu")
    return [step(state, w) for w in range(len(windows))]


def _assert_nrmse(got: dict, want: dict, tol):
    rtol, atol = tol
    assert set(got) == set(want)
    for q, v in want.items():
        np.testing.assert_allclose(got[q], v, rtol=rtol, atol=atol,
                                   err_msg=q)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", sorted(LIVE_REFERENCE_WAN_BYTES))
def test_single_scan_matches_live_reference(reference, name, family):
    """WAN bytes and the byte history bitwise; the NRMSE tables in the
    family's class (module docstring)."""
    want = reference[(name, family, "payloads")]
    report = Experiment.from_scenario(
        ScenarioConfig.from_dict(_scenario(name, family)),
        device="cpu").run()
    assert report.n_sites == 1
    assert want["wan_bytes"] == LIVE_REFERENCE_WAN_BYTES[name][family]
    assert report.wan_bytes == want["wan_bytes"]
    np.testing.assert_array_equal(report.raw["bytes_history"],
                                  want["bytes_history"])
    assert report.full_bytes == want["full_bytes"]
    assert report.wan_cost == want["wan_cost"]
    _assert_nrmse(report.raw["nrmse"], want["nrmse"], NRMSE_CLASS[family])
    nrmse = {q: float(np.nanmean(v)) for q, v in want["nrmse"].items()}
    _assert_nrmse(report.nrmse, nrmse, NRMSE_CLASS[family])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", sorted(LIVE_REFERENCE_WAN_BYTES))
def test_single_scan_plans_and_samples_match_reference(reference, name,
                                                       family):
    """Per window: the sample sets and allocations bitwise, the window
    statistics and the predictors' standardization bitwise, the explained
    variances (zero under mean imputation) in the ``solve`` class."""
    ys = reference[(name, family, "ys")]
    outs = _port_scan_outputs(_scenario(name, family))
    for t, o in enumerate(outs):
        for f in ("samples", "n_real", "n_imputed", "predictor", "mean",
                  "var", "loc", "scale"):
            np.testing.assert_array_equal(
                o[f].numpy(), np.asarray(ys[f][t]).astype(o[f].numpy().dtype),
                err_msg=f"window {t} {f}")
        np.testing.assert_array_equal(o["bytes"].numpy(), ys["bytes"][t])
        np.testing.assert_allclose(o["explained_var"].numpy(),
                                   ys["explained_var"][t], rtol=SOLVE[0],
                                   atol=SOLVE[1])
        assert set(PAYLOAD_PLAN_FIELDS) <= set(o)


@pytest.mark.parametrize("family", FAMILIES)
def test_single_scan_estimates_match_reference(reference, family):
    """``collect="estimates"``: the on-device f32 tables, in the f32
    class (the multi family in its own)."""
    want = reference[("single_scan", family, "estimates")]
    got = Experiment.from_scenario(
        ScenarioConfig.from_dict(_scenario("single_scan", family)),
        collect="estimates", device="cpu").run().raw
    assert got["wan_bytes"] == want["wan_bytes"]
    np.testing.assert_array_equal(got["bytes_history"], want["bytes_history"])
    tol = SOLVE if family == "multi" else F32
    _assert_nrmse(got["nrmse"], want["nrmse"], tol)


def test_single_scan_kernel_path_matches_reference():
    """``use_kernel=True`` (the fused cubic fit) against the reference's
    fused fit in interpret mode."""
    d = _scenario("single_scan")
    want = RefExperiment.from_scenario(RefScenario.from_dict(d),
                                       use_kernel=True,
                                       interpret=True).run().raw
    got = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                   use_kernel=True, device="cpu").run().raw
    assert got["wan_bytes"] == want["wan_bytes"] == 4662
    np.testing.assert_array_equal(got["bytes_history"], want["bytes_history"])
    _assert_nrmse(got["nrmse"], want["nrmse"], F32)


def test_one_site_topology_is_a_single_edge_with_its_link_cost():
    """A one-site topology runs the single-edge scan; the reference's
    link cost per byte for that topology prices the WAN bytes (``ulp``
    class: a sum of per-window products)."""
    topo = {"n_regions": 1, "sites_per_region": 1, "seed": 3,
            "latency_scale": 0.0}
    d = _scenario("single_scan", topology=topo)
    link = RefScenario.from_dict(d).topology.build(1).sites[0].link
    got = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                   device="cpu").run()
    assert got.n_sites == 1 and got.wan_bytes == 4662
    assert link.cost_per_byte != 1.0
    np.testing.assert_allclose(got.wan_cost, 4662 * link.cost_per_byte,
                               rtol=ULP[0], atol=ULP[1])
    assert got.wan_cost_by_region == {"local": got.wan_cost}


def test_single_scan_steps_equals_scan_and_resumes():
    """The two cadences are one loop; a run split at window 2 resumes
    bitwise from its carry."""
    d = _scenario("single_scan_steps")
    a = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                 device="cpu")
    b = Experiment.from_scenario(ScenarioConfig.from_dict(
        dict(d, runtime="scan")), device="cpu")
    ra, rb = a.run().raw, b.run().raw
    assert ra["mode"] == "steps" and rb["mode"] == "scan"
    np.testing.assert_array_equal(ra["bytes_history"], rb["bytes_history"])
    for q in ra["nrmse"]:
        np.testing.assert_array_equal(ra["nrmse"][q], rb["nrmse"][q])
    windows = a.make_windows()
    head = a.runtime.run(windows, n_windows=2)
    tail = a.runtime.run(windows, n_windows=2, state=head["final_state"])
    np.testing.assert_array_equal(
        np.concatenate([head["bytes_history"], tail["bytes_history"]]),
        ra["bytes_history"])


def test_scan_runtime_refuses_ragged_windows_and_baselines():
    from repro_torch.core.types import WindowBatch
    rt = ScanRuntime.from_scenario(
        ScenarioConfig.from_dict(_scenario("single_scan")), device="cpu")
    short = WindowBatch.from_numpy(np.ones((5, 8)), counts=[8, 8, 7, 8, 8])
    with pytest.raises(ValueError, match="full windows"):
        rt.run([short])
    with pytest.raises(ValueError, match="baselines need runtime='event'"):
        ScanRuntime.from_scenario(
            ScenarioConfig.from_dict(_scenario("single_scan", "srs")),
            device="cpu")


def test_single_edge_entry_points_default_to_the_card():
    """Without ``device`` the permutation draw and a single-edge
    experiment go to the card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        threefry.permutations([(0, 1)], 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment.from_scenario(
            ScenarioConfig.from_dict(_scenario("single_scan")))
