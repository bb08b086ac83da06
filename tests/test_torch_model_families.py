"""The mean and multi model families against the live JAX reference.

Module parity on the inputs of ``tests/test_multi_predictor.py``, the
batched plan of both families, and the ``fleet_scan`` golden scenario
run under each (``planner.model``).  Integers are held bitwise
(predictors, allocations, WAN bytes, byte and budget histories); each
float comparison names its class from ``repro.sweep.diff``.

The 4 x 4 normal equations of a fit are summed by the reference's dot
and the port's matmul in different orders, and solved by two LAPACK
builds; the system turns those last bits into ~1e-5 relative in the
coefficients (ROADMAP.md queue 3, note e).  So a fit is compared through
the values it imputes (``f32`` class), as ``test_torch_planning.py``
compares the cubic fit.
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.core import models as ref_models
from repro.core import predictor as ref_predictor
from repro.planning.batched import fleet_plan as ref_fleet_plan
from repro.runtime.scan import ScanRuntime as RefScanRuntime
from repro.sweep.diff import TOLERANCE_CLASSES
from repro_torch.api.experiment import Experiment
from repro_torch.api.registry import MODELS
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.core import models
from repro_torch.core.predictor import heuristic_predictors_multi
from repro_torch.data.streams import fleet_like
from repro_torch.planning.batched import fleet_plan

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

ULP = TOLERANCE_CLASSES["ulp"]
F32 = TOLERANCE_CLASSES["f32"]
SCENARIO = json.loads((pathlib.Path(__file__).parent / "goldens"
                       / "scenarios" / "fleet_scan.json").read_text())[
                           "scenario"]
# fleet_scan's WAN bytes under each planner.model (live reference, CPU)
LIVE_REFERENCE_WAN_BYTES = {"cubic": 11080, "mean": 11540, "multi": 9436}


def _multi_inputs():
    """tests/test_multi_predictor.py's bilinear target (rng seed 0)."""
    rng = np.random.default_rng(0)
    n = 800
    xp = rng.normal(0, 1, n).astype(np.float32)
    xq = rng.normal(0, 1, n).astype(np.float32)
    y = (2.0 + 1.5 * xp - 0.7 * xq + 0.3 * xp * xq
         + rng.normal(0, 0.05, n)).astype(np.float32)
    return np.stack([y, xp, xq]), np.array([[1, 2], [0, 2], [0, 1]])


def _two_driver_inputs():
    """tests/test_multi_predictor.py's two independent drivers."""
    rng = np.random.default_rng(0)
    n = 1000
    a = rng.normal(0, 1, n).astype(np.float32)
    b = rng.normal(0, 1, n).astype(np.float32)
    y = (a + b + rng.normal(0, 0.1, n)).astype(np.float32)
    return np.stack([y, a, b]), np.array([[1, 2], [0, 2], [0, 1]])


INPUTS = {"bilinear": _multi_inputs, "two_drivers": _two_driver_inputs}


def _torch_args(vals, preds, counts=None):
    k, n = vals.shape
    counts = np.full((k,), n, np.int32) if counts is None else counts
    return (torch.as_tensor(vals), torch.as_tensor(counts),
            torch.as_tensor(preds, dtype=torch.int64))


def _impute(model: dict, vals: np.ndarray) -> np.ndarray:
    """Both models' values imputed from the same observations, by the
    port's evaluator (the reference's formula)."""
    m = {f: torch.as_tensor(np.array(model[f]))
         for f in ("coeffs", "loc", "scale")}
    p = np.array(model["predictor"])
    v = torch.as_tensor(np.array(vals))
    return models.evaluate_model_multi(m, v[p[:, 0]], v[p[:, 1]]).numpy()


@pytest.mark.parametrize("inputs", sorted(INPUTS))
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_fit_models_multi_matches_reference(inputs, ragged):
    """Standardization and explained variance in the ``f32`` class, the
    fit through its imputed values in the ``f32`` class; ragged counts
    included."""
    vals, preds = INPUTS[inputs]()
    counts = (np.array([790, 800, 640], np.int32) if ragged
              else np.full((3,), vals.shape[1], np.int32))
    want = ref_models.fit_models_multi(jnp.asarray(vals), jnp.asarray(counts),
                                       jnp.asarray(preds, jnp.int32))
    got = models.fit_models_multi(*_torch_args(vals, preds, counts))
    rtol, atol = F32
    for f in ("loc", "scale", "explained_var"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                   rtol=rtol, atol=atol, err_msg=f)
    assert got["coeffs"].shape == (3, 4) and got["loc"].shape == (3, 2)
    np.testing.assert_array_equal(got["predictor"].numpy(), preds)
    np.testing.assert_allclose(_impute(got, vals), _impute(want, vals),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("inputs", sorted(INPUTS))
def test_evaluate_model_multi_matches_reference(inputs):
    """The evaluator on one model, in the ``ulp`` class (the same f32
    formula)."""
    vals, preds = INPUTS[inputs]()
    model = ref_models.fit_models_multi(
        jnp.asarray(vals), jnp.full((3,), vals.shape[1], jnp.int32),
        jnp.asarray(preds, jnp.int32))
    want = np.asarray(ref_models.evaluate_model_multi(
        model, jnp.asarray(vals)[preds[:, 0]],
        jnp.asarray(vals)[preds[:, 1]]))
    np.testing.assert_allclose(_impute(model, vals), want, rtol=ULP[0],
                               atol=ULP[1])
    # tests/test_multi_predictor.py's claims hold for the port's own fit
    got = models.fit_models_multi(*_torch_args(vals, preds))
    if inputs == "bilinear":
        assert np.sqrt(np.mean((_impute(got, vals)[0] - vals[0]) ** 2)) < 0.1
    else:
        single = models.fit_models(*_torch_args(vals, preds[:, 0]), degree=3)
        assert float(got["explained_var"][0]) > 1.5 * float(
            single.explained_var[0])


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_mean_model_matches_reference(ragged):
    """Mean imputation: the window mean in coefficient 0 (``ulp`` class),
    explained variance exactly 0."""
    vals, _ = _two_driver_inputs()
    counts = (np.array([999, 1000, 3], np.int32) if ragged
              else np.full((3,), vals.shape[1], np.int32))
    pred = np.array([1, 0, 0])
    want = ref_models.mean_model(jnp.asarray(vals), jnp.asarray(counts),
                                 jnp.asarray(pred))
    got = models.mean_model(*_torch_args(vals, pred, counts))
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs),
                               rtol=ULP[0], atol=ULP[1])
    for f in ("loc", "scale", "explained_var"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert not got.explained_var.any()


CORRS = {
    "test_multi_predictor": np.array([[1.0, 0.9, 0.5, 0.1],
                                      [0.9, 1.0, 0.4, 0.2],
                                      [0.5, 0.4, 1.0, 0.3],
                                      [0.1, 0.2, 0.3, 1.0]], np.float32),
    "ties": np.array([[1.0, 0.5, 0.5, 0.5],
                      [0.5, 1.0, -0.5, 0.5],
                      [0.5, -0.5, 1.0, 0.5],
                      [0.5, 0.5, 0.5, 1.0]], np.float32),
    "nan": np.array([[1.0, np.nan, 0.2],
                     [np.nan, 1.0, -0.7],
                     [0.2, -0.7, 1.0]], np.float32),
    "k2": np.array([[1.0, 0.3], [0.3, 1.0]], np.float32),
}


@pytest.mark.parametrize("name", sorted(CORRS))
def test_heuristic_predictors_multi_equals_reference(name):
    """Bitwise, ties to the lower index as ``lax.top_k`` breaks them; at
    k = 2 the second predictor repeats the first."""
    corr = CORRS[name]
    want = np.asarray(ref_predictor.heuristic_predictors_multi(
        jnp.asarray(corr)))
    got = heuristic_predictors_multi(torch.as_tensor(corr))
    np.testing.assert_array_equal(got.numpy(), want)


def test_heuristic_predictors_multi_batched_equals_reference():
    rng = np.random.default_rng(4)
    corr = rng.choice([-0.6, -0.2, 0.2, 0.6], size=(6, 5, 5)).astype(
        np.float32)
    want = np.stack([np.asarray(ref_predictor.heuristic_predictors_multi(
        jnp.asarray(c))) for c in corr])
    got = heuristic_predictors_multi(torch.as_tensor(corr))
    np.testing.assert_array_equal(got.numpy(), want)


def test_families_are_registered_with_their_upload_bytes():
    mean, multi = MODELS.get("mean"), MODELS.get("multi")
    assert (mean.per_model_bytes, mean.mean, mean.multi) == (4.0, True, False)
    assert (multi.per_model_bytes, multi.mean, multi.multi) == (40.0, False,
                                                                True)


@pytest.mark.parametrize("dependence,model,use_kernel", [
    ("spearman", "mean", None), ("spearman", "multi", None),
    ("pearson", "mean", None), ("pearson", "multi", None),
    ("spearman", "multi", True)])
def test_fleet_plan_families_match_reference(dependence, model, use_kernel):
    """The batched plan outside a scan: allocations and predictors
    bitwise; statistics, epsilon, standardization and objective in the
    ``f32`` class, the fit through its imputed values and explained
    variance in the ``f32`` class.  Neither family has a kernel of its
    own, and ``use_kernel`` leaves them alone."""
    e, k, n = 6, 5, 64
    vals, _ = fleet_like(n_sites=e, n_regions=2, k=k, n_points=n, seed=3)
    counts = np.full((e, k), n, np.int32)
    budgets = np.full((e,), 0.3 * k * n, np.float32)
    ref = ref_fleet_plan(jnp.asarray(vals), jnp.asarray(counts),
                         jnp.asarray(budgets), dependence=dependence,
                         model=model, use_kernel=use_kernel,
                         interpret=bool(use_kernel))
    got = fleet_plan(torch.as_tensor(vals), torch.as_tensor(counts),
                     torch.as_tensor(budgets), dependence=dependence,
                     model=model, use_kernel=use_kernel).to_numpy()
    want = {f: np.asarray(getattr(ref, f)) for f in got}
    assert got["predictor"].shape == ((e, k, 2) if model == "multi"
                                      else (e, k))
    for f in ("n_real", "n_imputed", "predictor"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    rtol, atol = F32
    for f in ("mean", "var", "eps", "loc", "scale", "objective",
              "explained_var", "r2"):
        np.testing.assert_allclose(got[f], want[f], rtol=rtol, atol=atol,
                                   err_msg=f)
    if model == "mean":
        np.testing.assert_allclose(got["coeffs"], want["coeffs"], rtol=rtol,
                                   atol=atol)
    else:
        for s in range(e):
            site = {f: got[f][s] for f in ("coeffs", "loc", "scale",
                                           "predictor")}
            ref_site = {f: want[f][s] for f in site}
            np.testing.assert_allclose(_impute(site, vals[s]),
                                       _impute(ref_site, vals[s]),
                                       rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def reference():
    """fleet_scan's live reference under mean and multi: the payload
    replay and the on-device estimates."""
    out = {}
    for model in ("mean", "multi"):
        d = dict(SCENARIO, planner=dict(SCENARIO["planner"], model=model))
        sc = RefScenario.from_dict(d)
        windows = RefExperiment.from_scenario(sc).make_windows()
        out[(model, "payloads")] = RefScanRuntime.from_scenario(sc).run(
            windows)
        out[(model, "estimates")] = RefScanRuntime.from_scenario(
            sc, collect="estimates").run(windows)
    return out


@pytest.mark.parametrize("collect", ["payloads", "estimates"])
@pytest.mark.parametrize("model", ["mean", "multi"])
def test_fleet_scan_families_match_live_reference(reference, model, collect):
    """WAN bytes and the byte and budget histories bitwise; the fleet,
    site and region NRMSE tables in the ``f32`` class."""
    want = reference[(model, collect)]
    d = dict(SCENARIO, planner=dict(SCENARIO["planner"], model=model))
    report = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                      collect=collect, device="cpu").run()
    got = report.raw
    assert want["wan_bytes"] == LIVE_REFERENCE_WAN_BYTES[model]
    assert report.wan_bytes == want["wan_bytes"]
    np.testing.assert_array_equal(got["bytes_history"], want["bytes_history"])
    np.testing.assert_array_equal(got["budget_history"],
                                  want["budget_history"])
    assert got["wan_bytes_by_region"] == want["wan_bytes_by_region"]
    rtol, atol = F32
    for q, v in want["fleet_nrmse"].items():
        np.testing.assert_allclose(got["fleet_nrmse"][q], v, rtol=rtol,
                                   atol=atol, err_msg=q)
        np.testing.assert_allclose(got["site_nrmse"][q],
                                   want["site_nrmse"][q], rtol=rtol,
                                   atol=atol, err_msg=q)
    for reg, qs in want["region_nrmse"].items():
        for q, v in qs.items():
            np.testing.assert_allclose(got["region_nrmse"][reg][q], v,
                                       rtol=rtol, atol=atol)
