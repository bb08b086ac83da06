"""The port's host planner (``repro_torch.core.planner.plan_window``)
against the reference's, window by window, on the CPU.

The reference's host planner compiles its statistics and its fit on one
(k, N) window with the counts as data, a compilation of its own (not the
scan's), and calls epsilon, the predictor heuristic and the exact-MSE
cap op by op.  The port evaluates each in that order, so on the goldens'
datasets every piece is bitwise: the statistics (both dependences,
stragglers included), the linear, cubic and mean fits, epsilon, the
predictors, the cap, the sampler's draws, and the payload of
``_plan_window_host`` (n_real, n_imputed, predictor, real values, model,
stats digest).  The multi family's two-predictor fit is bitwise too: it
sums its normal equations as the single-predictor fit does and solves
them in LAPACK's order, an exact zero pivot included (the k = 2 windows,
whose two predictors are one stream).

The reference's IPM needs ``jax.experimental.enable_x64``, which JAX 0.9
removed: the ``x64`` fixture points it at ``jax.enable_x64`` per test.
"""
import dataclasses
import json
import pathlib

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.core import epsilon as ref_eps
from repro.core import planner as ref_planner
from repro.core import predictor as ref_pred
from repro.core import samplers as ref_samplers
from repro.core import stats as ref_stats
from repro.core.types import PlannerConfig as RefPlannerConfig
from repro.core.types import WindowBatch as RefWindowBatch
from repro_torch.core import epsilon, planner, predictor, samplers
from repro_torch.core import stats
from repro_torch.core.types import PlannerConfig, StreamStats, WindowBatch
from repro_torch.runtime import threefry

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens" / "scenarios"
# the five single-edge event goldens' datasets (k = 5, 5, 5, 2, 3)
DATA = ["single_event_cubic", "single_event_retransmit",
        "single_event_drop_gaps", "single_event_jitter_bandwidth",
        "single_event_latency_revise"]
STAT_FIELDS = ("mean", "var", "m4", "var_of_var", "cov", "corr")
MODEL_FIELDS = ("coeffs", "loc", "scale", "explained_var")


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _windows(name: str) -> list:
    d = json.loads((GOLDENS / f"{name}.json").read_text())["scenario"]
    return [dataclasses.replace(w, values=np.array(w.values))
            for w in RefExperiment.from_scenario(RefScenario.from_dict(d))
            .make_windows()]


def _count_cases():
    """(dataset, window, counts): full windows, a straggled stream (0
    tuples), a short one and two short ones."""
    out = []
    for name in DATA:
        for w in _windows(name)[:1]:
            values = np.asarray(w.values)
            k, n = values.shape
            for counts in (np.full(k, n), np.where(np.arange(k) == 1, 0, n),
                           np.where(np.arange(k) == 0, 200, n),
                           np.where(np.arange(k) >= k - 2, 37, n)):
                out.append((name, int(w.window_id), values,
                            counts.astype(np.int32)))
    return out


CASES = _count_cases()


def _case_id(c):
    return f"{c[0][13:]}-w{c[1]}-{'-'.join(map(str, c[3]))}"


@pytest.mark.parametrize("dependence", ["spearman", "pearson"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_window_stats_is_the_reference_s(case, dependence):
    _, _, values, counts = case
    want = ref_stats.window_stats(jnp.asarray(values), jnp.asarray(counts),
                                  dependence=dependence)
    got = stats.window_stats(torch.as_tensor(values),
                             torch.as_tensor(counts), dependence)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_the_statistics_order_matters():
    """The windows above tell the compiled order from its neighbours: the
    covariance's fused multiply-add and the dot's chains each move some
    last bits."""
    _, _, values, counts = CASES[0]
    v, c = torch.as_tensor(values), torch.as_tensor(counts)
    want = np.asarray(ref_stats.window_stats(jnp.asarray(values),
                                             jnp.asarray(counts)).cov)
    np.testing.assert_array_equal(stats.masked_cov(v, c).numpy(), want)
    fma, lanes = stats.fma, stats.gram_lanes
    try:
        stats.fma = lambda a, b, x: a * b + x
        assert not np.array_equal(stats.masked_cov(v, c).numpy(), want)
        stats.fma = fma
        stats.gram_lanes = lambda k: 1
        assert not np.array_equal(stats.masked_cov(v, c).numpy(), want)
    finally:
        stats.fma, stats.gram_lanes = fma, lanes


@pytest.mark.parametrize("family", ["linear", "cubic", "mean", "multi"])
@pytest.mark.parametrize("case", CASES[::2], ids=_case_id)
def test_the_host_fit_is_the_reference_s(case, family):
    _, _, values, counts = case
    v, c = jnp.asarray(values), jnp.asarray(counts)
    st = ref_stats.window_stats(v, c, dependence="spearman")
    spec = ref_planner.MODELS.get(family)
    pred = spec.select(st.corr)
    want = spec.fit(v, c, pred)
    port = planner.MODELS.get(family)
    tpred = port.select(stats.window_stats(torch.as_tensor(values),
                                           torch.as_tensor(counts),
                                           "spearman").corr)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(pred))
    got = port.fit(torch.as_tensor(values), torch.as_tensor(counts), tpred)
    for f in MODEL_FIELDS:
        g = (got[f] if family == "multi" else getattr(got, f)).numpy()
        w = np.asarray(want[f] if family == "multi" else getattr(want, f))
        np.testing.assert_array_equal(g, w, f)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_epsilon_predictors_and_the_cap_are_the_reference_s(case):
    """Called op by op in the reference's host planner, so no multiply-add
    is fused: the port's formulas are that order already."""
    _, _, values, counts = case
    st = ref_stats.window_stats(jnp.asarray(values), jnp.asarray(counts),
                                dependence="spearman")
    tst = StreamStats(**{f: torch.as_tensor(np.asarray(getattr(st, f)))
                         for f in ("count",) + STAT_FIELDS})
    for policy, scale in (("k_se", 1.0), ("alpha", 0.05), ("k_se", 2.5)):
        np.testing.assert_array_equal(
            epsilon.make_epsilon(policy, tst, scale).numpy(),
            np.asarray(ref_eps.make_epsilon(policy, st, scale)))
    np.testing.assert_array_equal(
        predictor.heuristic_predictors(tst.corr).numpy(),
        np.asarray(ref_pred.heuristic_predictors(st.corr)))
    np.testing.assert_array_equal(
        predictor.heuristic_predictors_multi(tst.corr).numpy(),
        np.asarray(ref_pred.heuristic_predictors_multi(st.corr)))
    k = len(counts)
    rng = np.random.default_rng(k)
    nr = rng.integers(0, 80, k)
    ns = rng.integers(0, 120, k)
    want = ref_eps.exact_mse_cap(st, nr, ns, nr + ns)
    got = epsilon.exact_mse_cap(tst, torch.as_tensor(nr),
                                torch.as_tensor(ns), torch.as_tensor(nr + ns))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sigma2 = np.maximum(np.asarray(st.var, np.float64), 1e-12)
    v = np.clip(sigma2 * 0.6, 0.0, sigma2 * (1.0 - 1e-9))
    want = ref_eps.exact_mse_shrink(nr, ns, jnp.asarray(sigma2, jnp.float32),
                                    jnp.asarray(v, jnp.float32), want)
    got = epsilon.exact_mse_shrink(torch.as_tensor(nr), torch.as_tensor(ns),
                                   torch.as_tensor(sigma2, dtype=torch.float32),
                                   torch.as_tensor(v, dtype=torch.float32),
                                   got)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_draw_samples_is_the_reference_s(seed):
    rng = np.random.default_rng(seed)
    k = 6
    values = rng.standard_normal((k, 300)).astype(np.float32)
    counts = np.array([300, 0, 17, 300, 1, 256], np.int32)
    alloc = np.array([40, 5, 30, 0, 1, 256])
    for wid in range(3):
        want = ref_samplers.draw_samples(jax.random.PRNGKey(seed ^ wid),
                                         jnp.asarray(values),
                                         jnp.asarray(counts), alloc)
        got = samplers.draw_samples(threefry.prng_key(seed ^ wid), values,
                                    counts, alloc, device="cpu")
        assert [len(g) for g in got] == [len(w) for w in want]
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def _same_payload(got, want, multi=False):
    assert got.window_id == want.window_id
    np.testing.assert_array_equal(got.n_real, want.n_real)
    np.testing.assert_array_equal(got.n_imputed, want.n_imputed)
    np.testing.assert_array_equal(got.predictor, np.asarray(want.predictor))
    assert got.mean_imputation == want.mean_imputation
    for g, w in zip(got.real_values, want.real_values):
        np.testing.assert_array_equal(g, w)
    for f in ("mean", "var"):
        np.testing.assert_array_equal(got.stats_digest[f],
                                      np.asarray(want.stats_digest[f]))
    assert (got.model is None) == (want.model is None)
    if got.model is None:
        return
    for f in MODEL_FIELDS:
        g = np.asarray(got.model[f] if multi else getattr(got.model, f))
        w = np.asarray(want.model[f] if multi else getattr(want.model, f))
        np.testing.assert_array_equal(g, w, f)


PLANNERS = {
    "default": {},
    "linear": {"model": "linear", "dependence": "pearson"},
    "mean": {"model": "mean"},
    "multi": {"model": "multi"},
    "fixed_predictors": {},                 # filled per window
    "exact_mse": {"epsilon_policy": "exact_mse"},
    "alpha": {"epsilon_policy": "alpha", "epsilon_scale": 0.05},
    "cost_per_sample": {},                  # filled per window
    "slsqp": {"solver": "slsqp"},
    "closed_form": {"solver": "closed_form"},
}


@pytest.mark.parametrize("planner_name", sorted(PLANNERS))
@pytest.mark.parametrize("name", DATA)
def test_plan_window_host_is_the_reference_s(name, planner_name, x64):
    for w in _windows(name)[1:2]:
        values = np.asarray(w.values)
        k, n = values.shape
        opts = dict(PLANNERS[planner_name], seed=3)
        if planner_name == "fixed_predictors":
            opts["fixed_predictors"] = tuple((i + 1) % k for i in range(k))
        if planner_name == "cost_per_sample":
            opts["cost_per_sample"] = tuple(1.0 + 0.5 * (i % 2)
                                            for i in range(k))
        for counts in (np.full(k, n), np.where(np.arange(k) == 1, 0, n)):
            counts = counts.astype(np.int32)
            budget = max(int(0.3 * counts.sum()), 2)
            want, wdiag = ref_planner.plan_window(
                RefWindowBatch.from_numpy(values, counts, w.window_id),
                budget, RefPlannerConfig(**opts))
            got, gdiag = planner.plan_window(
                WindowBatch.from_numpy(values, counts, w.window_id), budget,
                PlannerConfig(**opts), device="cpu")
            _same_payload(got, want, multi=planner_name == "multi")
            alloc, walloc = gdiag.allocation, wdiag.allocation
            np.testing.assert_array_equal(alloc.n_real,
                                          np.asarray(walloc.n_real))
            np.testing.assert_array_equal(alloc.eps_used,
                                          np.asarray(walloc.eps_used))
            assert gdiag.solver_feasible == wdiag.solver_feasible
            assert gdiag.device_seconds > 0 and gdiag.solve_seconds > 0


def test_plan_one_is_the_reference_s():
    """``engine="batched"``: one edge as the fleet pass's E = 1 case."""
    opts = dict(solver="closed_form", engine="batched", seed=4)
    for name in ("single_event_cubic", "single_event_latency_revise"):
        for w in _windows(name)[:2]:
            values = np.asarray(w.values)
            counts = np.asarray(w.counts)
            budget = max(int(0.3 * counts.sum()), 2)
            want, wdiag = ref_planner.plan_window(
                RefWindowBatch.from_numpy(values, counts, w.window_id),
                budget, RefPlannerConfig(**opts))
            got, gdiag = planner.plan_window(
                WindowBatch.from_numpy(values, counts, w.window_id), budget,
                PlannerConfig(**opts), device="cpu")
            _same_payload(got, want)
            assert gdiag.solver_feasible == wdiag.solver_feasible
            np.testing.assert_array_equal(gdiag.allocation.n_imputed,
                                          np.asarray(wdiag.allocation
                                                     .n_imputed))


def test_the_host_planner_refuses_what_is_not_ported():
    """Nothing is refused now: ``engine="sharded"`` plans one window as
    its E = 1 case, which is the batched engine's."""
    rng = np.random.default_rng(5)
    w = WindowBatch.from_numpy(rng.normal(2.0, 1.0, (3, 8)).astype(
        np.float32))
    cfg = PlannerConfig(engine="sharded", solver="closed_form")
    got, _ = planner.plan_window(w, 12, cfg, device="cpu")
    want, _ = planner.plan_window(
        w, 12, dataclasses.replace(cfg, engine="batched"), device="cpu")
    np.testing.assert_array_equal(got.n_real, want.n_real)
    np.testing.assert_array_equal(got.n_imputed, want.n_imputed)
    for g, v in zip(got.real_values, want.real_values, strict=True):
        np.testing.assert_array_equal(g, v)
