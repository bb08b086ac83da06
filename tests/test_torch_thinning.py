"""Thinning and m-dependence (``iid_mode``, §IV-D) in the port, against
the live JAX reference on the CPU.

The reference calls its autocovariances and partial autocorrelations op
by op, outside any compilation: every sum is a standalone reduction and
every product is rounded alone.  The port sums in that order
(``core/stats.py::blocked_sum``), so on smartcity and turbine windows of
64, 100 and 256 tuples, with and without a masked tail, every
autocovariance, PACF, significant-lag count, stride, thinned window and
eq.-9 variance is bitwise the reference's; so are the host planner's
strides, continuous IPM solutions and allocations under both modes on
Fig. 9's windows (smartcity, 3072 points, windows of 256, seed 13), and
whole runs of Fig. 9's three settings.

The reference's IPM needs ``jax.experimental.enable_x64``, which JAX 0.9
removed: the ``x64`` fixture points it at ``jax.enable_x64`` per test.
"""
import dataclasses

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.experiment import Experiment as RefExperiment
from repro.api.scenario import ScenarioConfig as RefScenario
from repro.core import planner as ref_planner
from repro.core import solver as ref_solver
from repro.core import stats as ref_stats
from repro.core import thinning as ref_thinning
from repro.core.types import PlannerConfig as RefPlannerConfig
from repro.core.types import WindowBatch as RefWindowBatch
from repro.sweep.report import serialize_report as ref_serialize
from repro_torch.api.experiment import Experiment
from repro_torch.api.registry import IID_MODES
from repro_torch.api.scenario import ScenarioConfig
from repro_torch.core import planner, solver, stats, thinning
from repro_torch.core.types import PlannerConfig, WindowBatch
from repro_torch.sweep.diff import diff_reports
from repro_torch.sweep.report import serialize_report

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

# benchmarks/fig9_iid.py's setting
FIG9 = {"data": {"dataset": "smartcity", "n_points": 3072, "window": 256,
                 "seed": 13, "options": {}},
        "budget_fraction": 0.3, "queries": ["AVG"], "runtime": "event"}


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _windows(dataset: str, n: int, count: int = 2, seed: int = 5) -> list:
    d = {"data": {"dataset": dataset, "n_points": n * count, "window": n,
                  "seed": seed, "options": {}}, "runtime": "event"}
    return [np.array(w.values) for w in RefExperiment.from_scenario(
        RefScenario.from_dict(d)).make_windows()]


def _cases():
    out = []
    for dataset in ("smartcity", "turbine"):
        for n in (64, 100, 256):
            for w in _windows(dataset, n, count=1):
                k = w.shape[0]
                # full streams, and masked tails of several lengths
                tails = (0, 3, 31, 0, 1, 40, 0)
                counts = np.asarray([n - tails[i % 7] for i in range(k)],
                                    np.int32)
                out.append((f"{dataset}-{n}", w, counts))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]
MAX_LAG = 8


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autocovariance_and_pacf_are_the_reference_s(case):
    _, w, counts = case
    for i, c in enumerate(counts):
        x = w[i]
        want_g = ref_stats.autocovariance(jnp.asarray(x), jnp.asarray(c),
                                          MAX_LAG)
        want_p = ref_stats.pacf(jnp.asarray(x), jnp.asarray(c), MAX_LAG)
        _same(stats.autocovariance(torch.as_tensor(x), int(c), MAX_LAG),
              want_g)
        _same(stats.pacf(torch.as_tensor(x), int(c), MAX_LAG), want_p)
        # a stream of its own length (thinning's call)
        _same(stats.autocovariance(torch.as_tensor(x[:c]), int(c), 3),
              ref_stats.autocovariance(jnp.asarray(x[:c]), jnp.asarray(c),
                                       3))
    # the batched form, every stream at once
    want = np.stack([np.asarray(ref_stats.autocovariance(
        jnp.asarray(w[i]), jnp.asarray(c), MAX_LAG))
        for i, c in enumerate(counts)])
    _same(stats.autocovariance(torch.as_tensor(w), torch.as_tensor(counts),
                               MAX_LAG), want)
    want = np.stack([np.asarray(ref_stats.pacf(
        jnp.asarray(w[i]), jnp.asarray(c), MAX_LAG))
        for i, c in enumerate(counts)])
    _same(stats.pacf(torch.as_tensor(w), torch.as_tensor(counts), MAX_LAG),
          want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lags_strides_and_the_thinned_window_are_the_reference_s(case):
    _, w, counts = case
    for i, c in enumerate(counts):
        assert thinning.significant_lags(w[i], int(c), device="cpu") == \
            ref_thinning.significant_lags(w[i], int(c))
        for max_lag in (2, MAX_LAG):
            assert thinning.thinning_stride(w[i], int(c), max_lag,
                                            device="cpu") == \
                ref_thinning.thinning_stride(w[i], int(c), max_lag)
    straggled = counts.copy()
    straggled[1] = 0
    for c in (counts, straggled):
        got = thinning.thin_window(w, c, device="cpu")
        want = ref_thinning.thin_window(w, c)
        for g, r in zip(got, want):
            assert g.dtype == r.dtype
            _same(g, r)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_m_dependence_sigma2_is_the_reference_s(case):
    _, w, counts = case
    for m in (1, 2, 4):
        got = thinning.m_dependence_sigma2(w, counts, m, device="cpu")
        want = ref_thinning.m_dependence_sigma2(w, counts, m)
        assert got.dtype == want.dtype == np.float64
        _same(got, want)


def test_the_iid_modes_registry_is_the_reference_s():
    from repro.api.registry import IID_MODES as REF
    assert IID_MODES.names() == REF.names()
    with pytest.raises(KeyError, match="registered iid modes"):
        ScenarioConfig.from_dict({"planner": {"iid_mode": "whiten"}})


# ------------------------------------------------------ the host planner

FIG9_WINDOWS = [dataclasses.replace(w, values=np.array(w.values))
                for w in RefExperiment.from_scenario(RefScenario.from_dict(
                    FIG9)).make_windows()]


def _spy(monkeypatch, mod, name, log):
    fn = getattr(mod, name)

    def spy(*a, **kw):
        out = fn(*a, **kw)
        log.append(out)
        return out

    monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("mode", ["thinning", "m_dependence"])
def test_plan_window_host_under_the_iid_modes_is_the_reference_s(
        mode, x64, monkeypatch):
    seen = {"port": [], "ref": []}
    _spy(monkeypatch, solver, "solve_ipm", seen["port"])
    _spy(monkeypatch, ref_solver, "solve_ipm", seen["ref"])
    for w in FIG9_WINDOWS:
        values = np.asarray(w.values)
        k, n = values.shape
        counts = np.full(k, n, np.int32)
        if w.window_id % 3 == 1:
            counts[w.window_id % k] = 0      # a straggler
        budget = max(int(0.3 * counts.sum()), 2)
        opts = dict(iid_mode=mode, m_lags=1 + w.window_id % 2, seed=13)
        want, wdiag = ref_planner.plan_window(
            RefWindowBatch.from_numpy(values, counts, w.window_id), budget,
            RefPlannerConfig(**opts))
        got, gdiag = planner.plan_window(
            WindowBatch.from_numpy(values, counts, w.window_id), budget,
            PlannerConfig(**opts), device="cpu")
        _same(got.n_real, want.n_real)
        _same(got.n_imputed, want.n_imputed)
        _same(got.predictor, want.predictor)
        for g, r in zip(got.real_values, want.real_values):
            _same(g, r)
        for f in ("mean", "var"):
            _same(got.stats_digest[f], want.stats_digest[f])
        _same(gdiag.allocation.n_real, wdiag.allocation.n_real)
        if mode == "thinning":
            assert gdiag.strides.dtype == wdiag.strides.dtype
            _same(gdiag.strides, wdiag.strides)
            assert (gdiag.strides > 1).any()
        else:
            assert gdiag.strides is None and wdiag.strides is None
    assert len(seen["port"]) == len(seen["ref"]) == len(FIG9_WINDOWS)
    for g, r in zip(seen["port"], seen["ref"]):
        _same(g[0], r[0])                    # the continuous solution
        _same(g[1], r[1])                    # its objective (NaN alike)
        assert g[3] == r[3]


@pytest.mark.parametrize("mode", ["iid", "thinning", "m_dependence"])
def test_fig9_run_is_the_live_reference(mode, x64):
    d = dict(FIG9, planner={"iid_mode": mode, "m_lags": 1})
    want = ref_serialize(RefExperiment.from_scenario(
        RefScenario.from_dict(d)).run(), name=mode, tolerance="exact")
    rep = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                   device="cpu").run()
    got = serialize_report(rep, name=mode, tolerance="exact")
    assert diff_reports(want, got) == []
