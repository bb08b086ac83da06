"""The port's host solvers (``repro_torch.core.solver``) against the
reference's, on eq.-1 programs built from windows of the goldens'
datasets.

* The numpy pieces (``build_problem``, ``assemble_constraints``,
  ``feasible_start``, ``round_allocation``) and SLSQP are the reference's
  numpy: bitwise.
* The IPM evaluates the reference's compiled f64 order (the module's
  docstring): the continuous solution bitwise at k = 2, 3, 5 and 8, and
  so the integer allocation.  A stream with N_i = 0 has no strictly
  feasible start, its factorization fails on both sides and both fall
  back to the start.
* The host closed form is the batched solver at a batch of 1: bitwise.

The reference's IPM calls ``jax.experimental.enable_x64``, which JAX 0.9
removed; the ``x64`` fixture points that name at ``jax.enable_x64`` for
each test that needs it (ROADMAP.md queue 3, note a).
"""
import math
from fractions import Fraction

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import epsilon as ref_eps
from repro.core import solver as ref_solver
from repro.core import stats as ref_stats
from repro.core.planner import MODELS as REF_MODELS
from repro.data import streams as ref_streams
from repro_torch.core import solver

# one intra-op thread: the suite runs several pytest workers on the
# host's cores, and a torch thread pool in each oversubscribes them
torch.set_num_threads(1)

DATASETS = {2: (ref_streams.mvn_pair, {"rho": 0.8}),
            3: (ref_streams.home_like, {}),
            5: (ref_streams.smartcity_like, {}),
            8: (ref_streams.turbine_like, {})}


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _inputs(k: int, seed: int, window: int, straggler=None, model="cubic"):
    """The reference host planner's inputs to the program of one window
    (Spearman, k-SE epsilon, the budget net of model uploads)."""
    gen, kw = DATASETS[k]
    vals = np.asarray(gen(n_points=1024, seed=seed, **kw)[0], np.float32)
    win = vals[:, window * 256:(window + 1) * 256]
    counts = np.full(k, 256, np.int32)
    if straggler is not None:
        counts[straggler] = 0
    v, c = jnp.asarray(win), jnp.asarray(counts)
    st = ref_stats.window_stats(v, c, dependence="spearman")
    spec = REF_MODELS.get(model)
    pred = spec.select(st.corr)
    fitted = spec.fit(v, c, pred)
    eps = ref_eps.make_epsilon("k_se", st, 1.0)
    budget = spec.budget_net(max(int(0.3 * counts.sum()), 2), k)
    return st, fitted, eps, budget


def _problem(*args, **kw):
    """The reference's eq.-1 program of one window."""
    return ref_solver.build_problem(*_inputs(*args, **kw))


CASES = [(k, seed, w) for k in (2, 3, 5, 8) for seed in (1, 5)
         for w in (0, 2)]


def _ids(case):
    return "k{}-seed{}-w{}".format(*case)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_the_numpy_pieces_are_the_reference(case):
    inputs = _inputs(*case)
    p = ref_solver.build_problem(*inputs)
    q = solver.build_problem(*inputs)
    for f in ("n_obs", "sigma2", "sigma2_obj", "explained_var", "weights",
              "predictor", "eps", "cost_real"):
        np.testing.assert_array_equal(getattr(q, f), getattr(p, f))
    n0, eps, restored = solver.feasible_start(p)
    n0_r, eps_r, restored_r = ref_solver.feasible_start(p)
    np.testing.assert_array_equal(n0, n0_r)
    np.testing.assert_array_equal(eps, eps_r)
    assert restored == restored_r
    for got, want in zip(solver.assemble_constraints(p, eps),
                         ref_solver.assemble_constraints(p, eps_r)):
        np.testing.assert_array_equal(got, want)


def _ipm_both(p):
    n0, eps, _ = ref_solver.feasible_start(p)
    A, b = ref_solver.assemble_constraints(p, eps)
    q = p.weights ** 2 * p.sigma2_obj
    with jax.enable_x64(True):
        want = np.asarray(ref_solver._ipm(jnp.asarray(q), jnp.asarray(A),
                                          jnp.asarray(b),
                                          jnp.asarray(n0))[0])
    return solver._ipm(q, A, b, n0)[0], want


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_ipm_is_the_reference_s(case):
    k, seed, w = case
    p = _problem(k, seed, w)
    got, want = _ipm_both(p)
    np.testing.assert_array_equal(got, want)
    eps = ref_solver.feasible_start(p)[1]
    for a, b in zip(solver.round_allocation(p, got, eps),
                    ref_solver.round_allocation(p, want, eps)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [3, 5, 8])
def test_a_stream_without_tuples_falls_back_to_the_start(k, x64):
    p = _problem(k, 1, 1, straggler=1)
    got, want = _ipm_both(p)
    assert np.isnan(got).all() and np.isnan(want).all()
    a = solver.solve(p, "ipm")
    b = ref_solver.solve(p, "ipm")
    np.testing.assert_array_equal(a.n_real, np.asarray(b.n_real))
    np.testing.assert_array_equal(a.n_imputed, np.asarray(b.n_imputed))
    assert a.feasible == bool(b.feasible) is False


@pytest.mark.parametrize("method", ["ipm", "slsqp", "closed_form"])
@pytest.mark.parametrize("case", [(3, 5, 0), (5, 1, 2), (8, 5, 0)],
                         ids=_ids)
def test_solve_gives_the_reference_s_allocation(method, case, x64):
    p = _problem(*case)
    got, want = solver.solve(p, method), ref_solver.solve(p, method)
    np.testing.assert_array_equal(got.n_real, np.asarray(want.n_real))
    np.testing.assert_array_equal(got.n_imputed, np.asarray(want.n_imputed))
    np.testing.assert_array_equal(got.eps_used, np.asarray(want.eps_used))
    assert got.objective == np.float32(want.objective)
    assert got.feasible == bool(want.feasible)


@pytest.mark.parametrize("k", [3, 5])
def test_two_predictor_programs(k, x64):
    """The multi model's program: a second 1d row per stream; the host
    closed form runs the reference's eager two-predictor order."""
    p = _problem(k, 1, 0, model="multi")
    assert p.predictor2 is not None
    got, want = _ipm_both(p)
    np.testing.assert_array_equal(got, want)
    for method in ("ipm", "closed_form"):
        got, want = solver.solve(p, method), ref_solver.solve(p, method)
        np.testing.assert_array_equal(got.n_real, np.asarray(want.n_real))
        np.testing.assert_array_equal(got.n_imputed,
                                      np.asarray(want.n_imputed))


def test_fma64_rounds_once():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 8, 3000)
    b = rng.standard_normal(3000)
    c = np.where(rng.uniform(size=3000) < 0.5, -a * b, rng.standard_normal(3000))
    got = solver.fma64(a, b, c)
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, want)
    # the unfused sum differs somewhere: the test data can tell
    assert not np.array_equal(got, a * b + c)


def test_the_merit_s_logarithm_is_the_c_library_s():
    """XLA's f64 log is the C library's; numpy's vectorized one is not
    (so the IPM's barrier takes math.log)."""
    x = np.exp(np.random.default_rng(1).uniform(-30, 30, 200_000))
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jnp.log)(x))
    np.testing.assert_array_equal([math.log(v) for v in x], want)
    assert not np.array_equal(np.log(x), want)


def test_the_ipm_order_matters():
    """The problems above separate the compiled order from a plain one:
    an unfused iterate update moves the solution's last bits."""
    p = _problem(8, 1, 0)
    n0, eps, _ = ref_solver.feasible_start(p)
    A, b = ref_solver.assemble_constraints(p, eps)
    q = p.weights ** 2 * p.sigma2_obj
    want = solver._ipm(q, A, b, n0)[0]
    fused = solver.fma64
    try:
        solver.fma64 = lambda x, y, z: np.asarray(x) * np.asarray(y) + z
        plain = solver._ipm(q, A, b, n0)[0]
    finally:
        solver.fma64 = fused
    assert not np.array_equal(plain, want)
