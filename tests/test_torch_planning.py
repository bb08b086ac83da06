"""The port's batched ``fleet_plan`` against ``repro.planning.batched``.

Allocations (``n_real``, ``n_imputed``) and predictors must match bitwise.
Floats that do not pass through the 4x4 normal-equation solve are held to
the sweep's f32 class (``repro.sweep.diff``).  The solve itself is LAPACK
``getrf`` in the reference and ``torch.linalg.solve`` in the port; the
cubic system's conditioning turns their last-bit differences into ~1e-4
relative differences of the coefficients, so the fitted function is
compared through its values on the window (f32 class), and the fused
cubic fit's explained variance, which cancels further, in the ``SOLVE``
class: the reference's own legacy and fused fits differ by up to 8.7e-4
on these inputs.

This file holds the Spearman half of the grid and the engine checks;
``test_torch_planning_pearson.py`` runs the same grid under Pearson.
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.planning.batched import BatchedEngine as RefEngine
from repro.planning.batched import fleet_plan as ref_fleet_plan
from repro.sweep.diff import TOLERANCE_CLASSES
from repro_torch.core.models import evaluate_model
from repro_torch.core.types import CompactModel, PlannerConfig
from repro_torch.data.streams import fleet_like
from repro_torch.planning.batched import FleetPlan, fleet_plan

F32_RTOL, F32_ATOL = TOLERANCE_CLASSES["f32"]
SOLVE_RTOL = 1e-3

DEPENDENCE = "spearman"
GRID = list(itertools.product((DEPENDENCE,), ("linear", "cubic"),
                              ("k_se", "alpha", "exact_mse"), (False, True)))


def _window(seed=3, e=6, k=5, n=64):
    vals, _ = fleet_like(n_sites=e, n_regions=2, k=k, n_points=n, seed=seed)
    counts = np.full((e, k), n, np.int32)
    budgets = np.full((e,), 0.3 * k * n, np.float32)
    return vals, counts, budgets


def _fitted(plan_fields, values):
    model = CompactModel(coeffs=torch.tensor(np.array(plan_fields["coeffs"])),
                         loc=torch.tensor(np.array(plan_fields["loc"])),
                         scale=torch.tensor(np.array(plan_fields["scale"])),
                         explained_var=None, predictor=None)
    pred = torch.tensor(np.array(plan_fields["predictor"])).long()
    v = torch.as_tensor(values)
    xp = torch.gather(v, 1, pred[..., None].expand(*v.shape))
    return evaluate_model(model, xp).numpy()


def check_fleet_plan(dependence, model, policy, use_kernel):
    """One grid cell: the port's plan against the reference's."""
    values, counts, budgets = _window()
    scale = 0.05 if policy == "alpha" else 1.0
    ref = ref_fleet_plan(jnp.asarray(values), jnp.asarray(counts),
                         jnp.asarray(budgets), scale, dependence=dependence,
                         model=model, epsilon_policy=policy,
                         use_kernel=use_kernel, interpret=use_kernel)
    got = fleet_plan(torch.as_tensor(values), torch.as_tensor(counts),
                     torch.as_tensor(budgets), scale, dependence=dependence,
                     model=model, epsilon_policy=policy,
                     use_kernel=use_kernel)
    r = {f: np.asarray(getattr(ref, f)) for f in got.to_numpy()}
    p = got.to_numpy()
    for f in ("n_real", "n_imputed", "predictor"):
        np.testing.assert_array_equal(p[f], r[f], err_msg=f)
    for f in ("mean", "var", "eps", "loc", "scale", "objective"):
        np.testing.assert_allclose(p[f], r[f], rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=f)
    np.testing.assert_allclose(_fitted(p, values), _fitted(r, values),
                               rtol=F32_RTOL, atol=F32_ATOL)
    rtol = SOLVE_RTOL if (model == "cubic" and use_kernel) else F32_RTOL
    for f in ("explained_var", "r2"):
        np.testing.assert_allclose(p[f], r[f], rtol=rtol, atol=F32_ATOL,
                                   err_msg=f)


@pytest.mark.parametrize("dependence,model,policy,use_kernel", GRID,
                         ids=["-".join(map(str, g)) for g in GRID])
def test_fleet_plan_matches_reference(dependence, model, policy, use_kernel):
    check_fleet_plan(dependence, model, policy, use_kernel)


@pytest.mark.parametrize("seed", [7, 11])
def test_fleet_plan_allocations_on_more_windows(seed):
    values, counts, budgets = _window(seed=seed, e=8, k=6, n=128)
    ref = RefEngine().plan_fleet(values, counts, budgets,
                                 _cfg(), use_kernel=True, interpret=True)
    got = fleet_plan(torch.as_tensor(values), torch.as_tensor(counts),
                     torch.as_tensor(budgets), use_kernel=True)
    for f in ("n_real", "n_imputed", "predictor"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f],
                                      err_msg=f)


def _cfg():
    from repro.core.types import PlannerConfig as RefConfig
    return RefConfig(solver="closed_form")


def test_fleet_plan_from_numpy_takes_a_reference_plan():
    values, counts, budgets = _window()
    ref = RefEngine().plan_fleet(values, counts, budgets, _cfg())
    plan = FleetPlan.from_numpy(ref, device="cpu")
    assert plan.n_real.dtype == torch.int32
    assert plan.predictor.dtype == torch.int64
    for f, a in plan.to_numpy().items():
        np.testing.assert_array_equal(a, np.asarray(ref[f]).astype(a.dtype))


def test_unported_configurations_name_their_roadmap_item():
    from repro_torch.api.registry import ENGINES
    engine = ENGINES.get("batched")
    with pytest.raises(NotImplementedError, match="Event path"):
        engine.check(PlannerConfig())           # solver="ipm" by default
    with pytest.raises(NotImplementedError, match="mean and multi"):
        engine.check(PlannerConfig(solver="closed_form", model="multi"))
    with pytest.raises(NotImplementedError, match="Sharding"):
        ENGINES.get("sharded")
