"""One fleet window: budgets -> plan -> sample -> impute -> serve.

Port of ``repro.runtime.step`` for fleets (E > 1) without chaos, adaptive
re-planning or site sharding.  :func:`make_window_step` builds
``step(state, wid) -> outputs``; the step updates the carry in place.

Sampling reproduces the reference bit for bit: the per-window key is
``fold_in(PRNGKey(seed ^ wid), 0x5A)`` through the threefry replica
(:mod:`repro_torch.runtime.threefry`), and the partial Fisher–Yates
shuffle makes the same swaps in the same order.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.stats import blocked_sum, ipow
from repro_torch.planning.batched import FleetPlan
from repro_torch.runtime import threefry
from repro_torch.runtime.controller import (CtrlParams, controller_budgets,
                                            controller_update)
from repro_torch.runtime.state import RuntimeState

# per-stream model upload footprint, as EdgePayload.wan_bytes() counts it:
# 4 B for a shipped mean, 40 B for the two-predictor model,
# CompactModel.param_bytes() == 28 B otherwise
_PER_MODEL_BYTES = {"mean": 4, "multi": 40, "single": 28}

SCAN_QUERIES = ("AVG", "VAR", "MIN", "MAX")

# profiler range names of the step's stages, in step order
STAGES = ("budgets", "plan", "sample", "impute", "queries", "wan_bytes",
          "controller", "totals")


def stage(name: str):
    """A ``torch.profiler`` range ``window_step/<name>`` around one stage;
    it records only while a profiler runs."""
    return torch.profiler.record_function(f"window_step/{name}")

# the FleetPlan fields the payload replay reads back on the host
PAYLOAD_PLAN_FIELDS = ("n_real", "n_imputed", "predictor", "coeffs", "loc",
                       "scale", "explained_var", "mean", "var")


def _fy_sample(key: tuple, values, n_real):
    """Batched partial Fisher–Yates SRS for every (site, stream) row.

    One uniform per position up front, then for i < max(n_real): swap
    position i with j = i + floor(u[i] * (N - i)) in an int64 index
    permutation — a gather and two scatters over all (E, k) rows per step.
    Position i is final after its step and everything past n_real is
    masked, so stopping at max(n_real) (one host sync) changes nothing.
    """
    e, k, n = values.shape
    u = threefry.uniform(key, (e, k, n), device=values.device)
    perm = torch.arange(n, device=values.device).expand(e, k, n).clone()
    stop = min(int(n_real.max()), n - 1)
    for i in range(stop):
        j = i + (u[..., i] * float(n - i)).to(torch.int32)
        j = torch.clamp(j, max=n - 1).to(torch.int64)[..., None]
        pi = perm[..., i:i + 1].clone()
        pj = torch.gather(perm, -1, j)
        perm.scatter_(-1, j, pi)
        perm[..., i:i + 1] = pj
    shuffled = torch.gather(values, -1, perm)
    keep = torch.arange(n, device=values.device) < n_real[..., None]
    return torch.where(keep, shuffled, torch.zeros_like(shuffled))


def sample_fleet(seed: int, wid: int, values, n_real):
    """SRS without replacement for every site and stream of one window.

    values (E, k, N) f32, n_real (E, k) int -> (E, k, N) f32 where row
    [s, i] holds stream i's n_real[s, i] sampled tuples in draw order,
    then zeros.  Fleets only: the single-edge sampler is not ported yet.
    """
    if values.shape[0] == 1:
        raise NotImplementedError(
            "single-edge (E=1) sampling is not ported to repro_torch yet "
            "(ROADMAP.md: queue 1, 'Single-edge scans')")
    base = threefry.prng_key(np.int32(seed) ^ np.int32(wid))
    return _fy_sample(threefry.fold_in(base, 0x5A), values, n_real)


def _impute(plan: FleetPlan, samples, n_real):
    """(E, k, N) imputed values + the 1d-capped n_imputed + their mask.

    Evaluates each stream's compact model on the front of its predictor's
    real sample, capped at what actually shipped.
    """
    e, k, n = samples.shape
    iota = torch.arange(n, device=samples.device)
    ns = torch.minimum(plan.n_imputed, torch.gather(n_real, 1, plan.predictor))
    xp = torch.gather(samples, 1, plan.predictor[..., None].expand(e, k, n))
    u = (xp - plan.loc[..., None]) / plan.scale[..., None]
    c = plan.coeffs
    imp = (c[..., 0:1] + c[..., 1:2] * u + c[..., 2:3] * ipow(u, 2)
           + c[..., 3:4] * ipow(u, 3))
    mask = iota < ns[..., None]
    return torch.where(mask, imp, torch.zeros_like(imp)), ns, mask


def _masked_queries(parts, qnames):
    """Aggregate queries over masked sample sets, numpy-NaN semantics.

    parts: (values (E, k, N), mask (E, k, N) bool) pairs making up each
    stream's reconstruction.  AVG/VAR two-pass; VAR is ddof=1; empty ->
    NaN, a single sample's VAR -> NaN.
    """
    nan = float("nan")
    tot = sum(m.sum(-1) for _, m in parts).to(torch.float32)
    s1 = sum(blocked_sum(torch.where(m, x, torch.zeros_like(x)))
             for x, m in parts)
    avg = torch.where(tot > 0, s1 / torch.clamp(tot, min=1.0),
                      torch.full_like(s1, nan))
    out = {}
    for q in qnames:
        if q == "AVG":
            out[q] = avg
        elif q == "VAR":
            ss = sum(blocked_sum(ipow(torch.where(m, x - avg[..., None],
                                                  torch.zeros_like(x)), 2))
                     for x, m in parts)
            out[q] = torch.where(tot > 1, ss / torch.clamp(tot - 1.0, min=1.0),
                                 torch.full_like(ss, nan))
        elif q in ("MIN", "MAX"):
            fill = float("inf") if q == "MIN" else float("-inf")
            best = None
            for x, m in parts:
                v = torch.where(m, x, torch.full_like(x, fill))
                v = v.amin(-1) if q == "MIN" else v.amax(-1)
                best = v if best is None else (
                    torch.minimum(best, v) if q == "MIN"
                    else torch.maximum(best, v))
            out[q] = torch.where(tot > 0, best, torch.full_like(best, nan))
        else:                        # validated away at build time
            raise ValueError(f"query {q!r} has no on-device mirror")
    return out


def make_window_step(pool, *, seed: int, plan_fn, qnames, ctrl: CtrlParams,
                     static_exec_budgets: Optional[np.ndarray] = None,
                     collect: str = "estimates"):
    """Build ``step(state, wid) -> outputs`` for one fleet window.

    pool: (P, E, k, N) f32 tensor; window ``wid`` reads slot ``wid % P``.
    plan_fn: (values, counts, budgets) -> FleetPlan.
    static_exec_budgets: host-computed executed budgets (static mode).
    The step updates ``state`` in place (controller EWMAs, running totals,
    the window cursor) and returns the window's output tensors.  Each
    stage of :data:`STAGES` runs inside its own profiler range.
    """
    p_, e, k, n = pool.shape
    dev = pool.device
    counts = torch.full((e, k), n, dtype=torch.int32, device=dev)
    full_mask = torch.ones((e, k, n), dtype=torch.bool, device=dev)
    per_model = _PER_MODEL_BYTES["single"]
    header = 8 + 2 * k
    iota = torch.arange(n, device=dev)
    static_exec = (None if static_exec_budgets is None else
                   torch.as_tensor(static_exec_budgets, dtype=torch.float32,
                                   device=dev))

    def step(state: RuntimeState, wid: int) -> dict:
        values = pool[wid % p_]
        with stage("budgets"):
            raw_b = controller_budgets(state.controller, ctrl)
            if static_exec is not None:
                budgets = static_exec
            else:
                budgets = torch.clamp(torch.floor(raw_b), min=2.0)
        with stage("plan"):
            plan = plan_fn(values, counts, budgets)
        with stage("sample"):
            samples = sample_fleet(seed, wid, values, plan.n_real)
        with stage("impute"):
            imputed, ns, mask_i = _impute(plan, samples, plan.n_real)
            mask_r = iota < plan.n_real[..., None]

        with stage("queries"):
            est = _masked_queries([(samples, mask_r), (imputed, mask_i)],
                                  qnames)
            tru = _masked_queries([(values, full_mask)], qnames)

        with stage("wan_bytes"):
            # WAN accounting — EdgePayload.wan_bytes() per site
            nbytes = (4 * plan.n_real.sum(-1) + header
                      + per_model * (ns > 0).sum(-1)).to(torch.int32)

        with stage("controller"):
            # edge-local error proxy -> controller
            e_avg = est.get("AVG")
            if e_avg is None:
                e_avg = _masked_queries([(samples, mask_r),
                                         (imputed, mask_i)], ("AVG",))["AVG"]
            t_avg = tru.get("AVG")
            if t_avg is None:
                t_avg = _masked_queries([(values, full_mask)],
                                        ("AVG",))["AVG"]
            rel = torch.abs(e_avg - t_avg) / torch.clamp(torch.abs(t_avg),
                                                         min=1e-6)
            obs_err = torch.nanmean(rel, dim=1)
            controller_update(state.controller, ctrl, raw_b, obs_err,
                              plan.r2, plan.objective)
        with stage("totals"):
            state.totals.count = state.totals.count + n
            state.totals.s1 = state.totals.s1 + blocked_sum(values)
            state.totals.s2 = state.totals.s2 + blocked_sum(values * values)
            state.window_id = wid + 1

        out = {"est": est, "tru": tru, "bytes": nbytes, "budgets": budgets,
               "obs_err": obs_err, "r2": plan.r2, "objective": plan.objective}
        if collect == "payloads":
            out["samples"] = samples
            for f in PAYLOAD_PLAN_FIELDS:
                out[f] = getattr(plan, f)
        return out

    return step
