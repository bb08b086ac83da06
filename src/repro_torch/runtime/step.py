"""One scan window: budgets -> plan -> sample -> impute -> serve.

Port of ``repro.runtime.step`` for fleets and single edges, with adaptive
re-planning, chaos fault injection and site sharding.
:func:`make_window_step` builds ``step(state, xs) -> outputs``; the step
updates the carry in place.

Sampling reproduces the reference bit for bit through the threefry
replica (:mod:`repro_torch.runtime.threefry`):

  * E = 1: the key is ``PRNGKey(seed ^ wid)`` itself; stream i takes
    ``permutation(sub_i, N)`` with ``sub_i`` from the sequential
    ``split`` chain, as the host planner's sampler draws it;
  * E > 1: the key is ``fold_in(PRNGKey(seed ^ wid), 0x5A)``, and the
    partial Fisher–Yates shuffle makes the same swaps in the same order;
    a rank of a sharded fleet draws the whole fleet's uniforms and keeps
    its rows (``sample_slice``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.adaptive import AdaptiveCarry, gate_update
from repro_torch.chaos.carry import ChaosCarry
from repro_torch.core.samplers import stream_subkeys
from repro_torch.core.stats import blocked_sum, fma, ipow, recip
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
STAGES = ("budgets", "gate", "plan", "sample", "impute", "queries",
          "wan_bytes", "controller", "totals")


def stage(name: str):
    """A ``torch.profiler`` range ``window_step/<name>`` around one stage;
    it records only while a profiler runs."""
    return torch.profiler.record_function(f"window_step/{name}")

# the FleetPlan fields the payload replay reads back on the host
PAYLOAD_PLAN_FIELDS = ("n_real", "n_imputed", "predictor", "coeffs", "loc",
                       "scale", "explained_var", "mean", "var")


def _fy_sample(key: tuple, values, n_real, sample_slice=None):
    """Batched partial Fisher–Yates SRS for every (site, stream) row.

    One uniform per position up front, then for i < max(n_real): swap
    position i with j = i + floor(u[i] * (N - i)) in an int64 index
    permutation — a gather and two scatters over all (E, k) rows per step.
    Position i is final after its step and everything past n_real is
    masked, so stopping at max(n_real) (one host sync) changes nothing.

    ``sample_slice`` = ``(e, e_pad, offset)`` (a rank of the sharded scan
    runtime): ``values`` holds rows ``offset ..`` of a fleet of ``e``
    sites padded to ``e_pad``.  Threefry draws are not prefix-stable
    across shapes, so the rank draws the uniforms at the whole unpadded
    fleet's shape (E, k, N), zero-pads them to ``e_pad`` rows and keeps
    its own: its real rows make the unsharded run's swaps bitwise, and
    padded rows (u = 0) are masked by ``n_real`` = 0.
    """
    e, k, n = values.shape
    if sample_slice is None:
        u = threefry.uniform(key, (e, k, n), device=values.device)
    else:
        e_all, e_pad, offset = sample_slice
        u = threefry.uniform(key, (e_all, k, n), device=values.device)
        u = torch.cat([u, u.new_zeros((e_pad - e_all, k, n))])
        u = u[offset:offset + e]
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


def _permutation_sample(base: tuple, values, n_real):
    """E = 1: stream i's tuples in the order of ``permutation(sub_i, N)``,
    masked past ``n_real[0, i]``."""
    _, k, n = values.shape
    perm = threefry.permutations(stream_subkeys(base, k), n,
                                 device=values.device)
    shuffled = torch.gather(values, -1, perm[None])
    keep = torch.arange(n, device=values.device) < n_real[..., None]
    return torch.where(keep, shuffled, torch.zeros_like(shuffled))


def sample_fleet(seed: int, wid: int, values, n_real, sample_slice=None):
    """SRS without replacement for every site and stream of one window.

    values (E, k, N) f32, n_real (E, k) int -> (E, k, N) f32 where row
    [s, i] holds stream i's n_real[s, i] sampled tuples in draw order,
    then zeros.  One site draws by permutation, a fleet by Fisher–Yates;
    ``sample_slice`` (see :func:`_fy_sample`) marks ``values`` as a shard
    of a fleet, which draws by Fisher–Yates whatever its row count.
    """
    base = threefry.prng_key(np.int32(seed) ^ np.int32(wid))
    if values.shape[0] == 1 and sample_slice is None:
        return _permutation_sample(base, values, n_real)
    return _fy_sample(threefry.fold_in(base, 0x5A), values, n_real,
                      sample_slice)


def draw_fleet_samples(seed: int, wid: int, values, n_real,
                       device=None) -> np.ndarray:
    """Host entry to :func:`sample_fleet` (the fleet event loop's
    ``sampling="device"``): host arrays in (``values`` may also be a
    tensor already on ``device``), host array out, drawn on ``device``;
    bitwise the streams the scan consumes."""
    dev = resolve_device(device)
    v = torch.as_tensor(values, dtype=torch.float32, device=dev)
    nr = torch.as_tensor(n_real, dtype=torch.int32, device=dev)
    return sample_fleet(int(seed), int(wid), v, nr).cpu().numpy()


def _impute(plan: FleetPlan, samples, n_real, *, multi: bool, mean: bool):
    """(E, k, N) imputed values + the 1d-capped n_imputed + their mask.

    Evaluates each stream's compact model on the front of its predictor's
    real sample (both predictors' under the multi model), capped at what
    actually shipped; mean imputation repeats the window mean.
    """
    e, k, n = samples.shape
    iota = torch.arange(n, device=samples.device)
    c = plan.coeffs

    def front(pred):
        return torch.gather(samples, 1, pred[..., None].expand(e, k, n))

    if multi:
        p0, p1 = plan.predictor[..., 0], plan.predictor[..., 1]
        ns = torch.minimum(plan.n_imputed,
                           torch.minimum(torch.gather(n_real, 1, p0),
                                         torch.gather(n_real, 1, p1)))
        u = (front(p0) - plan.loc[..., 0:1]) / plan.scale[..., 0:1]
        v = (front(p1) - plan.loc[..., 1:2]) / plan.scale[..., 1:2]
        imp = (c[..., 0:1] + c[..., 1:2] * u + c[..., 2:3] * v
               + c[..., 3:4] * u * v)
    else:
        ns = torch.minimum(plan.n_imputed,
                           torch.gather(n_real, 1, plan.predictor))
        if mean:
            imp = plan.mean[..., None].expand(e, k, n)
        else:
            u = ((front(plan.predictor) - plan.loc[..., None])
                 / plan.scale[..., None])
            # the reference's compiler contracts the polynomial into
            # fused multiply-adds, term by term
            imp = fma(c[..., 3:4], ipow(u, 3),
                      fma(c[..., 2:3], ipow(u, 2),
                          fma(c[..., 1:2], u, c[..., 0:1])))
    mask = iota < ns[..., None]
    return torch.where(mask, imp, torch.zeros_like(imp)), ns, mask


def _masked_queries(parts, qnames, n_static: Optional[int] = None):
    """Aggregate queries over masked sample sets, numpy-NaN semantics.

    parts: (values (E, k, N), mask (E, k, N) bool) pairs making up each
    stream's reconstruction.  AVG/VAR two-pass; VAR is ddof=1; empty ->
    NaN, a single sample's VAR -> NaN.  ``n_static``: the one part's mask
    is all true, so every count is this constant, and the reference's
    compiler turns the divisions by it into multiplications by the
    rounded reciprocal (:func:`~repro_torch.core.stats.recip`).
    """
    nan = float("nan")
    tot = sum(m.sum(-1) for _, m in parts).to(torch.float32)
    s1 = sum(blocked_sum(torch.where(m, x, torch.zeros_like(x)))
             for x, m in parts)
    if n_static is not None:
        avg = s1 * recip(max(n_static, 1))
    else:
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
            if n_static is not None:
                out[q] = (ss * recip(n_static - 1) if n_static > 1
                          else torch.full_like(ss, nan))
            else:
                out[q] = torch.where(tot > 1,
                                     ss / torch.clamp(tot - 1.0, min=1.0),
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


def make_window_step(pool, *, seed: int, plan_fn, qnames, multi: bool,
                     mean: bool, ctrl: CtrlParams,
                     static_exec_budgets: Optional[np.ndarray] = None,
                     collect: str = "estimates", adaptive=None,
                     use_kernel=None, chaos: bool = False, shard=None):
    """Build ``step(state, xs) -> outputs`` for one window of E sites.

    pool: (P, E, k, N) f32 tensor; window ``wid`` reads slot ``wid % P``.
    plan_fn: (values, counts, budgets) -> FleetPlan.
    multi / mean: the model family's imputation (``ModelSpec`` flags).
    static_exec_budgets: host-computed executed budgets (static mode).
    adaptive: an :class:`~repro_torch.adaptive.AdaptiveSpec`, or None to
    plan every window.  With a spec the ``gate`` stage folds the window
    into ``state.adaptive``'s drift gate (through the ``stream_stats_fleet``
    kernel unless ``use_kernel`` is False) and the ``plan`` stage plans
    only when the gate says so, else reuses the cached plan.  The
    reference branches with ``lax.cond``; here the branch reads the
    decision on the host, one read a window.
    chaos: when True, ``xs`` is ``(wid, live)`` with ``live`` the
    window's (E,) bool membership mask on the device, else a bare ``wid``.
    The step then masks dead sites end to end: a budget of 0 (their share
    water-filled over the live fleet, no >= 2 clamp), no samples and no
    bytes, not even a header (``n_real`` is masked after the plan, so live
    rows' Fisher–Yates draws stay bitwise), NaN raw estimates (which hold
    the controller's EWMAs), no ingest, and served estimates from the
    ``state.chaos`` gap-serving memory.  When False no mask is applied.
    shard: a :class:`~repro_torch.parallel.SiteShard` when ``pool``,
    ``state`` and ``live`` hold one rank's rows of a sharded fleet (the
    sharded scan runtime; ``chaos`` is then True, padding being dead
    sites).  The water-fill gathers the fleet's demand and the drift gate
    closes its deviation max over the group; the Fisher–Yates draw keeps
    this rank's rows of the fleet's uniforms.  Everything else is per
    site.
    The step updates ``state`` in place (controller EWMAs, running totals,
    the window cursor) and returns the window's output tensors.  Each
    stage of :data:`STAGES` runs inside its own profiler range.
    """
    p_, e, k, n = pool.shape
    dev = pool.device
    counts = torch.full((e, k), n, dtype=torch.int32, device=dev)
    full_mask = torch.ones((e, k, n), dtype=torch.bool, device=dev)
    per_model = _PER_MODEL_BYTES["mean" if mean else
                                 ("multi" if multi else "single")]
    header = 8 + 2 * k
    iota = torch.arange(n, device=dev)
    static_exec = (None if static_exec_budgets is None else
                   torch.as_tensor(static_exec_budgets, dtype=torch.float32,
                                   device=dev))
    sample_slice = (None if shard is None else
                    (shard.n_sites, shard.n_padded, shard.offset))

    def step(state: RuntimeState, xs) -> dict:
        if chaos:
            wid, live = xs
            livf = live.to(torch.float32)
        else:
            wid, live = xs, None
        values = pool[wid % p_]
        with stage("budgets"):
            raw_b = controller_budgets(state.controller, ctrl, live=live,
                                       shard=shard)
            if static_exec is not None:
                budgets = static_exec if live is None else static_exec * livf
            elif live is None:
                budgets = torch.clamp(torch.floor(raw_b), min=2.0)
            else:
                # the >= 2 clamp would bring dead sites' zero budgets back
                budgets = torch.where(live,
                                      torch.clamp(torch.floor(raw_b), min=2.0),
                                      torch.zeros_like(raw_b))
        if adaptive is None:
            with stage("plan"):
                plan = plan_fn(values, counts, budgets)
        else:
            with stage("gate"):
                gate, replan = gate_update(adaptive, state.adaptive.gate,
                                           values, counts,
                                           use_kernel=use_kernel,
                                           shard=shard)
                replan = bool(replan)
            with stage("plan"):
                # no stage writes into a plan's tensors, so the cached plan
                # is kept as it is
                plan = (plan_fn(values, counts, budgets) if replan
                        else state.adaptive.plan)
            state.adaptive = AdaptiveCarry(gate=gate, plan=plan)
        if live is not None:
            # the solver floors every stream at one sample even on a zero
            # budget; a dead site ships nothing
            plan = dataclasses.replace(
                plan, n_real=plan.n_real * live[:, None].to(plan.n_real.dtype))
        with stage("sample"):
            samples = sample_fleet(seed, wid, values, plan.n_real,
                                   sample_slice)
        with stage("impute"):
            imputed, ns, mask_i = _impute(plan, samples, plan.n_real,
                                          multi=multi, mean=mean)
            mask_r = iota < plan.n_real[..., None]

        with stage("queries"):
            est = _masked_queries([(samples, mask_r), (imputed, mask_i)],
                                  qnames)
            tru = _masked_queries([(values, full_mask)], qnames, n)
            if live is None:
                served = est
            else:
                # gap serving: a dead site answers from the freshest
                # estimate that ever arrived; live sites refresh it
                served = {q: torch.where(live[:, None], est[q],
                                         state.chaos.served[q])
                          for q in qnames}
                state.chaos = ChaosCarry(live=live, served=served)

        with stage("wan_bytes"):
            # WAN accounting — EdgePayload.wan_bytes() per site
            nbytes = (4 * plan.n_real.sum(-1) + header
                      + per_model * (ns > 0).sum(-1)).to(torch.int32)
            if live is not None:
                nbytes = torch.where(live, nbytes, torch.zeros_like(nbytes))

        with stage("controller"):
            # edge-local error proxy -> controller
            e_avg = est.get("AVG")
            if e_avg is None:
                e_avg = _masked_queries([(samples, mask_r),
                                         (imputed, mask_i)], ("AVG",))["AVG"]
            t_avg = tru.get("AVG")
            if t_avg is None:
                t_avg = _masked_queries([(values, full_mask)], ("AVG",),
                                        n)["AVG"]
            rel = torch.abs(e_avg - t_avg) / torch.clamp(torch.abs(t_avg),
                                                         min=1e-6)
            obs_err = torch.nanmean(rel, dim=1)
            controller_update(state.controller, ctrl, raw_b, obs_err,
                              plan.r2, plan.objective, live=live)
        with stage("totals"):
            t, s1, s2 = n, blocked_sum(values), blocked_sum(values * values)
            if live is not None:             # dead sites ingest nothing
                lcol = livf[:, None]
                t, s1, s2 = n * lcol, s1 * lcol, s2 * lcol
            state.totals.count = state.totals.count + t
            state.totals.s1 = state.totals.s1 + s1
            state.totals.s2 = state.totals.s2 + s2
            state.window_id = wid + 1

        out = {"est": served, "tru": tru, "bytes": nbytes,
               "budgets": budgets, "obs_err": obs_err, "r2": plan.r2,
               "objective": plan.objective}
        if live is not None:
            out["live"] = live
        if collect == "payloads":
            out["samples"] = samples
            for f in PAYLOAD_PLAN_FIELDS:
                out[f] = getattr(plan, f)
        return out

    return step
