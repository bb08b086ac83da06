"""Recovery-time and degradation metrics for chaos runs — the port's
copy of ``repro.chaos.metrics`` (host numpy).

Computed host-side from material both runtimes already produce — the
liveness table, the executed budget history and the (revised) estimate /
truth tables — so the event loop and the scan runtime report through the
identical arithmetic (the same design as ``aggregate_fleet``):

  * ``recovery_windows`` — after each membership change, how many windows
    until the controller's *regional* budget totals settle back within
    ``recovery_tol`` x the group equal share of their new steady state
    (the tail-mean of the membership epoch).  The mean over all change
    events; NaN when membership never changes.
  * ``outage_nrmse`` / ``steady_nrmse`` — per-query NRMSE restricted to
    down / up (window, site) cells.  Both use the paper's eq.-10
    normalization with the denominator taken over *all* windows of the
    stream, so the two numbers are on one scale and their ratio measures
    exactly how much gap-serving degrades during downtime.
  * ``availability_by_region`` — fraction of (window, site) cells up.
  * ``down_site_windows`` / ``gap_served_cells`` — bitwise bookkeeping:
    cells down, and down cells still answered from a stale estimate.
"""
from __future__ import annotations

import numpy as np


def masked_nrmse(est: np.ndarray, tru: np.ndarray,
                 sel: np.ndarray) -> float:
    """Fleet-mean eq.-10 NRMSE over the selected (window, site) cells.

    est/tru: (T, E, k); sel: (T, E) bool.  RMSE runs over the selected
    cells of each (site, stream); the denominator is the stream's
    |mean truth| over ALL windows, keeping outage and steady numbers
    comparable.  NaN when nothing is selected (or nothing was served).
    """
    est = np.asarray(est, np.float64)
    tru = np.asarray(tru, np.float64)
    ok = sel[:, :, None] & np.isfinite(est) & np.isfinite(tru)
    cnt = ok.sum(axis=0)                                   # (E, k)
    sq = np.where(ok, (est - tru) ** 2, 0.0).sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        rmse = np.sqrt(np.where(cnt > 0, sq / np.maximum(cnt, 1), np.nan))
        denom = np.maximum(np.abs(np.nanmean(
            np.where(np.isfinite(tru), tru, np.nan), axis=0)), 1e-9)
        table = rmse / denom
    if not np.isfinite(table).any():
        return float("nan")
    return float(np.nanmean(table))


def recovery_windows(live_tbl: np.ndarray, budget_history: np.ndarray,
                     equal_share: float, *, region_of=None,
                     recovery_tol: float = 0.1) -> float:
    """Mean windows-to-budget-reconvergence over membership changes.

    Convergence is judged on *group* budget totals — per region when
    ``region_of`` is given, else per site.  Redistribution after a
    membership change is a regional phenomenon (the freed budget flows to
    the surviving groups), while individual site budgets keep wandering
    with per-window demand-EWMA noise far larger than any sensible
    tolerance; summing within a group averages that noise out and leaves
    the actual reallocation transient.

    For each window ``c`` where the liveness row differs from the previous
    one, the reference is the mean group allocation over the last quarter
    of the new membership epoch (tail-mean: robust to single-window
    wobble); the recovery time is the first window >= c whose group totals
    are all within ``recovery_tol * equal_share * live_group_size`` of the
    reference.  An epoch that never settles scores its full length.  NaN
    when membership never changes.
    """
    live_tbl = np.asarray(live_tbl, bool)
    hist = np.asarray(budget_history, np.float64)
    T, E = live_tbl.shape
    if region_of is None:
        region_of = np.arange(E)
    region_of = np.asarray(region_of, np.int64)
    n_groups = int(region_of.max()) + 1 if region_of.size else 0
    masks = [region_of == g for g in range(n_groups)]
    sums = np.stack([hist[:, m].sum(axis=1) for m in masks], axis=1)  # (T, G)
    changes = [t for t in range(1, T)
               if not np.array_equal(live_tbl[t], live_tbl[t - 1])]
    if not changes:
        return float("nan")
    bounds = changes + [T]
    recs = []
    for i, c in enumerate(changes):
        end = bounds[i + 1]
        tail = max(1, (end - c) // 4)
        ref = sums[end - tail:end].mean(axis=0)            # (G,)
        n_live = np.array([live_tbl[c, m].sum() for m in masks], np.float64)
        tol = recovery_tol * float(equal_share) * np.maximum(n_live, 1.0)
        rec = end - c                       # epoch never settled
        for t in range(c, end):
            if np.all(np.abs(sums[t] - ref) <= tol):
                rec = t - c + 1
                break
        recs.append(rec)
    return float(np.mean(recs))


def chaos_metrics(live_tbl: np.ndarray, budget_history: np.ndarray,
                  equal_share: float, est: dict, tru: dict, qnames,
                  region_of: np.ndarray, region_names, *,
                  recovery_tol: float = 0.1) -> dict:
    """Roll one chaos run into the recovery/degradation metric dict.

    The returned dict feeds ``aggregate_fleet(chaos=...)``; its keys are
    merged into the fleet result only when present, so ``chaos=None`` runs
    keep the exact legacy key set (golden contract).
    """
    live_tbl = np.asarray(live_tbl, bool)
    region_of = np.asarray(region_of, np.int64)
    down = ~live_tbl
    availability = {
        name: float(live_tbl[:, region_of == r].mean())
        for r, name in enumerate(region_names)}
    first_q = qnames[0]
    served = np.isfinite(np.asarray(est[first_q])).any(axis=-1)   # (T, E)
    return {
        "liveness": live_tbl.astype(np.int64),
        "down_site_windows": int(down.sum()),
        "gap_served_cells": int((served & down).sum()),
        "availability_by_region": availability,
        "recovery_windows": recovery_windows(
            live_tbl, budget_history, equal_share,
            region_of=region_of, recovery_tol=recovery_tol),
        "outage_nrmse": {q: masked_nrmse(est[q], tru[q], down)
                         for q in qnames},
        "steady_nrmse": {q: masked_nrmse(est[q], tru[q], live_tbl)
                         for q in qnames},
    }
