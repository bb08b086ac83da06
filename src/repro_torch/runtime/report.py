"""Fleet result aggregation — port of ``repro.runtime.report`` (host numpy).

Turns per-window estimate/truth tables and per-site byte counters into
the fleet result dict: site and region NRMSE roll-ups, byte and cost
accounting, freshness percentiles.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import queries as Q


def freshness_percentiles(ages_ms: np.ndarray) -> dict:
    """p50/p99 window age at query time over finite entries (ms)."""
    a = np.asarray(ages_ms, np.float64).ravel()
    a = a[np.isfinite(a)]
    if a.size == 0:
        return {"p50_ms": float("nan"), "p99_ms": float("nan")}
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99))}


def aggregate_fleet(*, topology, qnames, est, est_q, tru, ages,
                    bytes_per_site, cost_per_site, gaps, revisions,
                    late_drops, duplicates, arrival_lag_ms, plan_seconds,
                    plan_windows, budget_history, total_tuples,
                    retransmits=0) -> dict:
    """Roll per-window tables into the fleet result dict.

    est/est_q/tru: {query: (T, E, k)} float arrays (NaN where unanswered);
    ages: (T, E) window age at query time (ms); bytes/cost_per_site: (E,)
    totals over the run; budget_history: (T, E) executed budgets.
    """
    E = topology.n_sites
    reg_idx = topology.region_of()
    bytes_per_site = np.asarray(bytes_per_site)
    cost_per_site = np.asarray(cost_per_site, np.float64)

    nrmse_site = {}
    nrmse_site_q = {}
    for q in qnames:
        e_arr = est[q].transpose(1, 2, 0)   # (E, k, T)
        eq_arr = est_q[q].transpose(1, 2, 0)
        t_arr = tru[q].transpose(1, 2, 0)
        nrmse_site[q] = np.asarray(
            [Q.nrmse_table(e_arr[s], t_arr[s]) for s in range(E)])
        nrmse_site_q[q] = np.asarray(
            [Q.nrmse_table(eq_arr[s], t_arr[s]) for s in range(E)])

    region_nrmse = {name: {} for name in topology.region_names}
    for r, name in enumerate(topology.region_names):
        sel = reg_idx == r
        for q in qnames:
            region_nrmse[name][q] = float(np.nanmean(nrmse_site[q][sel]))

    bytes_by_region = {name: 0 for name in topology.region_names}
    cost_by_region = {name: 0.0 for name in topology.region_names}
    for s, site in enumerate(topology.sites):
        bytes_by_region[site.region] += int(bytes_per_site[s])
        cost_by_region[site.region] += float(cost_per_site[s])

    freshness_by_region = {
        name: freshness_percentiles(ages[:, reg_idx == r])
        for r, name in enumerate(topology.region_names)}

    return {
        "fleet_nrmse": {q: float(np.nanmean(nrmse_site[q])) for q in qnames},
        "fleet_nrmse_at_query": {q: float(np.nanmean(nrmse_site_q[q]))
                                 for q in qnames},
        "region_nrmse": region_nrmse,
        "site_nrmse": nrmse_site,
        "wan_bytes": int(bytes_per_site.sum()),
        "wan_bytes_by_region": bytes_by_region,
        "wan_cost": float(cost_per_site.sum()),
        "wan_cost_by_region": cost_by_region,
        "full_bytes": int(total_tuples) * 4,
        "gaps": int(gaps),
        "revisions": int(revisions),
        "late_drops": int(late_drops),
        "duplicates": int(duplicates),
        "retransmits": int(retransmits),
        "freshness_ms": freshness_percentiles(ages),
        "freshness_by_region": freshness_by_region,
        "window_age_ms": ages,
        "site_arrival_lag_ms": arrival_lag_ms,
        "plan_seconds": float(plan_seconds),
        "plan_windows": int(plan_windows),
        "budget_history": np.asarray(budget_history),
    }
