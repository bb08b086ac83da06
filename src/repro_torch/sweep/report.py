"""RunReport -> stable golden JSON (port of ``repro.sweep.report``).

The same report gives the same dict as the reference's serializer,
hashes included, so the port's reports diff against reference reports
field by field.

One :class:`~repro_torch.api.experiment.RunReport` becomes one flat, sorted,
diffable dict with every comparable number sorted into a *tolerance
section*:

  * ``counters`` — integer bookkeeping (WAN bytes, gaps, revisions,
    late drops, duplicates, retransmits, per-region byte totals).  Always
    compared bitwise: a counter that moves by one is a semantics change,
    never noise.
  * ``floats``   — scalar accuracy/cost/freshness summaries (per-query
    NRMSE, wan_cost, freshness percentiles, per-region roll-ups).
    Compared under the scenario's tolerance class (see
    :mod:`repro_torch.sweep.diff`): ``exact`` for pure-host event runs,
    ``ulp`` for E=1 scan replays (the replay is the event path's own
    code; only library-version ULP jitter is allowed), ``f32`` for fleet
    scan runs
    (XLA re-associates f32 reductions inside while-loop bodies —
    docs/runtime.md).
  * ``streams``  — per-stream arrays (``nrmse_per_stream``, window ages,
    budget history, revised flags), committed as a sha256 over the
    canonical f64 little-endian bytes plus a small summary (shape, dtype
    class, nan count, nan-aware mean/min/max).  Hash equality is the
    fast path; under a float tolerance class a hash mismatch falls back
    to comparing the summaries within tolerance, so an ULP-level wiggle
    in one table cell does not fail the sweep while a real drift does.

Fields that are *not* functions of the scenario (wall-clock timings like
``plan_seconds``/``windows_per_sec``) are deliberately absent: a golden
must only ever change when a number the paper cares about changes.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np

REPORT_SCHEMA_VERSION = 1

# raw-dict integer counters lifted verbatim (bitwise class)
_COUNTER_FIELDS = ("n_sites", "wan_bytes", "full_bytes", "gaps",
                   "revisions", "late_drops", "duplicates", "retransmits")

# adaptive re-planning counters (repro_torch.adaptive) — emitted only when
# the run actually produced them, so plan-every-window goldens keep their
# legacy key set while any silent change in re-plan behavior on an
# adaptive scenario is a bitwise drift
_ADAPTIVE_COUNTER_FIELDS = ("planner_invocations", "plans_reused",
                            "drift_fires")

# chaos fault-injection counters (the chaos subsystem) — same
# only-when-present contract: fixed-membership goldens keep their legacy
# key set
_CHAOS_COUNTER_FIELDS = ("down_site_windows", "gap_served_cells")

# raw-dict arrays worth pinning when present (event + scan runtimes);
# "liveness" is the chaos membership table — bitwise, a fault schedule
# that drifts by one cell is a semantics change
_STREAM_RAW_FIELDS = ("window_age_ms", "revised_windows", "budget_history",
                      "liveness")


def _jsonf(v) -> float | None:
    """Floats for JSON: non-finite -> None (strict-JSON safe, compares
    exactly as "both absent")."""
    v = float(v)
    return v if math.isfinite(v) else None


def _array_digest(arr: np.ndarray) -> dict:
    """Canonical hash + summary of one per-stream array.

    Float arrays are canonicalized to little-endian f64 before hashing so
    the digest is dtype- and platform-stable; bool/int arrays keep an
    integer canonical form (and are always compared bitwise).
    """
    a = np.asarray(arr)
    if a.dtype.kind in "fc":
        canon = np.ascontiguousarray(a, dtype="<f8")
        kind = "float"
    else:
        canon = np.ascontiguousarray(a, dtype="<i8")
        kind = "int"
    sha = hashlib.sha256(canon.tobytes()).hexdigest()
    if kind == "float":
        finite = canon[np.isfinite(canon)]
        summary = {
            "nan_count": int(np.size(canon) - np.size(finite)),
            "mean": _jsonf(np.mean(finite)) if finite.size else None,
            "min": _jsonf(np.min(finite)) if finite.size else None,
            "max": _jsonf(np.max(finite)) if finite.size else None,
        }
    else:
        summary = {
            "nan_count": 0,
            "mean": _jsonf(np.mean(canon)) if canon.size else None,
            "min": int(np.min(canon)) if canon.size else None,
            "max": int(np.max(canon)) if canon.size else None,
        }
    return {"shape": list(a.shape), "kind": kind, "sha256": sha, **summary}


def serialize_report(report, *, name: str, tolerance: str) -> dict:
    """One RunReport -> the golden dict (JSON-ready, sorted downstream).

    ``tolerance`` names the float tolerance class the diff applies
    (``exact`` | ``ulp`` | ``f32``); it is recorded in the golden so the
    checker needs nothing but the two files.
    """
    raw = report.raw

    counters = {f: int(raw.get(f, getattr(report, f, 0)) or 0)
                for f in _COUNTER_FIELDS}
    counters["n_sites"] = int(report.n_sites)
    counters["wan_bytes"] = int(report.wan_bytes)
    counters["full_bytes"] = int(report.full_bytes)
    for region, b in sorted(report.wan_bytes_by_region.items()):
        counters[f"wan_bytes_by_region/{region}"] = int(b)
    for f in _ADAPTIVE_COUNTER_FIELDS:
        if f in raw:
            counters[f] = int(raw[f])
    for f in _CHAOS_COUNTER_FIELDS:
        if f in raw:
            counters[f] = int(raw[f])

    floats = {}
    for q, v in sorted(report.nrmse.items()):
        floats[f"nrmse/{q}"] = _jsonf(v)
    for q, v in sorted(report.nrmse_at_query.items()):
        floats[f"nrmse_at_query/{q}"] = _jsonf(v)
    floats["wan_cost"] = _jsonf(report.wan_cost)
    for region, c in sorted(report.wan_cost_by_region.items()):
        floats[f"wan_cost_by_region/{region}"] = _jsonf(c)
    for p, v in sorted(report.freshness_ms.items()):
        floats[f"freshness_ms/{p}"] = _jsonf(v)
    for region, qs in sorted(report.region_nrmse.items()):
        for q, v in sorted(qs.items()):
            floats[f"region_nrmse/{region}/{q}"] = _jsonf(v)
    if "detection_lag_windows" in raw:
        floats["detection_lag_windows"] = _jsonf(raw["detection_lag_windows"])
    if "recovery_windows" in raw:
        floats["recovery_windows"] = _jsonf(raw["recovery_windows"])
    for table in ("outage_nrmse", "steady_nrmse"):
        if table in raw:
            for q, v in sorted(raw[table].items()):
                floats[f"{table}/{q}"] = _jsonf(v)
    if "availability_by_region" in raw:
        for region, v in sorted(raw["availability_by_region"].items()):
            floats[f"availability/{region}"] = _jsonf(v)

    streams = {}
    for q, arr in sorted(report.nrmse_per_stream.items()):
        streams[f"nrmse_per_stream/{q}"] = _array_digest(arr)
    for f in _STREAM_RAW_FIELDS:
        if f in raw:
            streams[f] = _array_digest(raw[f])

    return {
        "schema_version": REPORT_SCHEMA_VERSION,
        "scenario": name,
        "tolerance": tolerance,
        "counters": counters,
        "floats": floats,
        "streams": streams,
    }
