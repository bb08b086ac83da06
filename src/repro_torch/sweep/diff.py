"""Golden-vs-current report diffing with per-field tolerance classes (the
port's copy of ``repro.sweep.diff``).

The question the sweep answers is "did this PR change any number?", so a
diff is never a bare boolean: every comparison that fails produces one
:class:`Drift` row naming the scenario, the field, both values and the
tolerance it was judged under, and :func:`format_drift_table` renders the
lot as the table ``python -m repro_torch.sweep --check`` prints before
exiting nonzero.

Tolerance classes (chosen per scenario, recorded inside each golden):

  ``exact`` — bitwise float equality.  Pure-host event runs: the planner
      is jitted but the trajectory is integer/f64-deterministic, so any
      difference is a semantics change.
  ``ulp``   — rel 1e-9 / abs 1e-12.  E=1 scan replays and fleet event
      runs whose floats pass through jitted f32 reductions: allows
      library-version ULP jitter, nothing a human would call a number
      changing.
  ``f32``   — rel 3e-5 / abs 1e-6.  Fleet scan runs: XLA re-associates
      f32 reductions inside while-loop bodies (documented in
      docs/runtime.md), which can move query tables by a few ULP at f32
      precision; allocation boundaries themselves stay pinned through
      the bitwise counters.

Integer counters are always bitwise regardless of class.  Per-stream
arrays compare by sha256 first; under a float class a hash mismatch
falls back to the stored summaries (nan count bitwise, mean/min/max
within tolerance).
"""
from __future__ import annotations

import dataclasses

# class -> (rtol, atol) for the floats / stream-summary sections
TOLERANCE_CLASSES = {
    "exact": (0.0, 0.0),
    "ulp": (1e-9, 1e-12),
    "f32": (3e-5, 1e-6),
}


@dataclasses.dataclass(frozen=True)
class Drift:
    """One field whose current value escaped its golden tolerance."""

    scenario: str
    field: str
    golden: object
    current: object
    tolerance: str

    @property
    def delta(self) -> str:
        try:
            d = float(self.current) - float(self.golden)
        except (TypeError, ValueError):
            return "-"
        return f"{d:+.3g}"


def _close(a, b, rtol: float, atol: float) -> bool:
    """Scalar closeness with None meaning "not finite / absent"."""
    if a is None or b is None:
        return a is None and b is None
    a, b = float(a), float(b)
    if rtol == 0.0 and atol == 0.0:
        return a == b
    return abs(a - b) <= atol + rtol * max(abs(a), abs(b))


def _tol_label(cls: str) -> str:
    rtol, atol = TOLERANCE_CLASSES[cls]
    return cls if cls == "exact" else f"{cls}(rtol={rtol:g})"


def diff_reports(golden: dict, current: dict) -> list[Drift]:
    """All fields of ``current`` that drifted from ``golden``.

    Key sets must match exactly in every section — a field appearing or
    disappearing is a drift, not a silent schema evolution.
    """
    name = golden.get("scenario", "?")
    cls = golden.get("tolerance", "exact")
    if cls not in TOLERANCE_CLASSES:
        raise ValueError(f"golden for {name!r} names unknown tolerance "
                         f"class {cls!r}; known: "
                         f"{sorted(TOLERANCE_CLASSES)}")
    rtol, atol = TOLERANCE_CLASSES[cls]
    drifts = []

    def _key_mismatches(section: str):
        g = golden.get(section, {})
        c = current.get(section, {})
        for k in sorted(set(g) - set(c)):
            drifts.append(Drift(name, f"{section}:{k}", g[k], "<missing>",
                                "presence"))
        for k in sorted(set(c) - set(g)):
            drifts.append(Drift(name, f"{section}:{k}", "<missing>", c[k],
                                "presence"))
        return {k: (g[k], c[k]) for k in sorted(set(g) & set(c))}

    if golden.get("schema_version") != current.get("schema_version"):
        drifts.append(Drift(name, "schema_version",
                            golden.get("schema_version"),
                            current.get("schema_version"), "presence"))

    for k, (g, c) in _key_mismatches("counters").items():
        if int(g) != int(c):
            drifts.append(Drift(name, f"counters:{k}", int(g), int(c),
                                "bitwise"))

    for k, (g, c) in _key_mismatches("floats").items():
        if not _close(g, c, rtol, atol):
            drifts.append(Drift(name, f"floats:{k}", g, c, _tol_label(cls)))

    for k, (g, c) in _key_mismatches("streams").items():
        if list(g["shape"]) != list(c["shape"]) or g["kind"] != c["kind"]:
            drifts.append(Drift(name, f"streams:{k}",
                                f"{g['kind']}{g['shape']}",
                                f"{c['kind']}{c['shape']}", "shape"))
            continue
        if g["sha256"] == c["sha256"]:
            continue
        # hash moved: bitwise classes (and integer arrays) fail outright;
        # float classes fall back to the summaries within tolerance
        if cls == "exact" or g["kind"] != "float":
            drifts.append(Drift(name, f"streams:{k}",
                                g["sha256"][:12], c["sha256"][:12],
                                "bitwise"))
            continue
        if g["nan_count"] != c["nan_count"]:
            drifts.append(Drift(name, f"streams:{k}/nan_count",
                                g["nan_count"], c["nan_count"], "bitwise"))
        for stat in ("mean", "min", "max"):
            if not _close(g[stat], c[stat], rtol, atol):
                drifts.append(Drift(name, f"streams:{k}/{stat}",
                                    g[stat], c[stat], _tol_label(cls)))
    return drifts


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.10g}"
    return str(v)


def format_drift_table(drifts: list[Drift]) -> str:
    """The readable per-field table --check prints when anything moved."""
    if not drifts:
        return "no drift"
    rows = [("scenario", "field", "golden", "current", "drift", "tolerance")]
    for d in drifts:
        rows.append((d.scenario, d.field, _fmt(d.golden), _fmt(d.current),
                     d.delta, d.tolerance))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    lines.insert(1, "  ".join("-" * w for w in widths))
    n_scen = len({d.scenario for d in drifts})
    return (f"SWEEP DRIFT: {len(drifts)} field(s) across {n_scen} "
            f"scenario(s)\n" + "\n".join(lines))
