"""ChaosSpec — declarative fault injection for a fleet run (the port's
copy of ``repro.chaos.spec``, host numpy, bitwise the reference's tables).

A chaos spec describes *when sites are members of the fleet*: explicit
per-site flap schedules, whole-region outages, mid-run join events and a
deterministic random-flap process.  Everything reduces to one boolean
liveness table ``(T, E)`` (:func:`liveness_table`) computed host-side from
the spec alone, so the event loop and the scan runtime consume the exact
same membership timeline — fault injection can never diverge between the
semantics oracle and the compiled path.

Fault families are registered in the ``FAULTS`` registry ("flap" |
"outage" | "join" | "random"); :class:`ChaosSpec` resolves each family it
uses through the registry at construction, exactly like ``AdaptiveSpec``
resolves its drift detector — a typo fails at config build with the
alternatives listed.

Semantics (as in the reference's docs/chaos.md):

  * the base timeline starts all-up; a ``(window, site, state)`` flap sets
    that site's state from ``window`` onward until its next flap entry;
  * a ``(window, site)`` join keeps the site down for every window before
    ``window`` (joins AND-mask the flap timeline);
  * an ``(start, n_windows, region)`` outage forces every site of the
    region down for ``[start, start + n_windows)`` — down always wins;
  * the random-flap process draws, per absolute window ``w``, a Bernoulli
    ``flap_prob`` per site from ``default_rng((seed, w))`` and keeps hit
    sites down for ``flap_len`` windows.  Keying the RNG on the absolute
    window id makes the table slice-stable: a resumed run recomputes the
    identical rows (``liveness_table(spec, ..., first_window=w0)``).

``ChaosSpec()`` (no faults, ``flap_prob == 0``) is *trivial*: both
runtimes detect ``is_trivial`` and take the legacy code path, so an empty
spec is bit-for-bit identical to ``chaos=None`` by construction.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api.registry import FAULTS


# --------------------------------------------------------------------------
# fault appliers — each entry mutates the (T, E) liveness table in place.
# Registered so the schedule surface is discoverable/validated like every
# other pluggable component (CI walks the registry).
# --------------------------------------------------------------------------

def _apply_flaps(live: np.ndarray, wids: np.ndarray, spec: "ChaosSpec",
                 region_of: np.ndarray) -> None:
    by_site: dict[int, list] = {}
    for w, s, state in spec.flaps:
        by_site.setdefault(int(s), []).append((int(w), state))
    for s, evs in by_site.items():
        for w, state in sorted(evs):
            live[wids >= w, s] = (state == "up")


def _apply_joins(live: np.ndarray, wids: np.ndarray, spec: "ChaosSpec",
                 region_of: np.ndarray) -> None:
    for w, s in spec.joins:
        live[wids < int(w), int(s)] = False


def _apply_outages(live: np.ndarray, wids: np.ndarray, spec: "ChaosSpec",
                   region_of: np.ndarray) -> None:
    for start, dur, r in spec.outages:
        sel = (wids >= int(start)) & (wids < int(start) + int(dur))
        live[np.ix_(sel, region_of == int(r))] = False


def _apply_random(live: np.ndarray, wids: np.ndarray, spec: "ChaosSpec",
                  region_of: np.ndarray) -> None:
    if spec.flap_prob <= 0.0:
        return
    e = live.shape[1]
    first, last = int(wids[0]), int(wids[-1])
    # a flap triggered up to flap_len-1 windows before the slice still
    # overlaps it; walking absolute window ids keeps resumed slices exact
    for w in range(max(0, first - int(spec.flap_len) + 1), last + 1):
        down = (np.random.default_rng((int(spec.seed), w)).random(e)
                < spec.flap_prob)
        if not down.any():
            continue
        sel = (wids >= w) & (wids < w + int(spec.flap_len))
        live[np.ix_(sel, down)] = False


FAULTS.register("flap", _apply_flaps)
FAULTS.register("join", _apply_joins)
FAULTS.register("outage", _apply_outages)
FAULTS.register("random", _apply_random)

# application order: membership timeline first (flap, join), forced
# downtime last (outage, random) — down always wins over an "up" flap
_FAULT_ORDER = ("flap", "join", "outage", "random")


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Fault-injection knobs (``ScenarioConfig.chaos``).

    Absence of this block (``chaos=None``) is the legacy fixed-membership
    behaviour, bit-for-bit.  All schedules use absolute window ids and
    integer site/region indices into the scenario's topology (validated
    against it at ScenarioConfig construction via
    :meth:`validate_topology`).
    """

    flaps: tuple = ()        # ((window, site, "up"|"down"), ...)
    outages: tuple = ()      # ((start, n_windows, region), ...)
    joins: tuple = ()        # ((window, site), ...)
    flap_prob: float = 0.0   # per-window per-site random-down probability
    flap_len: int = 1        # duration (windows) of one random flap
    seed: int = 0            # fault RNG seed (random flaps)

    def __post_init__(self):
        for name in _FAULT_ORDER:
            FAULTS.get(name)             # fail fast with alternatives
        flaps = []
        for entry in self.flaps:
            w, s, state = entry
            if int(w) < 0 or int(s) < 0:
                raise ValueError(f"flap {tuple(entry)!r}: window and site "
                                 f"must be >= 0")
            if state not in ("up", "down"):
                raise ValueError(f"flap {tuple(entry)!r}: state must be "
                                 f"'up' or 'down'")
            flaps.append((int(w), int(s), str(state)))
        outages = []
        for entry in self.outages:
            start, dur, r = entry
            if int(start) < 0 or int(r) < 0:
                raise ValueError(f"outage {tuple(entry)!r}: start and "
                                 f"region must be >= 0")
            if int(dur) < 1:
                raise ValueError(f"outage {tuple(entry)!r}: n_windows must "
                                 f"be >= 1")
            outages.append((int(start), int(dur), int(r)))
        joins = []
        for entry in self.joins:
            w, s = entry
            if int(w) < 0 or int(s) < 0:
                raise ValueError(f"join {tuple(entry)!r}: window and site "
                                 f"must be >= 0")
            joins.append((int(w), int(s)))
        object.__setattr__(self, "flaps", tuple(flaps))
        object.__setattr__(self, "outages", tuple(outages))
        object.__setattr__(self, "joins", tuple(joins))
        if not 0.0 <= float(self.flap_prob) < 1.0:
            raise ValueError(f"flap_prob must lie in [0, 1), got "
                             f"{self.flap_prob!r}")
        if int(self.flap_len) < 1:
            raise ValueError(f"flap_len must be >= 1, got "
                             f"{self.flap_len!r}")

    # ----------------------------------------------------------- properties
    @property
    def is_trivial(self) -> bool:
        """True when the spec injects nothing — both runtimes then take the
        legacy code path, making an empty spec bitwise ``chaos=None``."""
        return (not self.flaps and not self.outages and not self.joins
                and self.flap_prob == 0.0)

    # ----------------------------------------------------------- validation
    def validate_topology(self, n_sites: int, n_regions: int) -> None:
        """Check every site/region index against the fleet geometry."""
        for w, s, _ in self.flaps:
            if s >= n_sites:
                raise ValueError(f"flap targets site {s} but the topology "
                                 f"has {n_sites} sites")
        for w, s in self.joins:
            if s >= n_sites:
                raise ValueError(f"join targets site {s} but the topology "
                                 f"has {n_sites} sites")
        for _, _, r in self.outages:
            if r >= n_regions:
                raise ValueError(f"outage targets region {r} but the "
                                 f"topology has {n_regions} regions")

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "flaps": [list(f) for f in self.flaps],
            "outages": [list(o) for o in self.outages],
            "joins": [list(j) for j in self.joins],
            "flap_prob": self.flap_prob,
            "flap_len": self.flap_len,
            "seed": self.seed,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown ChaosSpec fields: {sorted(extra)}")
        d = dict(d)
        for f in ("flaps", "outages", "joins"):
            if f in d:
                d[f] = tuple(tuple(e) for e in d[f])
        return cls(**d)


def liveness_table(spec: ChaosSpec, n_windows: int, n_sites: int,
                   region_of: np.ndarray,
                   first_window: int = 0) -> np.ndarray:
    """(T, E) bool — row ``t`` is the membership mask of absolute window
    ``first_window + t``.  Deterministic in the spec alone; slices of a
    longer run reproduce exactly (resume-safe by construction)."""
    wids = np.arange(int(first_window), int(first_window) + int(n_windows))
    live = np.ones((int(n_windows), int(n_sites)), bool)
    region_of = np.asarray(region_of, np.int64)
    for name in _FAULT_ORDER:
        FAULTS.get(name)(live, wids, spec, region_of)
    return live


def padded_liveness_table(spec, n_windows: int, n_sites: int,
                          n_padded: int, region_of: np.ndarray,
                          first_window: int = 0) -> np.ndarray:
    """(T, E_pad) bool — the chaos table widened with permanently-dead
    padding columns.

    Sites beyond the declared topology (``n_sites <= s < n_padded`` — the
    rows a sharded runtime adds to round E up to the device multiple) are
    not a separate masking mechanism: they are ordinary dead sites in the
    same liveness mask chaos faults flow through, so every dead-site
    guarantee (zero budget, zero bytes, frozen EWMAs, no ingest) covers
    them with the one code path ``make_window_step(chaos=True)`` already
    implements.  ``spec`` may be None or trivial — all real sites up —
    which is how a fault-free sharded run expresses pure padding.
    """
    if int(n_padded) < int(n_sites):
        raise ValueError(f"n_padded ({n_padded}) must be >= n_sites "
                         f"({n_sites})")
    if spec is None or spec.is_trivial:
        live = np.ones((int(n_windows), int(n_sites)), bool)
    else:
        live = liveness_table(spec, n_windows, n_sites, region_of,
                              first_window=first_window)
    if int(n_padded) > int(n_sites):
        live = np.concatenate(
            [live, np.zeros((int(n_windows), int(n_padded) - int(n_sites)),
                            bool)], axis=1)
    return live
