"""Component registries — the namespace behind every stringly-typed field.

The port's copy of ``repro.api.registry``: each pluggable component
registers under a short name, and an unknown name fails fast with the
registered alternatives listed.

The port lands slice by slice, so a registry also knows names that exist
in the reference but are not ported yet (:meth:`Registry.defer`).  Such a
name passes the construction-time spelling check (:meth:`Registry.check`)
but :meth:`Registry.get` raises ``NotImplementedError`` naming the
ROADMAP item that will port it — never a silent fallback to something
else.
"""
from __future__ import annotations

from typing import Any, Optional


class UnknownComponentError(KeyError):
    """Lookup of a name nobody registered; carries the alternatives."""

    def __init__(self, kind: str, name: str, alternatives: tuple):
        self.kind = kind
        self.name = name
        self.alternatives = alternatives
        opts = ", ".join(repr(a) for a in alternatives) or "<none>"
        super().__init__(
            f"unknown {kind} {name!r}; registered {kind}s: {opts}")

    def __str__(self) -> str:      # KeyError.__str__ repr()s the message
        return self.args[0]


class Registry:
    """Name -> component mapping with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: dict[str, Any] = {}
        self._deferred: dict[str, str] = {}

    def register(self, name: str, obj: Optional[Any] = None,
                 aliases: tuple[str, ...] = ()):
        def _add(target):
            for n in (name, *aliases):
                if n in self._items and self._items[n] is not target:
                    raise ValueError(f"{self.kind} {n!r} already registered")
                self._items[n] = target
            return target

        if obj is None:            # decorator form
            return _add
        return _add(obj)

    def defer(self, name: str, roadmap_item: str) -> None:
        """Mark ``name`` as a reference component the port has not ported."""
        self._deferred[name] = roadmap_item

    def check(self, name: str) -> None:
        """Raise :class:`UnknownComponentError` unless ``name`` is registered
        or deferred (the spelling check configs run at construction)."""
        if name not in self._items and name not in self._deferred:
            raise UnknownComponentError(
                self.kind, name,
                tuple(sorted(set(self._items) | set(self._deferred))))

    def get(self, name: str) -> Any:
        try:
            return self._items[name]
        except KeyError:
            if name in self._deferred:
                raise NotImplementedError(
                    f"{self.kind} {name!r} is not ported to repro_torch yet "
                    f"(ROADMAP.md: {self._deferred[name]})") from None
            raise UnknownComponentError(self.kind, name,
                                        self.names()) from None

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._items))

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._items


# The registries this slice uses, populated by their defining modules:
#   MODELS            repro_torch.core.planner   (linear | cubic | mean | multi)
#   EPSILON_POLICIES  repro_torch.core.epsilon   (k_se | alpha | exact_mse)
#   DEPENDENCE        repro_torch.core.stats     (pearson | spearman)
#   SAMPLERS          repro_torch.core.samplers  (srs | stratified | svoila
#                                                 | neyman_cost)
#   BASELINES         repro_torch.core.planner   (srs | approx_iot | s_voila
#                                                 | neyman_cost)
#   QUERIES           repro_torch.core.queries   (AVG | VAR | MIN | MAX
#                                                 | MEDIAN)
#   DATASETS          repro_torch.data.streams   (home | turbine | smartcity
#                                                 | mvn | fleet)
#   DEMAND_SIGNALS    repro_torch.fleet.controller (obs_err | pred_err
#                                                 | max_err)
#   IID_MODES         repro_torch.core.thinning  (none/iid | thinning
#                                                 | m_dependence)
#   SOLVERS           repro_torch.core.solver    (ipm | slsqp | closed_form)
#   ENGINES           repro_torch.planning       (host/host_loop | batched
#                                                 | sharded)
#   RUNTIMES          repro_torch.runtime        (event | scan | scan_steps
#                                                 | scan_sharded)
#   DRIFT_DETECTORS   repro_torch.adaptive.drift (threshold | page_hinkley
#                                                 | always | never)
#   FAULTS            repro_torch.chaos.spec     (flap | join | outage
#                                                 | random)
MODELS = Registry("imputation model")
EPSILON_POLICIES = Registry("epsilon policy")
DEPENDENCE = Registry("dependence measure")
SAMPLERS = Registry("allocation sampler")
BASELINES = Registry("baseline planner")
QUERIES = Registry("query")
IID_MODES = Registry("iid mode")
DATASETS = Registry("dataset")
DEMAND_SIGNALS = Registry("controller demand signal")
SOLVERS = Registry("solver")
ENGINES = Registry("plan engine")
RUNTIMES = Registry("runtime")
DRIFT_DETECTORS = Registry("drift detector")
FAULTS = Registry("fault family")

# the reference's keys (``repro.api.registry.ALL_REGISTRIES``)
ALL_REGISTRIES: dict[str, Registry] = {
    "solvers": SOLVERS,
    "models": MODELS,
    "epsilon_policies": EPSILON_POLICIES,
    "dependence": DEPENDENCE,
    "samplers": SAMPLERS,
    "baselines": BASELINES,
    "queries": QUERIES,
    "datasets": DATASETS,
    "iid_modes": IID_MODES,
    "demand_signals": DEMAND_SIGNALS,
    "engines": ENGINES,
    "runtimes": RUNTIMES,
    "drift_detectors": DRIFT_DETECTORS,
    "faults": FAULTS,
}


def populate() -> dict[str, Registry]:
    """Import every registering module of the port, then return
    ``ALL_REGISTRIES``."""
    import repro_torch.core.planner     # noqa: F401  (models, baselines, ...)
    import repro_torch.core.queries     # noqa: F401
    import repro_torch.data.streams     # noqa: F401
    import repro_torch.fleet.controller  # noqa: F401  (demand signals)
    import repro_torch.planning         # noqa: F401
    import repro_torch.runtime          # noqa: F401
    import repro_torch.adaptive.drift   # noqa: F401
    import repro_torch.chaos.spec       # noqa: F401
    return ALL_REGISTRIES
