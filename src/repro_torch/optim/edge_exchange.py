"""The paper's edge sampling applied to cross-pod gradient exchange (port
of ``repro.optim.edge_exchange``).

Each parameter tensor's per-pod gradient is a dependent stream; one
optimizer step is a tuple; a pod is an edge and the cross-pod link is the
WAN.  Tensors on which the pods agree are skipped and imputed at the
receiver from a value every pod already holds (the Adam first moment, or
zero); only the tensors on which they disagree cross the pod boundary.
:class:`EdgeGradController` solves eq. 1 over the tensors each window,
with the f64 IPM of :mod:`repro_torch.core.solver`.

A *stream* is one leaf of the reference's stacked parameter tree, keyed
by the reference's ``keystr`` of it (``"['blocks'][0]['mixer']['wq']"``).
The port keeps one dict per layer, so with the model's config a stream
is the list of the port's per-layer tensors that the reference stacks
into that leaf (block ``i`` of position ``pos`` is layer
``i * period + pos``, :mod:`repro_torch.models.convert`), in block order;
without one, every tensor of the tree is a stream of its own, keyed by
its path in that tree.  Streams come in the reference's flattening
order (dict keys sorted, sequences by index): the controller's stand-in
model takes each stream's predictor from that order.

Two exchanges, as in the reference:

* :func:`make_stacked_exchange` takes the P pods' gradients in one
  process, as a list of P trees (the reference stacks them on a leading
  pod axis; a list keeps the gradient memory at P trees);
* :func:`make_grad_exchange` runs on every rank of a
  ``torch.distributed`` group, one pod a rank (the reference's use inside
  ``shard_map`` over the ``"pod"`` axis): a synced stream is all-reduced,
  a skipped one sends nothing.

The pod mean follows the reference's compiled order: the pods' gradients
widened to f32, summed in pod order, multiplied by the f32 value of
1 / P and rounded back to the gradients' type.  Telemetry (the paper's
compact model upload) is two f32 scalars a stream: ``pod_disagreement``,
the mean over pods of the sum of (g_p - mean)^2, and ``pod_magnitude``,
the sum of mean^2; both 0 on skipped streams.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import epsilon as eps_mod
from repro_torch.core import solver as solver_mod
from repro_torch.core.types import StreamStats
from repro_torch.optim.adamw import tree_leaves, tree_unflatten

IMPUTATIONS = ("momentum", "zero")


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Per-stream sync decision (stream key -> bool; a key not in the
    dict syncs)."""

    sync: dict
    window: int = 50    # steps between re-plans
    measure: bool = True

    def fraction_synced(self, sizes: dict) -> float:
        tot = sum(sizes.values())
        s = sum(sz for p, sz in sizes.items() if self.sync.get(p, True))
        return s / max(tot, 1)


class _Stream(list):
    """The flattening indices of one stream's tensors, in block order."""


def stream_leaves(tree, cfg=None) -> dict:
    """Stream key -> the indices, into ``tree_leaves(tree)``, of the
    stream's tensors, in the reference's flattening order.  ``cfg``: the
    model's config, for a tree in the port's per-layer layout (params,
    gradients or moments); None takes ``tree`` as it is."""
    n = len(tree_leaves(tree))
    indexed = tree_unflatten(tree, range(n))
    if cfg is not None:
        from repro_torch.models.convert import _stacked
        indexed = _stacked(indexed, cfg, lambda i: _Stream([i]), _Stream)
    out = dict(_keyed(indexed, ""))
    covered = sorted(i for idx in out.values() for i in idx)
    if covered != list(range(n)):
        raise ValueError("the tree's tensors do not map one to one onto "
                         "the streams of the reference's layout")
    return out


def _keyed(tree, prefix: str):
    if isinstance(tree, _Stream):
        yield prefix, list(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _keyed(t, f"{prefix}[{i}]")
    else:
        yield prefix, [tree]


def stream_sizes(tree, cfg=None) -> dict:
    """Stream key -> its element count (the stacked leaf's: the sum over
    its layers), in stream order."""
    leaves = tree_leaves(tree)
    return {k: sum(leaves[i].numel() for i in idx)
            for k, idx in stream_leaves(tree, cfg).items()}


def full_sync_plan(tree, cfg=None) -> ExchangePlan:
    """Every stream syncs every step (the paper-faithful baseline)."""
    return ExchangePlan(sync={k: True for k in stream_leaves(tree, cfg)})


def synced_bytes(plan: ExchangePlan, tree, cfg=None) -> tuple[int, int]:
    """(bytes of the streams ``plan`` syncs, bytes of every stream) of
    ``tree``'s tensors: what one rank puts into the all-reduce a step
    under ``plan`` and under full sync."""
    leaves = tree_leaves(tree)
    synced = total = 0
    for k, idx in stream_leaves(tree, cfg).items():
        b = sum(leaves[i].numel() * leaves[i].element_size() for i in idx)
        total += b
        synced += b if plan.sync.get(k, True) else 0
    return synced, total


def _check_imputation(imputation: str) -> None:
    if imputation not in IMPUTATIONS:
        raise ValueError(f"imputation {imputation!r}: one of {IMPUTATIONS}")


def _impute(m: torch.Tensor, like: torch.Tensor, imputation: str):
    # a copy: the optimizer scales an f32 gradient in place
    if imputation == "momentum":
        return m.to(like.dtype, copy=True)
    return torch.zeros_like(like)


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device)


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x))


def make_stacked_exchange(plan: ExchangePlan, imputation: str = "momentum",
                          cfg=None):
    """``exchange(grads_p, momentum) -> (grads, metrics)`` over the P
    pods' gradients in one process: ``grads_p`` a list of P trees of one
    structure, ``momentum`` a tree of it (f32).  A synced stream takes the
    pod mean; a skipped one the momentum cast to the gradient's type
    (``"momentum"``) or zeros (``"zero"``).  ``metrics``:
    ``pod_disagreement`` and ``pod_magnitude``, (streams,) f32, or {} when
    the plan does not measure.  ``cfg`` as in :func:`stream_leaves`."""
    _check_imputation(imputation)

    @torch.no_grad()
    def exchange(grads_p, momentum):
        n_pods = len(grads_p)
        inv = float(np.float32(1.0 / n_pods))
        pods = [tree_leaves(g) for g in grads_p]
        m_leaves = tree_leaves(momentum)
        out = [None] * len(m_leaves)
        num, den = [], []
        for key, idx in stream_leaves(grads_p[0], cfg).items():
            like = pods[0][idx[0]]
            if not plan.sync.get(key, True):
                for i in idx:
                    out[i] = _impute(m_leaves[i], pods[0][i], imputation)
                num.append(_zero(like))
                den.append(_zero(like))
                continue
            per_pod = [_zero(like) for _ in range(n_pods)]
            mag = _zero(like)
            for i in idx:
                gs = [pod[i] for pod in pods]
                s = gs[0].to(torch.float32, copy=True)
                for g in gs[1:]:
                    s.add_(g)
                mean = s.mul_(inv).to(gs[0].dtype)
                out[i] = mean
                if plan.measure:
                    mf = mean.float()
                    for p, g in enumerate(gs):
                        per_pod[p] += _sq_sum(g.float() - mf)
                    mag += _sq_sum(mf)
            if plan.measure:
                total = per_pod[0]
                for t in per_pod[1:]:
                    total = total + t
                num.append(total * inv)
                den.append(mag)
            else:
                num.append(_zero(like))
                den.append(_zero(like))
        metrics = ({"pod_disagreement": torch.stack(num),
                    "pod_magnitude": torch.stack(den)}
                   if plan.measure else {})
        return tree_unflatten(grads_p[0], out), metrics

    return exchange


def make_grad_exchange(plan: ExchangePlan, group=None,
                       imputation: str = "momentum", cfg=None):
    """``exchange(grads, momentum) -> (grads, metrics)`` on every rank of
    ``group`` (a ``torch.distributed`` process group; None: the default
    one), each rank one pod holding its own gradients.  A synced stream is
    all-reduced (f32 sum, times the f32 value of 1 / world size, rounded
    to the gradient's type: the stacked exchange's mean); a skipped one is
    imputed as in :func:`make_stacked_exchange`, with nothing sent.  The
    telemetry vectors are all-reduced the same way, so every rank ends
    with the same gradients and metrics.  Over gloo the tensors may lie on
    the CPU or on a card; NCCL needs each rank on a card of its own."""
    _check_imputation(imputation)
    import torch.distributed as dist

    @torch.no_grad()
    def exchange(grads, momentum):
        inv = float(np.float32(1.0 / dist.get_world_size(group)))
        leaves = tree_leaves(grads)
        m_leaves = tree_leaves(momentum)
        out = [None] * len(leaves)
        num, den = [], []
        for key, idx in stream_leaves(grads, cfg).items():
            like = leaves[idx[0]]
            n_s, d_s = _zero(like), _zero(like)
            if not plan.sync.get(key, True):
                for i in idx:
                    out[i] = _impute(m_leaves[i], leaves[i], imputation)
            else:
                for i in idx:
                    s = leaves[i].to(torch.float32, copy=True)
                    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
                    mean = s.mul_(inv).to(leaves[i].dtype)
                    out[i] = mean
                    mf = mean.float()
                    n_s += _sq_sum(leaves[i].float() - mf)
                    d_s += _sq_sum(mf)
            num.append(n_s)
            den.append(d_s)
        metrics = {}
        if plan.measure and num:
            vec = torch.stack(num + den)
            dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=group)
            vec.mul_(inv)
            metrics = {"pod_disagreement": vec[:len(num)],
                       "pod_magnitude": vec[len(num):]}
        return tree_unflatten(grads, out), metrics

    return exchange


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _f32(x) -> torch.Tensor:
    # the reference builds its statistics with ``jnp.asarray``: f32
    return torch.as_tensor(np.asarray(x, np.float32))


@dataclasses.dataclass
class _StandIn:
    """The compact model eq. 1 reads: each stream's explained variance
    and predictor."""

    explained_var: np.ndarray
    predictor: np.ndarray


@dataclasses.dataclass
class EdgeGradController:
    """Host-side window planner (Algorithm 1 over gradient streams).

    ``observe`` sums each step's telemetry; ``replan`` solves eq. 1 over
    the streams (sigma^2 the mean disagreement, the identity model's
    explained variance ``max(0, magnitude - disagreement)``, each stream's
    first sample free, a full sync costing ``n_pods - 1`` tensor sizes
    within ``dcn_budget_fraction`` of full sync's bytes) and returns the
    next :class:`ExchangePlan`.  ``sizes``: stream key -> element count,
    in stream order."""

    sizes: dict
    dcn_budget_fraction: float = 0.5
    epsilon_se: float = 1.0
    n_pods: int = 2
    window: int = 50
    _disagreement: Optional[np.ndarray] = None
    _magnitude: Optional[np.ndarray] = None
    _count: int = 0

    def observe(self, metrics: dict) -> None:
        if "pod_disagreement" not in metrics:
            return
        d = _host(metrics["pod_disagreement"])
        m = _host(metrics["pod_magnitude"])
        if self._disagreement is None:
            self._disagreement = d * 0.0
            self._magnitude = m * 0.0
        self._disagreement += d
        self._magnitude += m
        self._count += 1

    def replan(self, current: ExchangePlan) -> ExchangePlan:
        """Solve eq. 1 over the streams; the window's sums start over.
        At least the stream of largest disagreement syncs."""
        paths = list(self.sizes.keys())
        k = len(paths)
        if self._count == 0 or k == 0:
            return current
        sig2 = np.maximum(self._disagreement / self._count, 1e-20)
        mag = np.maximum(self._magnitude / self._count, 1e-20)
        V = np.clip(mag - sig2, 0.0, sig2 * (1 - 1e-9))

        sizes = np.asarray([self.sizes[p] for p in paths], np.float64)
        total = float(sizes.sum())
        budget = self.dcn_budget_fraction * total * (self.n_pods - 1) + total
        n_obs = np.full(k, float(self.n_pods))
        stats = StreamStats(
            count=_f32(n_obs), mean=_f32(np.sqrt(mag)), var=_f32(sig2),
            m4=_f32(3 * sig2**2),
            var_of_var=_f32(2 * sig2**2 / np.maximum(n_obs - 1, 1)),
            cov=torch.zeros((k, k)), corr=torch.zeros((k, k)))
        model = _StandIn(explained_var=np.asarray(V, np.float32),
                         predictor=(np.arange(k) + 1) % k)
        eps = eps_mod.k_standard_errors(stats, self.epsilon_se)
        prob = solver_mod.build_problem(stats, model, eps, budget,
                                        weights=np.ones(k), cost_real=sizes)
        n_real = np.asarray(solver_mod.solve(prob, method="ipm").n_real)
        sync = {p: bool(n_real[i] >= self.n_pods) for i, p in enumerate(paths)}
        if not any(sync.values()):
            sync[paths[int(np.argmax(sig2))]] = True
        self._disagreement = None
        self._magnitude = None
        self._count = 0
        return ExchangePlan(sync=sync, window=self.window)
