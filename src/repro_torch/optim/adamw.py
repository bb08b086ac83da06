"""AdamW with decoupled weight decay, gradient clipping and a cosine
schedule (port of ``repro.optim.adamw``).

Master parameters and both moments are f32; the forward casts each master
to the activation type where it uses it.  The update runs in the
reference's order (clip scale, moments, bias corrections, decoupled
decay), all in f32 (the global norm's sum of squares in f64, see
:func:`global_norm`), and writes the parameters and moments in place leaf
by leaf: at full width a temporary of the whole tree would not fit beside
the state (starcoder2-3b's masters alone are 17 GB).

Trees are nested dicts and lists of tensors (the port's parameter tree,
``{"embed", "final_norm", "layers": [...], "lm_head"?}``); their leaves
are taken in the reference's order, dict entries by sorted key and
sequence items in order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class TrainState:
    params: dict
    m: dict
    v: dict
    step: int


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and sequences, in flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf, in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in flattening
    order (its dicts come out in sorted key order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(like)


def adamw_init(params) -> TrainState:
    """A fresh state over ``params``: f32 zero moments, step 0.  Every
    parameter is made a trainable leaf (``requires_grad``) in place."""
    for p in tree_leaves(params):
        p.requires_grad_(True)

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                requires_grad=False)
    return TrainState(params=params, m=tree_map(zeros, params),
                      v=tree_map(zeros, params), step=0)


def global_norm(tree, shards=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, rounded to f32 (a 0-d
    tensor on the leaves' device).  The squares are summed in f64, one
    dot product of each leaf with itself: the reference sums them in f32,
    which overflows to inf once the norm passes ~1.8e19, as starcoder2-3b
    FULL's gradients do at its initialization (2.9e19 in the embedding),
    and an inf norm makes the clip factor 0 and every update a no-op.
    Where the f32 sum is finite the two agree to its rounding.

    ``shards`` (``parallel.sharding.LMShards``): the tree holds this
    rank's shards; each rank sums the squares of the leaves it owns (a
    leaf replicated over some ranks is counted on the first of them) and
    the sums are all-reduced over the pod's ranks."""
    if shards is not None:
        from repro_torch.parallel.sharding import leaf_paths
        total = None
        for path, x in leaf_paths(tree):
            flat = x.detach().reshape(-1).to(torch.float64)
            sq = torch.dot(flat, flat) if shards.owned(path) \
                else torch.zeros((), dtype=torch.float64, device=x.device)
            total = sq if total is None else total + sq
        return torch.sqrt(shards.sum_inpod(total)).to(torch.float32)
    total = None
    for x in tree_leaves(tree):
        flat = x.detach().reshape(-1).to(torch.float64)
        sq = torch.dot(flat, flat)
        total = sq if total is None else total + sq
    return torch.sqrt(total).to(torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    """lr(step): linear warm-up to ``peak_lr`` over ``warmup`` steps, then
    a cosine down to ``floor * peak_lr`` at ``total``.  Evaluated on the
    host in f32, as the reference evaluates it; returns a Python float
    holding the f32 value."""
    f32 = np.float32

    def lr(step) -> float:
        step = f32(int(step))
        warm = f32(peak_lr) * step / f32(max(warmup, 1))
        frac = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(peak_lr) * (f32(floor) + f32(1 - floor) * f32(0.5)
                              * (f32(1) + np.cos(f32(math.pi) * frac)))
        return float(warm if step < warmup else cos)
    return lr


@torch.no_grad()
def adamw_update(state: TrainState, grads, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0,
                 shards=None) -> tuple[TrainState, dict]:
    """One AdamW step on ``state`` (f32 params) with ``grads`` (a tree of
    the params' structure, f32 or bf16), in place: the state's params, m
    and v are overwritten leaf by leaf, and so are f32 gradients (scaled
    by the clip factor).  Returns (the state, {"grad_norm", "lr"}); ``grad_norm`` is
    the unclipped global norm, a 0-d f32 tensor.  ``shards``: the state
    and gradients are this rank's shards (:func:`global_norm`); the
    update itself is elementwise."""
    gnorm = global_norm(grads, shards)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    lr = float(np.float32(lr))
    for p, g, m, v in zip(tree_leaves(state.params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.mul_(scale) if g.dtype == torch.float32 \
            else g.to(torch.float32).mul_(scale)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = torch.div(v, bc2).sqrt_().add_(eps)
        delta = torch.div(m, bc1).div_(denom)
        del g, denom
        delta.add_(p, alpha=weight_decay)
        p.sub_(delta.mul_(lr))
        del delta
    state.step = step
    return state, {"grad_norm": gnorm, "lr": lr}
