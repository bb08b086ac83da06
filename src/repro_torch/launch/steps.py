"""Step-function factories shared by the trainer and serving (port of
``repro.launch.steps``).

``make_train_step(cfg, lr_fn)`` takes the loss and gradients of
:func:`repro_torch.models.transformer.forward_train` with microbatched
gradient accumulation, then one AdamW step, with the reference's
cross-pod gradient exchange (``grad_exchange``, the paper's technique;
see :mod:`repro_torch.optim.edge_exchange`) between them.

Under an active LM mesh (``parallel.sharding.mesh_context``) of more
than one rank the step is one rank's part of the reference's sharded
step: the state is this rank's shards (``LMShards.shard``), the batch
its rows (``LMShards.local_batch``), the forward reads the tree gathered
over ``"data"`` and split over ``"model"``, the gradients are summed over
the batch ranks and cut back to the shards, and AdamW runs on the shards.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import MOE_AUX, forward_train
from repro_torch.optim.adamw import (TrainState, adamw_update, tree_leaves,
                                     tree_map, tree_unflatten)
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (active_mesh, batch_axes,
                                           lm_shards, map_paths,
                                           mesh_context)


def _split_microbatches(batch: dict, n: int) -> list:
    """``batch`` cut along its first axis into ``n`` equal microbatches,
    in order (the reference's reshape to (n, B / n, ...))."""
    b = len(next(iter(batch.values())))
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    size = b // n
    return [{k: x[i * size:(i + 1) * size] for k, x in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ModelConfig, lr_fn: Callable, *, microbatches: int = 1,
                    grad_exchange: Optional[Callable] = None, n_pods: int = 1,
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    cast_params_bf16: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    is updated in place (and returned), ``metrics`` holds ``loss``,
    ``grad_norm`` (0-d tensors) and ``lr``.  The step's parts are its
    attributes, for callers that time them apart:
    ``train_step.local_grads(state, batch) -> (loss, metrics, grads)``,
    ``train_step.exchange(grads, momentum) -> (grads, metrics)``,
    ``train_step.loss_and_grads(state, batch) -> (loss, metrics, grads)``
    (the two before, the exchange's metrics merged) and
    ``train_step.apply(state, grads, loss, metrics)``.

    ``microbatches``: the batch is cut into that many equal parts, their
    gradients summed in f32 and divided by the count (the loss likewise,
    and an MoE model's ``moe_lb`` and ``moe_z``, the only metrics a
    microbatched step reports; the reference's reports none).
    ``cast_params_bf16``: the f32 leaves that have two or more dims in
    the reference's stacked layout (the matrices, the embedding and head,
    and the norm scales of the decoder's and the encoder's layers, which
    the reference stacks over blocks; not the final norms') are cast to
    bf16 once per step, outside the microbatch loop, and the gradients are
    taken with respect to those copies, as the reference takes them with
    respect to its cast tree; the update casts them to f32.

    ``grad_exchange`` (:mod:`repro_torch.optim.edge_exchange`): with
    ``n_pods`` > 1 the batch is cut into ``n_pods`` pods as into
    microbatches, each pod's loss and gradients taken in turn (its own
    microbatches included), and the exchange combines the list of the
    pods' gradient trees (``make_stacked_exchange``); the loss is the
    pods' mean, and the pods' own metrics (an MoE's aux losses) are
    dropped, as in the reference.  With ``n_pods`` == 1 the exchange is
    applied to the one gradient tree (``make_grad_exchange``: each rank
    of a group one pod).  ``n_pods`` > 1 with no exchange is the plain
    step.

    The batch's entries besides ``tokens`` and ``labels`` (the modality
    stubs' ``encoder_embeds``, ``patch_embeds``, ``positions``) go into
    ``forward_train`` with them, cut into the microbatches alike.

    Under an active mesh of more than one rank (read when the step runs)
    the state holds this rank's shards and the batch its rows.  The
    forward copy (cast first, with ``cast_params_bf16``) is gathered over
    ``"data"`` once a step, or, with ``cfg.zero3 == "block"``, each
    decoder period block inside the layer loop; the gradients of the
    gathered copy are reduce-scattered to the shards, summed over the
    batch ranks (each rank's loss is its tokens' share of the whole
    batch's mean), in f32.  With a ``"pod"`` axis and an exchange the
    pods are the exchange's: each pod's ranks take its gradients over
    ``"data"`` alone and ``grad_exchange`` (``make_grad_exchange`` over
    the pod group, ``n_pods`` 1) combines them; without one the pods are
    batch ranks like the data ranks.  The reported loss is the whole
    batch's on every rank.
    """
    pods = n_pods if grad_exchange is not None and n_pods > 1 else 1

    def bf16(p, stacked: bool):
        # the reference casts its leaves of two or more dims, which counts
        # the block axis it stacks the layers' leaves on
        if p.dtype == torch.float32 and p.dim() + stacked >= 2:
            return p.detach().to(torch.bfloat16).requires_grad_()
        return p

    def fwd_tree(tree, stacked: bool = False):
        # the leaves under a ``layers`` list, the decoder's and the
        # encoder's, are stacked over blocks in the reference's layout
        if isinstance(tree, dict):
            return {k: fwd_tree(v, stacked or k == "layers")
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fwd_tree(t, stacked) for t in tree)
        return bf16(tree, stacked)

    def grads_of(params, leaves, batch: dict):
        if microbatches == 1:
            loss, metrics = forward_train(params, batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
            return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                    tree_unflatten(params, grads))
        g_sum, loss_sum, aux_sum = None, None, {}
        for mb in _split_microbatches(batch, microbatches):
            loss, metrics = forward_train(params, mb, cfg)
            grads = torch.autograd.grad(loss, leaves)
            aux = {k: metrics[k].detach() for k in MOE_AUX if k in metrics}
            if g_sum is None:
                g_sum = [g.to(torch.float32) for g in grads]
                loss_sum, aux_sum = loss.detach(), aux
            else:
                for a, g in zip(g_sum, grads):
                    a.add_(g.to(torch.float32))
                loss_sum = loss_sum + loss.detach()
                aux_sum = {k: aux_sum[k] + v for k, v in aux.items()}
            del grads
        for g in g_sum:
            g.div_(microbatches)
        return (loss_sum / microbatches,
                {k: v / microbatches for k, v in aux_sum.items()},
                tree_unflatten(params, g_sum))

    def sharded_grads(state: TrainState, batch: dict, mesh):
        shards = lm_shards(cfg, mesh)
        pod_region = grad_exchange is not None and mesh.size("pod") > 1
        axes = ("data",) if pod_region else batch_axes(mesh)
        block = cfg.zero3 == "block"

        def per_block(path: str) -> bool:
            return block and path.startswith("['layers']")

        def gathered(path, t):
            if per_block(path):
                return t
            g = shards.at(path).gather(t, ("data",))
            return t if g is t else g.detach().requires_grad_()
        params = (fwd_tree(state.params) if cast_params_bf16
                  else state.params)
        fwd = map_paths(gathered, params)
        leaves = tree_leaves(fwd)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        with mesh_context(mesh, {"batch": axes}):
            loss, metrics, grads = grads_of(fwd, leaves, batch)
        grads = shards.reduce_grads(grads, axes, scattered=per_block)
        loss = C.all_reduce(loss, mesh.group(axes))
        if pod_region:
            loss = C.all_reduce(loss, mesh.group("pod")) \
                * float(np.float32(1.0 / mesh.size("pod")))
        return loss, metrics, grads

    def local_grads(state: TrainState, batch: dict):
        mesh = active_mesh()
        if mesh is not None and mesh.world > 1:
            return sharded_grads(state, batch, mesh)
        params = (fwd_tree(state.params) if cast_params_bf16
                  else state.params)
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        if pods == 1:
            return grads_of(params, leaves, batch)
        losses, grads_p = [], []
        for pod in _split_microbatches(batch, pods):
            loss, _, grads = grads_of(params, leaves, pod)
            losses.append(loss)
            grads_p.append(grads)
        loss = losses[0]
        for x in losses[1:]:
            loss = loss + x
        return loss * float(np.float32(1.0 / pods)), {}, grads_p

    def exchange(grads, momentum):
        if grad_exchange is None:
            return grads, {}
        return grad_exchange(grads, momentum)

    def loss_and_grads(state: TrainState, batch: dict):
        loss, metrics, grads = local_grads(state, batch)
        grads, ex_metrics = exchange(grads, state.m)
        return loss, {**metrics, **ex_metrics}, grads

    def apply(state: TrainState, grads, loss, metrics: dict):
        lr = lr_fn(state.step)
        mesh = active_mesh()
        shards = (lm_shards(cfg, mesh) if mesh is not None and mesh.world > 1
                  else None)
        state, opt_metrics = adamw_update(
            state, grads, lr, weight_decay=weight_decay, clip_norm=clip_norm,
            shards=shards)
        return state, {**metrics, **opt_metrics, "loss": loss}

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = loss_and_grads(state, batch)
        return apply(state, grads, loss, metrics)

    train_step.local_grads = local_grads
    train_step.exchange = exchange
    train_step.loss_and_grads = loss_and_grads
    train_step.apply = apply
    return train_step


def make_prefill(cfg: ModelConfig, max_seq: int):
    """``prefill_step(model, batch) -> (last_logits, cache)`` for a
    :class:`~repro_torch.models.transformer.Transformer` of ``cfg``."""
    def prefill_step(model, batch):
        return model.prefill(batch, max_seq)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode(model, cache, batch) -> (logits, cache)``: one decode step
    of ``batch["tokens"]`` (B, 1); the batch's other entries (the
    encoder's frames) go to the model's decode step as its
    ``batch_extras``, as in the reference."""
    def decode(model, cache, batch):
        extras = {k: v for k, v in batch.items() if k != "tokens"} or None
        return model.decode_step(cache, batch["tokens"], batch_extras=extras)
    return decode
