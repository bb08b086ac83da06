"""Carry parameters and training states between the two packages.

``repro.models.transformer.init_params`` stacks each period position's
parameters over blocks (``blocks[pos][group][leaf]`` has a leading axis of
``n_blocks``); the port keeps one dict per layer.  :func:`params_from_jax`
unstacks block ``i`` of position ``pos`` into layer ``i * period + pos``,
so that both packages compute the same function; :func:`params_to_jax`
stacks them back.  The whisper encoder's layers, which the reference
stacks over ``encoder.n_layers`` (``encoder["blocks"]``), become the
port's ``encoder["layers"]`` list the same way.  :func:`train_state_from_jax` and
:func:`train_state_to_jax` do the same for an AdamW state (params, m, v,
step), which is also the layout a training checkpoint is saved in, so
that either package restores the other's.  Everything here reads and
writes numpy arrays (or anything ``np.asarray`` takes) and imports
nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import TrainState


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _host(t: torch.Tensor) -> np.ndarray:
    """An f32 host copy (never a view: the optimizer updates in place)."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def _unstack(stacked: dict, i: int) -> dict:
    """Block ``i`` of a tree of stacked leaves, nested groups (the MoE's
    ``shared``, a Mamba mixer's ``norm``) included."""
    return {n: (_unstack(a, i) if isinstance(a, dict)
                else _tensor(np.asarray(a)[i])) for n, a in stacked.items()}


def _norm(tree: dict, leaf) -> dict:
    return {"scale": leaf(tree["scale"])}


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """The reference's parameter tree -> the port's (f32 CPU tensors):
    ``{"embed", "final_norm", "layers": [...], "lm_head"?, "encoder"?}``,
    the encoder's ``{"layers": [...], "final_norm"}``."""
    layers = [None] * cfg.n_layers
    for pos, stacked in enumerate(tree["blocks"]):
        for i in range(cfg.n_blocks):
            layers[i * cfg.period + pos] = _unstack(stacked, i)
    params = {"embed": _tensor(tree["embed"]),
              "final_norm": _norm(tree["final_norm"], _tensor),
              "layers": layers}
    if "lm_head" in tree:
        params["lm_head"] = _tensor(tree["lm_head"])
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": [_unstack(enc["blocks"], i)
                       for i in range(cfg.encoder.n_layers)],
            "final_norm": _norm(enc["final_norm"], _tensor)}
    return params


def _stacked(params: dict, cfg: ModelConfig, leaf, stack) -> dict:
    """The port's tree in the reference's layout: ``leaf`` maps each
    tensor, ``stack`` a list of one position's layers over the blocks."""
    layers = params["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers given, the "
                         f"config has {cfg.n_layers}")

    def over_blocks(trees: list) -> dict:
        # one position's layers, block by block -> its stacked tree
        return {n: (over_blocks([t[n] for t in trees])
                    if isinstance(trees[0][n], dict) else
                    stack([t[n] for t in trees])) for n in trees[0]}
    blocks = tuple(
        over_blocks([layers[i * cfg.period + pos]
                     for i in range(cfg.n_blocks)])
        for pos in range(cfg.period))
    tree = {"embed": leaf(params["embed"]),
            "final_norm": _norm(params["final_norm"], leaf),
            "blocks": blocks}
    if "lm_head" in params:
        tree["lm_head"] = leaf(params["lm_head"])
    if "encoder" in params:
        enc = params["encoder"]
        if len(enc["layers"]) != cfg.encoder.n_layers:
            raise ValueError(f"{cfg.name}: {len(enc['layers'])} encoder "
                             f"layers given, the config has "
                             f"{cfg.encoder.n_layers}")
        tree["encoder"] = {"blocks": over_blocks(enc["layers"]),
                           "final_norm": _norm(enc["final_norm"], leaf)}
    return tree


def params_to_jax(params: dict, cfg: ModelConfig) -> dict:
    """The port's tree (any float type, any device) -> the reference's
    stacked layout as f32 numpy arrays; the inverse of
    :func:`params_from_jax`.  Also maps a tree of gradients or moments."""
    return _stacked(params, cfg, _host,
                    lambda ts: np.stack([_host(t) for t in ts]))


def train_state_from_jax(state, cfg: ModelConfig) -> TrainState:
    """A reference-layout AdamW state (the reference's ``TrainState``, or
    one :func:`train_state_to_jax` made) -> the port's, as f32 CPU
    tensors; ``step`` becomes an int."""
    return TrainState(params=params_from_jax(state.params, cfg),
                      m=params_from_jax(state.m, cfg),
                      v=params_from_jax(state.v, cfg),
                      step=int(np.asarray(state.step)))


def train_state_to_jax(state: TrainState, cfg: ModelConfig) -> TrainState:
    """The port's AdamW state in the reference's layout (f32 numpy, step
    an int): what a training checkpoint holds."""
    return TrainState(params=params_to_jax(state.params, cfg),
                      m=params_to_jax(state.m, cfg),
                      v=params_to_jax(state.v, cfg), step=int(state.step))


def train_state_template(cfg: ModelConfig) -> TrainState:
    """The shapes of :func:`train_state_to_jax`'s state as meta tensors
    (no memory): the template a training checkpoint restores into."""
    params = _stacked(
        init_params(cfg, None, device="meta"), cfg, lambda t: t,
        lambda ts: torch.empty((len(ts), *ts[0].shape), device="meta"))
    return TrainState(params=params, m=params, v=params, step=0)
