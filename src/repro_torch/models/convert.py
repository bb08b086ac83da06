"""Carry the reference's weights across to the port.

``repro.models.transformer.init_params`` stacks each period position's
parameters over blocks (``blocks[pos][group][leaf]`` has a leading axis of
``n_blocks``); the port keeps one dict per layer.  :func:`params_from_jax`
unstacks block ``i`` of position ``pos`` into layer ``i * period + pos``,
so that both packages compute the same function.  It reads numpy arrays
(or anything ``np.asarray`` takes) and imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_served


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """The reference's parameter tree -> the port's (f32 CPU tensors):
    ``{"embed", "final_norm", "layers": [...], "lm_head"?}``."""
    check_served(cfg)
    layers = [None] * cfg.n_layers
    for pos, stacked in enumerate(tree["blocks"]):
        for i in range(cfg.n_blocks):
            layers[i * cfg.period + pos] = {
                group: {name: _tensor(np.asarray(a)[i])
                        for name, a in leaves.items()}
                for group, leaves in stacked.items()}
    params = {"embed": _tensor(tree["embed"]),
              "final_norm": {"scale": _tensor(tree["final_norm"]["scale"])},
              "layers": layers}
    if "lm_head" in tree:
        params["lm_head"] = _tensor(tree["lm_head"])
    return params
