"""Architecture registry: ``get_config(arch_id)`` and the shape table.

Port of ``repro.configs``: the same ten architectures, each a module of
its own with the same FULL and SMOKE configs and shape cells, built on
:class:`repro_torch.models.config.ModelConfig`.  ``repro.configs.shapes``
(abstract inputs for the dry-run) has no counterpart yet.

Every assigned architecture has its own module exporting FULL (exact assigned
hyperparameters) and SMOKE (reduced, CPU-runnable) configs plus the shape
cells it participates in.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "gemma3_12b", "starcoder2_3b", "yi_9b", "chatglm3_6b",
    "qwen3_moe_30b_a3b", "deepseek_moe_16b", "whisper_large_v3",
    "qwen2_vl_2b", "jamba_1_5_large_398b", "mamba2_780m",
]

# canonical external ids (CLI --arch) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({a: a for a in ARCH_IDS})

# (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_module(arch: str):
    name = ALIASES.get(arch)
    if name is None:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str, smoke: bool = False):
    mod = get_module(arch)
    return mod.SMOKE if smoke else mod.FULL


def supported_shapes(arch: str) -> dict:
    """shape name -> 'ok' | 'skip:<reason>'."""
    return get_module(arch).SHAPE_SUPPORT


def all_cells():
    """Every (arch, shape) cell with its support status."""
    out = []
    for a in ARCH_IDS:
        sup = supported_shapes(a)
        for s in SHAPES:
            out.append((a, s, sup.get(s, "ok")))
    return out
