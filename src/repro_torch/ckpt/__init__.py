"""Checkpoints of the scan runtime's carry (port of ``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, flatten,
                                         latest_step, restore, save)

__all__ = ["CheckpointManager", "flatten", "latest_step", "restore", "save"]
