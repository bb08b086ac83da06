"""Checkpoints of the scan runtime's carry and of training states (port
of ``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, flatten,
                                         latest_step, restore,
                                         restore_train_state, save,
                                         save_train_state)

__all__ = ["CheckpointManager", "flatten", "latest_step", "restore",
           "restore_train_state", "save", "save_train_state"]
