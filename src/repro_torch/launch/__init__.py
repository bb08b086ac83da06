"""Launchers of the LM stack (port of ``repro.launch``): the step
factories and the training driver (``python -m repro_torch.launch.train``).
The mesh and the dry-run come with ROADMAP queue 1, items 4f and 4g."""
from repro_torch.launch.steps import (make_decode_step, make_prefill,
                                      make_train_step)

__all__ = ["make_decode_step", "make_prefill", "make_train_step"]
