"""Launchers of the LM stack (port of ``repro.launch``): the step
factories, the mesh of ranks (``launch.mesh``) and the training driver
(``python -m repro_torch.launch.train``).  The dry-run comes with ROADMAP
queue 1, item 4g."""
from repro_torch.launch.steps import (make_decode_step, make_prefill,
                                      make_train_step)

__all__ = ["make_decode_step", "make_prefill", "make_train_step"]
