"""The optimizer of the LM training stack (port of ``repro.optim``):
AdamW with clipping and a cosine schedule.  ``edge_exchange`` (the
cross-pod gradient exchange) comes with LM sharding (ROADMAP queue 1,
item 4f)."""
from repro_torch.optim.adamw import (TrainState, adamw_init, adamw_update,
                                     cosine_schedule, global_norm,
                                     tree_leaves, tree_map, tree_unflatten)

__all__ = ["TrainState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "tree_leaves", "tree_map", "tree_unflatten"]
