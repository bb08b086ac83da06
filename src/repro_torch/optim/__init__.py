"""The optimizer of the LM training stack (port of ``repro.optim``):
AdamW with clipping and a cosine schedule, and ``edge_exchange``, the
paper's cross-pod gradient exchange and its window planner."""
from repro_torch.optim.adamw import (TrainState, adamw_init, adamw_update,
                                     cosine_schedule, global_norm,
                                     tree_leaves, tree_map, tree_unflatten)
from repro_torch.optim.edge_exchange import (EdgeGradController,
                                             ExchangePlan, full_sync_plan,
                                             make_grad_exchange,
                                             make_stacked_exchange,
                                             stream_leaves, stream_sizes,
                                             synced_bytes)

__all__ = ["EdgeGradController", "ExchangePlan", "TrainState", "adamw_init",
           "adamw_update", "cosine_schedule", "full_sync_plan",
           "global_norm", "make_grad_exchange", "make_stacked_exchange",
           "stream_leaves", "stream_sizes", "synced_bytes", "tree_leaves",
           "tree_map", "tree_unflatten"]
