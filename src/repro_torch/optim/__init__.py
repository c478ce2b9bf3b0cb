"""Optimizer of the port: AdamW with fp32 master weights, and its schedule."""
from repro_torch.optim.adamw import (TrainState, abstract_state, adamw_update,
                                     global_norm, init_state, state_axes, tree_leaves,
                                     tree_map)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["TrainState", "abstract_state", "adamw_update", "global_norm",
           "init_state", "state_axes", "tree_leaves", "tree_map", "warmup_cosine"]
