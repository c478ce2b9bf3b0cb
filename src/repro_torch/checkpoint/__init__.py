from repro_torch.checkpoint.store import (
    CheckpointManager, latest_step, list_steps, restore, restore_resharded, save,
)

__all__ = ["CheckpointManager", "latest_step", "list_steps", "restore",
           "restore_resharded", "save"]
