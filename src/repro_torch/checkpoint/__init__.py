from repro_torch.checkpoint.store import (
    CheckpointManager, latest_step, list_steps, restore, save,
)

__all__ = ["CheckpointManager", "latest_step", "list_steps", "restore", "save"]
