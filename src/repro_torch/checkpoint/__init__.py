from .ckpt import (CheckpointManager, completed_steps, latest_step,
                   require_layout, restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "completed_steps", "latest_step",
           "require_layout", "restore_checkpoint", "save_checkpoint"]
