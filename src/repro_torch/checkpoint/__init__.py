from .manager import (CheckpointManager, load_checkpoint, save_checkpoint,
                      snapshot)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint",
           "snapshot"]
