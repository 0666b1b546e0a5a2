"""Training runtime of the port: trainer loop, checkpoints, metrics."""
from .checkpoints import (
    AsyncCheckpointer,
    cleanup_old_epochs,
    epoch_checkpoint_name,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["AsyncCheckpointer", "cleanup_old_epochs", "epoch_checkpoint_name",
           "latest_checkpoint", "load_checkpoint", "save_checkpoint"]
