"""Training runtime of the port: trainer loop, checkpoints, metrics."""
from .checkpoints import (
    AsyncCheckpointer,
    cleanup_old_epochs,
    epoch_checkpoint_name,
    latest_checkpoint,
    load_checkpoint,
    load_native,
    save_checkpoint,
)
from .trainer import (
    MODELS, PAIRINGS, Trainer, build_trainer, render_test_outputs,
    train_from_config)

__all__ = ["AsyncCheckpointer", "MODELS", "PAIRINGS", "Trainer",
           "build_trainer", "cleanup_old_epochs", "epoch_checkpoint_name",
           "latest_checkpoint", "load_checkpoint", "load_native",
           "render_test_outputs",
           "save_checkpoint", "train_from_config"]
