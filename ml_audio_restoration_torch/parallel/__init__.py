"""Multi-process data parallelism of the port on torch.distributed."""
from .distributed import (
    agree_flag,
    average_gradients,
    broadcast_from_primary,
    device_for_rank,
    initialize,
    is_primary,
    local_batch_size,
    process_count,
    process_index,
    shard_indices_by_process,
    shutdown,
)

__all__ = [
    "agree_flag",
    "average_gradients",
    "broadcast_from_primary",
    "device_for_rank",
    "initialize",
    "is_primary",
    "local_batch_size",
    "process_count",
    "process_index",
    "shard_indices_by_process",
    "shutdown",
]
