"""Multi-device serving (a device mesh) and multi-process data-parallel
training on torch.distributed."""
from .distributed import (
    agree_flag,
    average_gradients,
    broadcast_from_primary,
    device_for_rank,
    global_device_count,
    initialize,
    is_primary,
    local_batch_size,
    process_count,
    process_index,
    shard_indices_by_process,
    shutdown,
)
from .mesh import Mesh, make_mesh, replicate, shard_batch, time_shards

__all__ = [
    "Mesh",
    "agree_flag",
    "average_gradients",
    "broadcast_from_primary",
    "device_for_rank",
    "global_device_count",
    "initialize",
    "is_primary",
    "local_batch_size",
    "make_mesh",
    "process_count",
    "process_index",
    "replicate",
    "shard_batch",
    "shard_indices_by_process",
    "shutdown",
    "time_shards",
]
