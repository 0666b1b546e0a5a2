"""A device mesh for multi-device serving.

Counterpart of ml_audio_restoration_tpu/parallel/mesh.py. The JAX package
builds a ('data', 'model') `jax.sharding.Mesh` and lets XLA partition its
serving programs: the chunk batch (or the stream batch) is sharded over
'data', and 'model' shards the time axis (sequence parallelism, with the
conv halo exchanges XLA inserts). The port's mesh is a grid of torch
devices, and the serving objects shard by hand: `shard_batch` splits the
batch over 'data', each shard runs on its device with that device's copy of
the models (`replicate`), and the outputs are gathered on the serving
object's own device. No collective is needed: chunks and streams are
independent.

The 'model' axis shards each chunk's time (sequence parallelism, JAX's
`P("data", "model", None)`): every data row of the mesh splits its chunks'
time axis over its devices (`time_shards`), and pipeline/restore.py runs
the stages that are local in time on overlapping windows, one a device,
with the halos of parallel/sequence.py, and gathers time on the row's first
device before the LSTM. That is how one very long recording (whole_file,
data=1, model=N) is served across N devices.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch

def canonical(device) -> torch.device:
    """`device` as a torch.device, a bare "cuda" resolved to the current
    card's index (so "cuda" and "cuda:0" name one device in cache keys)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def cuda_devices() -> list:
    """Every CUDA device of this process, in index order (empty without a
    card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh(NamedTuple):
    """A ('data', 'model') grid of torch devices: `devices[i][j]` serves
    data shard i, time shard j."""
    devices: tuple

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def rows(self) -> list:
        """Each data row's devices (its 'model' axis), in row order."""
        return [list(row) for row in self.devices]

    @property
    def data_devices(self) -> list:
        """The first device of each data row, in row order: where a row's
        chunks (or streams) live and its time shards are gathered."""
        return [row[0] for row in self.devices]

    @property
    def flat_devices(self) -> list:
        """Every entry of the mesh, row by row (a repeated device repeats)."""
        return [d for row in self.devices for d in row]


def make_mesh(data_parallel: Optional[int] = None, model_parallel: int = 1,
              devices=None) -> Mesh:
    """A data_parallel x model_parallel mesh over the first
    data_parallel * model_parallel of `devices`, row by row (default: every
    CUDA device; data_parallel defaults to len(devices) // model_parallel).

    Raises ValueError when there are fewer devices than the mesh needs:
    it never serves on fewer devices or falls back to the CPU. An explicit
    `devices` list may repeat a device: the shards then share it. That is
    how the sharded path runs on a host with one device, the CPU (which
    torch counts as one device) or a single card, to check the split, the
    gather and the numbers; it is not a scaling run."""
    devices = [canonical(d) for d in (
        devices if devices is not None else cuda_devices())]
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    if data_parallel is None:
        data_parallel = max(1, len(devices) // model_parallel)
    n = data_parallel * model_parallel
    if n > len(devices):
        raise ValueError(
            f"mesh needs {n} devices, only {len(devices)} available")
    return Mesh(tuple(tuple(devices[i:i + model_parallel])
                      for i in range(0, n, model_parallel)))


def shard_batch(mesh: Mesh, x: torch.Tensor) -> list:
    """Split axis 0 of `x` over the mesh's 'data' axis: one tensor per data
    row, on the row's first device (a copy that does not wait for the
    host). An uneven split is allowed: 64 rows over 3 shards are 22, 21 and
    21."""
    return [part.to(dev, non_blocking=True) for dev, part in zip(
        mesh.data_devices, torch.tensor_split(x, mesh.shape["data"]))]


def time_shards(mesh: Mesh, length: int, grid: int = 1) -> list:
    """The counterpart of the JAX package's `time_sharding`: the cores
    [(lo, hi)] that split `length` time steps over one data row's
    'model' axis, cut on multiples of `grid`, as evenly as the grid
    allows (the first cores take the extra grid units). A length shorter
    than the row has grid units gets fewer cores than devices: the last
    devices of the row stay empty, as shard_batch leaves them."""
    units = max(1, -(-length // grid))
    n = min(mesh.shape["model"], units)
    cuts = [min(u * grid, length) for u in (
        k * (units // n) + min(k, units % n) for k in range(n + 1))]
    return list(zip(cuts[:-1], cuts[1:]))


def replica(module, device):
    """`module` on `device`: the module itself when it is there already,
    else a copy (the caller's module is never moved). None passes."""
    if module is None:
        return None
    dev = canonical(device)
    params = list(module.parameters()) + list(module.buffers())
    if params and all(canonical(p.device) == dev for p in params):
        return module
    return copy.deepcopy(module).to(dev)


def replicate(mesh: Mesh, module) -> dict:
    """One copy of `module` per distinct device of the mesh:
    {device: module on it}."""
    return {dev: replica(module, dev) for dev in dict.fromkeys(
        d for row in mesh.devices for d in row)}
