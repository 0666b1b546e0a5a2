"""Multi-process data parallelism on torch.distributed.

Counterpart of ml_audio_restoration_tpu/parallel/distributed.py. The JAX
package compiles its train step over a mesh with the batch sharded, and
XLA's partitioner supplies the gradient all-reduce and global-batch BN
statistics (its parallel/mesh.py). The port runs one device per process
and writes each global quantity itself: the train step (train/trainer.py)
enters `global_batch()`, and inside it `ops.batch_norm_train`, the
semi-supervised loss's masked means, the impulse loss's threshold and the
degradation's draws span every rank's items; `average_gradients` then
averages the gradients (and the step's logged values) in one flattened
all-reduce. Outside `global_batch()`, and without a process group, every
one of them is the single-process code.

Backend: `nccl` when every rank on a host has a CUDA device of its own,
`gloo` when the ranks run on the CPU or share a card (NCCL refuses two
ranks on one GPU). Gloo takes CUDA tensors for `all_reduce` and
`broadcast` only, so every collective here is built from those two.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

# set by global_batch() inside a train step under a process group
_GLOBAL_BATCH = contextvars.ContextVar("global_batch", default=False)


def _active() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def backend_for(device, local_processes: int) -> str:
    """nccl when `device` is a CUDA device and this host has a card for
    each of its `local_processes` ranks; gloo otherwise."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= local_processes):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device="cuda") -> bool:
    """Join a multi-process job: torch.distributed.init_process_group over
    tcp://<coordinator_address> (host:port) with `num_processes` ranks,
    this one `process_id`. `device` is what the processes train on and
    picks the backend (backend_for).

    With no arguments it reads a launcher's environment (torchrun's
    WORLD_SIZE > 1 with RANK, MASTER_ADDR and MASTER_PORT) and is
    otherwise a no-op that returns False. A job that was asked for and
    cannot form raises on every rank: carrying on single-process would
    mean duplicate writers and another global batch."""
    explicit = (coordinator_address is not None
                or (num_processes or 0) > 1)
    if not explicit:
        env = os.environ
        if (int(env.get("WORLD_SIZE") or 1) <= 1 or not all(
                k in env for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"))):
            return False
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process job needs the coordinator (host:port), the "
            "number of processes and this process's id (--coordinator, "
            "--num-processes, --process-id)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside "
                         f"[0, {num_processes})")
    if _active():
        if (tdist.get_world_size() == num_processes
                and tdist.get_rank() == process_id):
            return True
        raise RuntimeError(
            f"a process group of {tdist.get_world_size()} processes is "
            f"already initialized here; asked for {num_processes}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to train on the CPU")
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or num_processes)
    backend = backend_for(device, local)
    tdist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    own = device_for_rank(device)
    if own.type == "cuda":
        torch.cuda.set_device(own)
    if is_primary():
        print(f"distributed: {num_processes} processes, backend {backend}, "
              f"rank 0 on {own} ({local} on this host, "
              f"{torch.cuda.device_count()} CUDA devices)", flush=True)
    return True


def shutdown():
    """Leave the process group, if there is one."""
    if _active():
        tdist.destroy_process_group()


def process_index() -> int:
    return tdist.get_rank() if _active() else 0


def process_count() -> int:
    return tdist.get_world_size() if _active() else 1


def global_device_count() -> int:
    """The devices the job computes on. Under a process group each rank
    trains on one device of its own (device_for_rank), so it is the rank
    count; ranks that share a card each hold a replica and count as one
    device apiece. Without a group it is the cards this process sees (the
    serving mesh spans them), or the CPU where there is none."""
    if _active():
        return process_count()
    return max(torch.cuda.device_count(), 1)


def is_primary() -> bool:
    """True on the process that writes checkpoints, metrics and renders."""
    return process_index() == 0


def device_for_rank(device) -> torch.device:
    """This rank's device: cuda:<local rank % cards> for a bare "cuda"
    under a process group (ranks beyond the host's cards share them), any
    other device as given. Raises when a CUDA device is asked for and
    there is none: a rank never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to train on the CPU")
    if dev.index is not None or not _active():
        return dev
    local = int(os.environ.get("LOCAL_RANK") or process_index())
    return torch.device("cuda", local % torch.cuda.device_count())


def shard_indices_by_process(indices, index: Optional[int] = None,
                             count: Optional[int] = None):
    """This process's disjoint slice of a dataset index list: indices k,
    k+P, k+2P, ... for process k of P, truncated to a common length so
    every process runs the same number of steps (a rank with one more
    step would wait in its collectives forever)."""
    indices = np.asarray(indices)
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if count <= 1:
        return indices
    per_process = len(indices) // count
    return indices[index::count][:per_process]


def local_batch_size(global_batch_size: int,
                     count: Optional[int] = None) -> int:
    """The loader batch of one process: the config's batch size is the
    global batch, which every process feeds an equal share of."""
    count = process_count() if count is None else count
    if global_batch_size % count:
        raise ValueError(
            f"global batch size {global_batch_size} not divisible by "
            f"process count {count}")
    return global_batch_size // count


def _collective_device() -> torch.device:
    """Where host-side collectives stage their tensors: NCCL takes CUDA
    tensors only, gloo the CPU."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce(t):
    """Sum `t` over the ranks in place: the one tensor collective of the
    train step (every reduction below comes here)."""
    tdist.all_reduce(t)
    return t


def agree_flag(flag: bool) -> bool:
    """Cross-rank OR of a host-side flag (an interrupt delivered to one
    process). A rank-local break would leave the others waiting in the
    next step's all-reduce, so a decision that ends the loop is agreed.
    Every rank must call it equally often. Identity without a group."""
    if process_count() <= 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_collective_device())
    return bool(_all_reduce(t).item() > 0)


def broadcast_from_primary(s: str, maxlen: int = 256) -> str:
    """Rank 0's string on every rank (the others' argument is ignored):
    which checkpoint to resume from. Identity without a group."""
    if process_count() <= 1:
        return s
    buf = torch.zeros(maxlen, dtype=torch.uint8)
    b = s.encode("utf-8")[:maxlen]
    buf[:len(b)] = torch.tensor(list(b), dtype=torch.uint8)
    buf = buf.to(_collective_device())
    tdist.broadcast(buf, src=0)
    # errors="replace": a maxlen cut can split a multibyte UTF-8 sequence;
    # every rank must still decode the same string, not raise
    return bytes(buf.cpu().numpy()).rstrip(b"\x00").decode(
        "utf-8", errors="replace")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the same sum of the ranks'
    gradients, so a quantity every rank computes from the summed value
    sends each rank's share of the gradient back to its own inputs."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format))


def all_reduce_sum(x):
    """x summed over the ranks, differentiable."""
    return _AllReduceSum.apply(x)


def mean_over_ranks(x):
    """The mean over the ranks of a per-rank batch mean, differentiable:
    the global batch's mean, since every rank holds an equal share. With
    one rank it is x itself, bit for bit."""
    return all_reduce_sum(x) / process_count()


def gather_rows(x):
    """The ranks' [b, ...] tensors concatenated in rank order, [W*b, ...]
    (no gradient): a zero-filled global buffer holding this rank's rows,
    summed over the ranks, which is exact."""
    b = x.shape[0]
    r = process_index()
    out = x.new_zeros((process_count() * b, *x.shape[1:]))
    out[r * b:(r + 1) * b] = x
    return _all_reduce(out)


def average_gradients(params, extra=None):
    """Replace each parameter's gradient by its mean over the ranks, in
    one flattened all-reduce; `extra` (a 1-D tensor of per-rank values,
    such as the step's loss) rides along and comes back averaged. Every
    rank must pass the same parameters with gradients in the same order.
    Returns the averaged `extra` (None without one)."""
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1) for g in grads]
    if extra is not None:
        parts.append(extra.reshape(-1).to(parts[0].dtype if parts
                                          else extra.dtype))
    flat = _all_reduce(torch.cat(parts)) / process_count()
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n
    return flat[off:] if extra is not None else None


@contextlib.contextmanager
def global_batch():
    """Inside, under a process group, the batch reductions of the port's
    ops and losses span every rank's items (in_global_batch). Entered by
    the train step only: validation and rendering evaluate the whole
    validation set on every rank and call no collective."""
    token = _GLOBAL_BATCH.set(_active())
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def in_global_batch() -> bool:
    return _GLOBAL_BATCH.get()
