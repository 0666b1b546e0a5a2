"""Checkpointing: atomic torch.save files and the retention policy.

Counterpart of ml_audio_restoration_tpu/train/checkpoints.py. A checkpoint
carries the model's state dict under the upstream key `model_state_dict`
(so `restore --stereo best_model.pth` loads it), the optimizer state,
progress, history and the model family. Retention keeps the newest epoch
checkpoint plus best_model; resume walks them newest first.

The format is torch.save (`checkpoint_epoch_{n}.pth`, `best_model.pth`).
The JAX package's checkpoints are flax msgpack files
(`checkpoint_epoch_{n}.msgpack`, `best_model.msgpack`); `load_msgpack` and
`load_native` read them through compat/msgpack.py (neither flax nor
msgpack is on the card's machine). Resume walks both kinds, so a run
started on the TPU goes on in the port (Trainer.load_checkpoint maps the
payload), which writes `.pth` from then on; retention deletes only the
`.pth` epoch checkpoints the port wrote.
"""
from __future__ import annotations

import os
import re
import tempfile
import threading
import warnings
from pathlib import Path

import torch

from ..compat import msgpack


def _to_cpu(obj):
    """Deep copy of a payload with every tensor detached on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path, payload: dict):
    """Atomically write `payload` to `path`: temp file, fsync, rename, then
    fsync of the directory entry."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = _to_cpu(payload)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            # fsync before the rename, else a power loss can land the
            # renamed file torn after retention deleted the fallback
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path) -> dict:
    """Read a checkpoint written by save_checkpoint, onto the CPU. Tensors
    and plain containers only (weights_only=True)."""
    return torch.load(str(path), map_location="cpu", weights_only=True)


def load_msgpack(path) -> dict:
    """Read a checkpoint the JAX package wrote (flax msgpack): a dict of
    numpy arrays, lists and scalars, as `flax.serialization.
    msgpack_restore` returns it."""
    with open(path, "rb") as f:
        return msgpack.loads(f.read())


def load_native(path, model: str | None = None):
    """`(params, model_state)` of a JAX package checkpoint. `model` is
    accepted for symmetry with the `.pth` loaders; the checkpoint is
    self-describing."""
    ckpt = load_msgpack(path)
    return ckpt["params"], ckpt["model_state"]


class AsyncCheckpointer:
    """Checkpoint writes on a background thread, so the train loop does not
    wait on the disk.

    Failure contract: a background write error is raised at the NEXT
    save() or wait(), never swallowed. `on_done` runs on the worker thread
    only after the atomic rename landed, so retention cannot delete older
    checkpoints while the new one is in flight; an on_done failure is a
    warning, since the checkpoint exists. Call wait() before the process
    exits (the thread is a daemon so a hung disk cannot block shutdown)."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, path, payload: dict, on_done=None):
        # the device-to-host snapshot happens here, before the next step
        # changes the parameters in place; only the write is deferred
        snapshot = _to_cpu(payload)
        self.wait()

        def run():
            try:
                save_checkpoint(path, snapshot)
            except BaseException as e:
                self._error = e
                return
            try:
                if on_done is not None:
                    on_done()
            except BaseException as e:
                warnings.warn(f"checkpoint retention failed for {path}: "
                              f"{e!r}")

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return path

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(
                "async checkpoint write failed (the checkpoint it reported "
                "saving does NOT exist on disk)") from e


_EPOCH_RE = re.compile(r"checkpoint_epoch_(\d+)\.(pth|msgpack)$")
BEST = "best_model.pth"
#: resume order at an equal epoch: the port's own file first
SUFFIXES = (".pth", ".msgpack")


def epoch_checkpoint_name(epoch: int) -> str:
    return f"checkpoint_epoch_{epoch}.pth"


def cleanup_old_epochs(checkpoint_dir, keep_path):
    """Keep only `keep_path` among the port's epoch checkpoints (`.pth`; a
    JAX `.msgpack` is never deleted: the port did not write it)."""
    keep = Path(keep_path)
    for p in Path(checkpoint_dir).glob("checkpoint_epoch_*.pth"):
        if p != keep:
            p.unlink(missing_ok=True)  # a raced external cleanup is fine


def all_checkpoints(checkpoint_dir):
    """Resume candidates, best first: epoch checkpoints (`.pth` and JAX
    `.msgpack`) newest first, the port's `.pth` first at an equal epoch,
    then best_model.pth, then best_model.msgpack. Empty if there are
    none."""
    d = Path(checkpoint_dir)
    if not d.is_dir():
        return []
    epochs = []
    for p in d.glob("checkpoint_epoch_*"):
        m = _EPOCH_RE.search(p.name)
        if m:
            epochs.append((-int(m.group(1)), SUFFIXES.index(p.suffix), p))
    out = [p for *_, p in sorted(epochs)]
    for suffix in SUFFIXES:
        best = (d / BEST).with_suffix(suffix)
        if best.exists():
            out.append(best)
    return out


def latest_checkpoint(checkpoint_dir):
    """Newest epoch checkpoint, else best_model, else None."""
    cands = all_checkpoints(checkpoint_dir)
    return cands[0] if cands else None
