"""The training batches, worked out again from the raw WAV files.

The program's loader draws its batches from two numpy generators: the
loader's shuffles the file order once an epoch, the dataset's draws each
item's start (uniform over the file's frames less the chunk) in the order
the items are read. Each item is the chunk at that start, every channel,
scaled to -20 dB RMS over the chunk and divided by its peak where that
exceeds 1. These are frozen copies of those rules, over a WAV decoder of
the standard library.
"""
from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def read_wav(path, start: int, frames: int) -> np.ndarray:
    """16-bit PCM frames [start, start + frames) -> float32 [C, frames]."""
    with wave.open(str(path), "rb") as w:
        ch = w.getnchannels()
        w.setpos(start)
        raw = w.readframes(frames)
    x = np.frombuffer(raw, "<i2").astype(np.float32) / np.float32(32768.0)
    return x.reshape(-1, ch).T


def normalize(audio: np.ndarray, target_db: float = -20.0) -> np.ndarray:
    rms = np.sqrt(np.mean(audio ** 2))
    gain = np.where(rms == 0, 1.0,
                    10.0 ** (target_db / 20.0) / np.maximum(rms, 1e-12))
    out = audio * gain
    peak = np.max(np.abs(out))
    return np.asarray(np.where(peak > 1.0, out / peak, out), np.float32)


def replay(data_dir, chunk: int, batch: int, dataset_seed: int,
           loader_seed: int, steps: int) -> list[np.ndarray]:
    """The first `steps` batches of the first epoch, each [B, C, chunk]."""
    files = sorted(Path(data_dir).glob("*.wav"))
    order = np.arange(len(files))
    np.random.default_rng(loader_seed).shuffle(order)
    starts = np.random.default_rng(dataset_seed)
    out = []
    for s in range(steps):
        rows = []
        for i in order[s * batch:(s + 1) * batch]:
            with wave.open(str(files[i]), "rb") as w:
                n = w.getnframes()
            start = int(starts.integers(0, n - chunk + 1)) if n > chunk else 0
            rows.append(normalize(read_wav(files[i], start, chunk)))
        out.append(np.stack(rows))
    return out
