"""Seeded inputs: 78rpm sides, endless stream signals, a stereo corpus.

- `side` / `stream_block`: the program's smoke-test clip
  (`chip_smoke.py::_clip`, frozen here): a 220 Hz and a 1,330 Hz tone,
  hiss at 0.02 and a click every 5,000 samples, RMS ~0.1; made on the
  device from a generator.
- `stereo_take`: `chip_smoke.py::_stereo_batch` for one file, frozen: a
  tone of random pitch under noise, L and R correlated, RMS ~0.1.
- `write_wav16`: 16-bit PCM WAV with the standard library, the raw file
  that the program's loader and the reference both read.
"""
from __future__ import annotations

import math
import wave

import numpy as np
import torch


def seed_seq(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws under the run's seed."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def side(n: int, rate: int, generator: torch.Generator) -> torch.Tensor:
    """A mono clip of n samples at `rate` -> float32 [n] on the
    generator's device."""
    dev = generator.device
    t = torch.arange(n, dtype=torch.float64, device=dev) / rate
    x = (0.1 * torch.sin(2 * math.pi * 220 * t)
         + 0.05 * torch.sin(2 * math.pi * 1330 * t)).float()
    x += 0.02 * torch.randn(n, generator=generator, device=dev)
    k = max(1, n // 5000)
    where = torch.randint(0, n, (k,), generator=generator, device=dev)
    amp = torch.rand(k, generator=generator, device=dev) - 0.5
    x.index_add_(0, where, amp)
    return x


def stream_block(streams: int, n: int, start: int, rate: int,
                 generator: torch.Generator) -> torch.Tensor:
    """[streams, n] float32 on the generator's device: samples [start,
    start + n) of endless streams by `side`'s rules, the tones unbroken
    from block to block, the block's hiss and clicks drawn from
    `generator` for every stream at once."""
    dev = generator.device
    t = (start + torch.arange(n, dtype=torch.float64, device=dev)) / rate
    tone = (0.1 * torch.sin(2 * math.pi * 220 * t)
            + 0.05 * torch.sin(2 * math.pi * 1330 * t)).float()
    x = tone + 0.02 * torch.randn((streams, n), generator=generator,
                                  device=dev)
    k = max(1, n // 5000)
    where = torch.randint(0, n, (streams, k), generator=generator,
                          device=dev)
    amp = torch.rand((streams, k), generator=generator, device=dev) - 0.5
    return x.scatter_add_(1, where, amp)


def stereo_take(frames: int, seed: int, rate: int = 22050) -> np.ndarray:
    """[2, frames] float32 from a numpy generator seeded `seed`."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / rate
    tone = 0.1 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
    left = tone + 0.05 * rng.standard_normal(frames)
    right = 0.6 * tone + 0.05 * rng.standard_normal(frames)
    return np.stack([left, right]).astype(np.float32)


def write_wav16(path, audio: np.ndarray, rate: int):
    """[C, T] float -> 16-bit PCM WAV (x * 32768 rounded, clipped)."""
    pcm = np.clip(np.round(audio.T * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
