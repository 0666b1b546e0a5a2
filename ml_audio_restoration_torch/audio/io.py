"""Audio load/save/normalize, counterpart of the WAV path of
ml_audio_restoration_tpu/audio/io.py.

- load_audio: read -> [channels, samples] float32, optional mono mixdown
  (mean over channels), polyphase resample to the target rate.
- save_audio: [channels, samples] -> WAV (PCM_16 by default).
- normalize_audio: RMS-normalize to a target dB with a peak-clip guard.

WAV only; FLAC, mp3/ogg and the native codec are not ported yet.
"""
from __future__ import annotations

import math

import numpy as np

from .wav import read_wav, write_wav


def _check_wav(path):
    if not str(path).lower().endswith(".wav"):
        raise ValueError(f"{path!r}: the port reads and writes WAV only")


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis of [C, T]."""
    if orig_sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g,
                         axis=-1).astype(np.float32)


def load_audio(path, sample_rate: int | None = 22050, mono: bool = True):
    """-> (float32 [channels, samples], sample_rate); sample_rate=None keeps
    the file's rate."""
    _check_wav(path)
    data, sr = read_wav(path)
    audio = data.T.astype(np.float32)
    if mono and audio.shape[0] > 1:
        audio = audio.mean(axis=0, keepdims=True)
    if sample_rate is not None and sr != sample_rate:
        audio = resample(audio, sr, sample_rate)
        sr = sample_rate
    return audio, sr


def save_audio(path, audio: np.ndarray, sample_rate: int = 22050,
               subtype: str = "PCM_16"):
    """audio: [channels, samples] -> WAV file."""
    _check_wav(path)
    write_wav(path, np.asarray(audio, np.float32).T, sample_rate,
              subtype=subtype)


def normalize_audio(audio: np.ndarray, target_db: float = -20.0):
    """RMS-normalize to target_db, then divide by the peak if it exceeds 1."""
    rms = np.sqrt(np.mean(audio ** 2))
    target_rms = 10.0 ** (target_db / 20.0)
    gain = np.where(rms == 0, 1.0, target_rms / np.maximum(rms, 1e-12))
    normalized = audio * gain
    peak = np.max(np.abs(normalized))
    return np.where(peak > 1.0, normalized / peak, normalized)
