"""Audio load/save/normalize, counterpart of the WAV path of
ml_audio_restoration_tpu/audio/io.py.

- load_audio: read -> [channels, samples] float32, optional mono mixdown
  (mean over channels), polyphase resample to the target rate.
- save_audio: [channels, samples] -> WAV (PCM_16 by default).
- normalize_audio: RMS-normalize to a target dB with a peak-clip guard.
- load_audio_chunk: seek-read one random training chunk.
- find_audio_files: the sorted audio files under a directory.
- add_noise, apply_highpass_filter: small numpy/scipy helpers.

WAV only; FLAC, mp3/ogg and the native codec are not ported yet (ROADMAP
item 4).
"""
from __future__ import annotations

import math
import warnings
from pathlib import Path

import numpy as np

from .wav import read_wav, wav_info, write_wav

AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".ogg")


def _check_wav(path):
    low = str(path).lower()
    if low.endswith((".flac", ".mp3", ".ogg")):
        raise NotImplementedError(
            f"{path!r}: FLAC and mp3/ogg are not ported yet (ROADMAP item "
            f"4); the port reads and writes WAV only")
    if not low.endswith(".wav"):
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


def load_audio_chunk(path, chunk_size: int, rng: np.random.Generator,
                     sample_rate: int = 22050, mono: bool = True,
                     resample_chunks: bool = False):
    """Seek-read one random chunk -> float32 [channels, samples].

    A file longer than the window is read only from a random start drawn
    from `rng`; a shorter one is loaded and resampled whole. Upstream
    quirk, kept for parity: the seek path returns the chunk at the FILE's
    native rate, with a warning when that differs from `sample_rate`;
    `resample_chunks=True` reads a rate-scaled window and resamples it to
    `chunk_size` frames at `sample_rate`."""
    _check_wav(path)
    p = str(path)
    info = wav_info(p)
    file_sr = info.sample_rate
    read_frames = (chunk_size if file_sr == sample_rate or not resample_chunks
                   else -(-chunk_size * file_sr // sample_rate))
    if info.frames > read_frames:
        if file_sr != sample_rate and not resample_chunks:
            warnings.warn(
                f"{p}: file rate {file_sr} != requested {sample_rate}; "
                f"seek-read chunk keeps the native rate (reference-parity "
                f"behavior - pass resample_chunks=True to resample)",
                stacklevel=2)
        start = int(rng.integers(0, info.frames - read_frames + 1))
        data, _ = read_wav(p, start=start, frames=read_frames)
        audio = data.T.astype(np.float32)
        if mono and audio.shape[0] > 1:
            audio = audio.mean(axis=0, keepdims=True)
        if file_sr != sample_rate and resample_chunks:
            audio = resample(audio, file_sr, sample_rate)[:, :chunk_size]
        return audio
    audio, _ = load_audio(p, sample_rate, mono=mono)
    if audio.shape[-1] > chunk_size:
        start = int(rng.integers(0, audio.shape[-1] - chunk_size + 1))
        audio = audio[:, start:start + chunk_size]
    return audio


def add_noise(audio, noise_level: float = 0.01, rng=None):
    """audio plus Gaussian noise of std `noise_level` from `rng`."""
    rng = rng or np.random.default_rng()
    return audio + rng.normal(0, noise_level, audio.shape).astype(np.float32)


def apply_highpass_filter(audio, sample_rate: int, cutoff_freq: float = 80.0):
    """RBJ biquad high-pass (Q=0.707) along the last axis, rumble
    removal."""
    from scipy.signal import lfilter

    w0 = 2 * math.pi * cutoff_freq / sample_rate
    q = 0.707
    alpha = math.sin(w0) / (2 * q)
    cosw = math.cos(w0)
    b = np.array([(1 + cosw) / 2, -(1 + cosw), (1 + cosw) / 2])
    a = np.array([1 + alpha, -2 * cosw, 1 - alpha])
    return lfilter(b / a[0], a / a[0], audio, axis=-1).astype(np.float32)


def find_audio_files(directory, extensions=AUDIO_EXTENSIONS,
                     recursive: bool = True):
    """Sorted audio files under `directory` with one of `extensions`."""
    directory = Path(directory)
    pattern = "**/*" if recursive else "*"
    return sorted(
        p for p in directory.glob(pattern)
        if p.suffix.lower() in extensions and p.is_file())
