"""Audio load/save/normalize, counterpart of ml_audio_restoration_tpu/
audio/io.py.

- load_audio: read -> [channels, samples] float32, optional mono mixdown
  (mean over channels), polyphase resample to the target rate. WAV and
  FLAC decode in the C++ codec (audio/native.py), mp3/ogg through the
  system libraries (audio/codecs.py).
- save_audio: [channels, samples] -> a file whose container follows the
  extension: FLAC, mp3/ogg or WAV (PCM_16 by default).
- normalize_audio: RMS-normalize to a target dB with a peak-clip guard.
- load_audio_chunk: seek-read one random training chunk.
- find_audio_files: the sorted audio files under a directory.
- add_noise, apply_highpass_filter: small numpy/scipy helpers.
"""
from __future__ import annotations

import math
import warnings
from pathlib import Path

import numpy as np

from . import codecs, native
from .flac import flac_info, write_flac
from .wav import wav_info, write_wav

AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".ogg")


def _read_any(path, start: int = 0, frames: int = -1):
    """Decode by extension -> (float32 [T, C], sample_rate): WAV and FLAC
    through the C++ codec, mp3/ogg through the system codec libraries."""
    path = str(path)
    if path.lower().endswith((".wav", ".flac")):
        res = native.read(path, start=start, frames=frames)
        if res is None:
            raise ValueError(f"cannot decode {path!r}: not a WAV/FLAC file "
                             f"the codec reads")
        return res
    res = codecs.read(path, start, frames)
    if res is not None:
        return res
    raise ValueError(
        f"cannot decode {path!r}: wav/flac are supported natively; mp3/ogg "
        "need the system libmpg123/libvorbisfile (not found)")


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
    data, sr = _read_any(path)
    audio = data.T.astype(np.float32)
    if mono and audio.shape[0] > 1:
        audio = audio.mean(axis=0, keepdims=True)
    if sample_rate is not None and sr != sample_rate:
        audio = resample(audio, sr, sample_rate)
        sr = sample_rate
    return audio, sr


def save_audio(path, audio: np.ndarray, sample_rate: int = 22050,
               subtype: str = "PCM_16"):
    """audio: [channels, samples] -> file. The container follows the
    extension: .flac -> FLAC (24-bit for subtype PCM_24, else 16-bit),
    .mp3/.ogg -> the system encoders (raises when their libraries are
    absent, rather than writing WAV bytes under that name), anything
    else -> WAV."""
    audio = np.asarray(audio, np.float32)
    low = str(path).lower()
    if low.endswith(".flac"):
        bits = 24 if subtype == "PCM_24" else 16
        write_flac(path, audio.T, sample_rate, bits=bits)
        return
    if low.endswith((".mp3", ".ogg")):
        writer = codecs.write_mp3 if low.endswith(".mp3") else codecs.write_ogg
        if writer(path, audio.T, sample_rate):
            return
        raise ValueError(
            f"cannot encode {path!r}: the system "
            f"{'lame' if low.endswith('.mp3') else 'vorbis'} encoder is "
            f"unavailable — save as .wav/.flac instead")
    write_wav(path, audio.T, sample_rate, subtype=subtype)


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

    A WAV or FLAC file longer than the window is read only from a random
    start drawn from `rng` (WAV seeks are O(1), FLAC seeks ride its
    SEEKTABLE or skip-decode); a shorter one, and any mp3/ogg (no cheap
    frame count), is loaded and resampled whole, then cropped to a random
    window. Upstream quirk, kept for parity: the seek path returns the
    chunk at the FILE's native rate, with a warning when that differs from
    `sample_rate`; `resample_chunks=True` reads a rate-scaled window and
    resamples it to `chunk_size` frames at `sample_rate`."""
    p = str(path)
    low = p.lower()
    if low.endswith((".wav", ".flac")):
        info = wav_info(p) if low.endswith(".wav") else flac_info(p)
        file_sr = info.sample_rate
        read_frames = (chunk_size if file_sr == sample_rate
                       or not resample_chunks
                       else -(-chunk_size * file_sr // sample_rate))
        if info.frames > read_frames:
            if file_sr != sample_rate and not resample_chunks:
                warnings.warn(
                    f"{p}: file rate {file_sr} != requested {sample_rate}; "
                    f"seek-read chunk keeps the native rate (reference-"
                    f"parity behavior - pass resample_chunks=True to "
                    f"resample)", stacklevel=2)
            start = int(rng.integers(0, info.frames - read_frames + 1))
            data, _ = _read_any(p, start=start, frames=read_frames)
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
