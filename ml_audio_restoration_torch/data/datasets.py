"""Training datasets: host-side chunk readers.

Counterpart of ChunkDataset, RestorationDataset, StereoDataset and
SuperResolutionDataset in ml_audio_restoration_tpu/data/datasets.py. Each
item is one random chunk of one file, float32 [C, chunk], normalized to
-20 dB RMS and zero-padded to the chunk size, read with a seek for long
files. Datasets yield clean audio; the train step derives (input, target)
from each batch on the device as the dataset's `pairing` says (the 78rpm
degradation runs there, data/artifacts.py). The mixed and adaptive
datasets are not ported yet (ROADMAP item 3).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..audio import (
    find_audio_files, load_audio_chunk, normalize_audio, read_wav, wav_info)


class ChunkDataset:
    """Base: one random chunk per file per epoch."""

    #: how the train step builds (input, target) from a batch
    pairing = "degrade"

    def __init__(self, data_dir, sample_rate: int = 22050,
                 chunk_duration: float = 2.0, mono: bool = True,
                 extensions=None, seed: int = 0,
                 resample_chunks: bool = False):
        self.data_dir = Path(data_dir)
        self.sample_rate = sample_rate
        self.chunk_size = int(sample_rate * chunk_duration)
        self.mono = mono
        self.resample_chunks = resample_chunks
        self.files = find_audio_files(
            self.data_dir,
            extensions=extensions or (".wav", ".mp3", ".flac", ".ogg"))
        if not self.files:
            raise ValueError(f"No audio files found in {data_dir}")
        other = [p for p in self.files if p.suffix.lower() != ".wav"]
        if other:
            raise NotImplementedError(
                f"{len(other)} non-WAV file(s) in {data_dir}, e.g. "
                f"{other[0]}: FLAC and mp3/ogg are not ported yet (ROADMAP "
                f"item 4)")
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def _chunk(self, path, mono=None):
        audio = load_audio_chunk(path, self.chunk_size, self.rng,
                                 self.sample_rate,
                                 mono=self.mono if mono is None else mono,
                                 resample_chunks=self.resample_chunks)
        audio = np.asarray(normalize_audio(audio), np.float32)
        if audio.shape[-1] < self.chunk_size:
            audio = np.pad(audio,
                           ((0, 0), (0, self.chunk_size - audio.shape[-1])))
        return audio[:, :self.chunk_size]

    def __getitem__(self, idx):
        raise NotImplementedError


class _MonoBatchReadMixin:
    """The batch read route of the JAX package's mono datasets, whose
    DataLoader takes it when the native reader loads: one start drawn for
    every item, `rng.integers(0, max(frames - chunk, 0) + 1)` (for a file
    no longer than the chunk that range is {0}, which numpy returns without
    a draw, as the per-item route draws none), mono rows zero-padded to
    the chunk, and the -20 dB RMS normalization and clip guard vectorized
    over the batch with each row's RMS over its true length. Here the rows
    are numpy seek reads. A batch with a non-WAV file, or a file at
    another rate, falls back to per-item reads after the starts already
    drawn, as there."""

    def getitems(self, indices):
        paths = [self.files[i] for i in indices]
        if not all(str(p).lower().endswith((".wav", ".flac")) for p in paths):
            return [self[i] for i in indices]
        starts, lengths = [], []
        for p in paths:
            try:
                meta = wav_info(p)
            except (OSError, ValueError):
                meta = None
            if meta is None or meta.sample_rate != self.sample_rate:
                return [self[i] for i in indices]
            max_start = max(meta.frames - self.chunk_size, 0)
            starts.append(int(self.rng.integers(0, max_start + 1)))
            lengths.append(min(meta.frames, self.chunk_size))
        batch = np.zeros((len(paths), self.chunk_size), np.float32)
        for row, p, start in zip(batch, paths, starts):
            data, _ = read_wav(p, start=start, frames=self.chunk_size)
            row[:data.shape[0]] = (data[:, 0] if data.shape[1] == 1
                                   else data.mean(axis=1))
        lens = np.maximum(np.asarray(lengths, np.float32)[:, None], 1.0)
        rms = np.sqrt(np.sum(batch**2, axis=1, keepdims=True) / lens)
        gain = np.where(rms == 0, 1.0,
                        10 ** (-20 / 20) / np.maximum(rms, 1e-12))
        batch = batch * gain
        peak = np.max(np.abs(batch), axis=1, keepdims=True)
        batch = np.where(peak > 1.0, batch / np.maximum(peak, 1e-12), batch)
        return [{"clean": row[None].astype(np.float32)}
                for row in batch]


class RestorationDataset(_MonoBatchReadMixin, ChunkDataset):
    """Clean mono chunks for the denoiser; the train step degrades them on
    the device. add_artifacts=False trains on identity pairs."""

    pairing = "degrade"

    def __init__(self, data_dir, sample_rate: int = 22050,
                 chunk_duration: float = 2.0, add_artifacts: bool = True,
                 **kw):
        super().__init__(data_dir, sample_rate, chunk_duration, mono=True,
                         **kw)
        self.add_artifacts = add_artifacts
        if not add_artifacts:
            self.pairing = "identity"

    def __getitem__(self, idx):
        return {"clean": self._chunk(self.files[idx])}


class StereoDataset(ChunkDataset):
    """Stereo targets; the train step derives the mono input as the channel
    mean. A mono file is duplicated to two channels; extra channels are
    dropped."""

    pairing = "mono_target_stereo"

    def __init__(self, data_dir, sample_rate: int = 22050,
                 chunk_duration: float = 2.0, **kw):
        super().__init__(data_dir, sample_rate, chunk_duration, mono=False,
                         extensions=(".wav", ".flac"), **kw)

    def __getitem__(self, idx):
        audio = self._chunk(self.files[idx], mono=False)
        if audio.shape[0] == 1:
            audio = np.repeat(audio, 2, axis=0)
        elif audio.shape[0] > 2:
            audio = audio[:2]
        return {"stereo": audio}


class SuperResolutionDataset(ChunkDataset):
    """High-rate mono chunks; the train step derives the low-rate input
    with the align_corners=False linear downsample."""

    pairing = "downsample"

    def __init__(self, data_dir, low_sample_rate: int = 22050,
                 high_sample_rate: int = 44100, chunk_duration: float = 2.0,
                 **kw):
        super().__init__(data_dir, high_sample_rate, chunk_duration,
                         mono=True, extensions=(".wav", ".flac"), **kw)
        self.low_sample_rate = low_sample_rate
        self.low_chunk_size = int(low_sample_rate * chunk_duration)

    def __getitem__(self, idx):
        return {"high": self._chunk(self.files[idx])}
