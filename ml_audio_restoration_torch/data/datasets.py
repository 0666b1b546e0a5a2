"""Training datasets: host-side chunk readers.

Counterpart of ChunkDataset and StereoDataset in
ml_audio_restoration_tpu/data/datasets.py. Each item is one random chunk
of one file, float32 [C, chunk], normalized to -20 dB RMS and zero-padded
to the chunk size, read with a seek for long files. A dataset declares in
`pairing` how the train step derives (input, target) from its batches.
The other datasets (denoiser, super-resolution, mixed, adaptive) are not
ported yet.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..audio import find_audio_files, load_audio_chunk, normalize_audio


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
                f"item 7)")
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
