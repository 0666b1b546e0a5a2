"""Training datasets: host-side chunk readers.

Counterpart of ml_audio_restoration_tpu/data/datasets.py: ChunkDataset,
RestorationDataset, StereoDataset, SuperResolutionDataset and the
denoiser's semi-supervised MixedRestorationDataset and
AdaptiveArtifactDataset. Each item is one random chunk of one file,
float32 [C, chunk], normalized to -20 dB RMS and zero-padded to the chunk
size, read with a seek for long files. Datasets yield clean audio (or, for
the real items of the mixed set, the degraded recording); the train step
derives (input, target) from each batch on the device as the dataset's
`pairing` says (the 78rpm degradation runs there, data/artifacts.py).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..audio import (
    detect_impulses_analytical, find_audio_files, load_audio,
    load_audio_chunk, native, normalize_audio)

# what the degraded directories of the semi-supervised datasets list
DEGRADED_EXTENSIONS = (".wav", ".mp3", ".flac")


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
    """The batch read route of the JAX package's mono datasets, which the
    DataLoader takes through `getitems`: one start drawn for every item,
    `rng.integers(0, max(frames - chunk, 0) + 1)` (for a file no longer
    than the chunk that range is {0}, which numpy returns without a draw,
    as the per-item route draws none), then one call of the C++ codec's
    batch reader (`native.read_batch_mono`) decodes every mono row, each
    zero-padded to the chunk, over `threads` threads (the loader passes
    its `num_workers`), and the -20 dB RMS normalization and clip guard
    run vectorized over the batch with each row's RMS over its true
    length. The starts are drawn before the read, so the batch does not
    depend on the thread count. A batch with a file that is not WAV or
    FLAC, at another rate, or that the codec cannot read falls back to
    per-item reads after the starts already drawn, as there."""

    def getitems(self, indices, threads: int = 1):
        paths = [self.files[i] for i in indices]
        if not all(str(p).lower().endswith((".wav", ".flac")) for p in paths):
            return [self[i] for i in indices]
        starts, lengths = [], []
        for p in paths:
            meta = native.info(p)
            if meta is None or meta["sample_rate"] != self.sample_rate:
                return [self[i] for i in indices]
            max_start = max(meta["frames"] - self.chunk_size, 0)
            starts.append(int(self.rng.integers(0, max_start + 1)))
            lengths.append(min(meta["frames"], self.chunk_size))
        batch = native.read_batch_mono(paths, starts, self.chunk_size,
                                       threads=max(1, threads))
        if batch is None:
            return [self[i] for i in indices]
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


class MixedRestorationDataset(ChunkDataset):
    """Synthetic and real items for semi-supervised training: {'audio',
    'is_synthetic'}. The first `synthetic_ratio` of the indices are
    synthetic (clean audio, degraded in the train step); the rest are real
    degraded recordings from `degraded_data_dir`, their own target. With
    no degraded recordings every item is synthetic. `use_contrastive` pairs
    each item with a chunk of the other type drawn from the dataset's
    generator ('contrastive_pair', label 0 = different type); a synthetic
    item's pair is a real recording, a real item's a clean chunk that the
    train step degrades."""

    pairing = "mixed"

    def __init__(self, clean_data_dir, degraded_data_dir=None,
                 sample_rate: int = 22050, chunk_duration: float = 2.0,
                 synthetic_ratio: float = 0.7, use_contrastive: bool = False,
                 **kw):
        super().__init__(clean_data_dir, sample_rate, chunk_duration,
                         mono=True, **kw)
        self.degraded_files = []
        if degraded_data_dir and Path(degraded_data_dir).is_dir():
            self.degraded_files = find_audio_files(
                degraded_data_dir, extensions=DEGRADED_EXTENSIONS)
        total = len(self.files)
        if self.degraded_files:
            self.num_synthetic = int(total * synthetic_ratio)
        else:
            self.num_synthetic = total
        self.use_contrastive = use_contrastive and bool(self.degraded_files)

    def __getitem__(self, idx):
        use_synthetic = (not self.degraded_files) or idx < self.num_synthetic
        if use_synthetic:
            item = {"audio": self._chunk(self.files[idx % len(self.files)]),
                    "is_synthetic": np.float32(1.0)}
        else:
            real_idx = (idx - self.num_synthetic) % len(self.degraded_files)
            item = {"audio": self._chunk(self.degraded_files[real_idx]),
                    "is_synthetic": np.float32(0.0)}
        if self.use_contrastive:
            if use_synthetic:
                j = int(self.rng.integers(0, len(self.degraded_files)))
                item["contrastive_pair"] = self._chunk(self.degraded_files[j])
                item["contrastive_pair_is_synthetic"] = np.float32(0.0)
            else:
                j = int(self.rng.integers(0, len(self.files)))
                item["contrastive_pair"] = self._chunk(self.files[j])
                item["contrastive_pair_is_synthetic"] = np.float32(1.0)
            item["contrastive_label"] = np.float32(0.0)
        return item


class AdaptiveArtifactDataset(ChunkDataset):
    """Clean chunks with per-item degradation parameters fitted to real
    78rpm recordings: the impulse rate, amplitude bound and noise floor of
    up to five recordings of `reference_degraded_dir` picked by the
    dataset's generator, re-fitted every `analyze_every` epochs (the
    trainer calls on_epoch_end) or, used outside a trainer, every
    `analyze_every` passes over the items. Each item draws its rate and
    noise level around the fitted means."""

    pairing = "degrade_adaptive"

    def __init__(self, clean_data_dir, reference_degraded_dir,
                 sample_rate: int = 22050, chunk_duration: float = 2.0,
                 analyze_every: int = 100, **kw):
        super().__init__(clean_data_dir, sample_rate, chunk_duration,
                         mono=True, **kw)
        self.degraded_files = find_audio_files(
            reference_degraded_dir, extensions=DEGRADED_EXTENSIONS)
        if not self.degraded_files:
            raise ValueError(
                f"No reference recordings in {reference_degraded_dir}")
        self.analyze_every = analyze_every
        self._counter = 0
        self._epoch = 0
        self._hook_used = False
        self.artifact_params = self._analyze_real_artifacts()

    def _analyze_real_artifacts(self):
        """Impulse rate and amplitude (detect_impulses_analytical) and the
        noise floor (the spread of the quietest 10% of samples) of up to
        five recordings, with their spreads."""
        rates, amps, noise_levels = [], [], []
        num = min(5, len(self.degraded_files))
        picks = self.rng.choice(len(self.degraded_files), num, replace=False)
        for i in picks:
            audio, _ = load_audio(self.degraded_files[i], self.sample_rate,
                                  mono=True)
            _, _, stats = detect_impulses_analytical(audio, self.sample_rate)
            if stats["num_impulses"] > 0:
                rates.append(stats["impulses_per_second"])
                amps.append(stats["max_amplitude"])
            flat = audio.reshape(-1)
            thresh = np.percentile(np.abs(flat), 10)
            quiet = flat[np.abs(flat) < thresh]
            if quiet.size:
                noise_levels.append(float(np.std(quiet)))
        return {
            "impulse_rate": float(np.mean(rates)) if rates else 10.0,
            "impulse_rate_std": (float(np.std(rates)) if len(rates) > 1
                                 else 5.0),
            "impulse_amplitude_max": float(np.mean(amps)) if amps else 0.5,
            "noise_level": (float(np.mean(noise_levels)) if noise_levels
                            else 0.02),
            "noise_level_std": (float(np.std(noise_levels))
                                if len(noise_levels) > 1 else 0.01),
        }

    def on_epoch_end(self):
        """Re-fit every `analyze_every` epochs; the trainer calls it after
        each epoch, which turns the item-counter schedule off."""
        self._hook_used = True
        self._epoch += 1
        if self._epoch % self.analyze_every == 0:
            self.artifact_params = self._analyze_real_artifacts()

    def __getitem__(self, idx):
        if not self._hook_used:
            self._counter += 1
            if self._counter >= self.analyze_every * len(self):
                self.artifact_params = self._analyze_real_artifacts()
                self._counter = 0
        p = self.artifact_params
        rate = float(np.clip(self.rng.normal(p["impulse_rate"],
                                             p["impulse_rate_std"]),
                             1.0, 50.0))
        noise = float(np.clip(self.rng.normal(p["noise_level"],
                                              p["noise_level_std"]),
                              0.005, 0.1))
        return {"clean": self._chunk(self.files[idx]),
                "impulse_rate": np.float32(rate),
                "impulse_amplitude_max": np.float32(
                    p["impulse_amplitude_max"]),
                "noise_level": np.float32(noise)}
