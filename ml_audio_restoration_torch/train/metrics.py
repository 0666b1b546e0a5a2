"""Training metrics: a JSONL event log, optional TensorBoard, WAV audio.

Counterpart of ml_audio_restoration_tpu/train/metrics.py: batch loss and
learning rate every 50 steps, epoch losses and duration, stereo
correlation and width, and audio samples written as WAVs beside the log.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir, run_name: str = "run"):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / f"{run_name}.jsonl"
        self._file = open(self.path, "a", buffering=1)
        self._tb = None
        try:  # optional TensorBoard
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(str(self.log_dir / "tb"))

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        self._file.write(json.dumps(
            {"t": time.time(), "tag": tag, "value": value, "step": step})
            + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, scalars: dict, step: int, prefix: str = ""):
        """add_scalar for each {tag: value}, each tag behind `prefix`."""
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}{k}", v, step)

    def add_audio(self, tag: str, audio, sample_rate: int, step: int):
        """audio: [C, T] -> WAV under <log_dir>/audio/."""
        from ..audio import save_audio

        audio = np.asarray(audio, np.float32)
        out = self.log_dir / "audio" / f"{tag.replace('/', '_')}_{step}.wav"
        save_audio(out, audio, sample_rate)
        if self._tb is not None:
            import torch

            self._tb.add_audio(tag, torch.from_numpy(audio.T), step,
                               sample_rate=sample_rate)

    def add_text(self, tag: str, text: str, step: int = 0):
        self._file.write(json.dumps(
            {"t": time.time(), "tag": tag, "text": text, "step": step})
            + "\n")
        if self._tb is not None:
            self._tb.add_text(tag, text, step)

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()
