"""Impulse analytics for real 78rpm recordings.

The port's copy of `detect_impulses_analytical` from
ml_audio_restoration_tpu/audio/analyze.py (numpy and scipy), which
AdaptiveArtifactDataset uses to fit the simulator's impulse rate and
amplitude to real recordings. The plotting and report functions are not
ported yet (ROADMAP item 5).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def detect_impulses_analytical(audio, sample_rate: int,
                               threshold_percentile: float = 99.5
                               ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """audio [C, T] (the first channel is used) or [T] -> (peak indices,
    amplitudes, stats): peaks of |second difference| above its
    `threshold_percentile` percentile, at least 1 ms apart."""
    from scipy import signal

    x = np.asarray(audio)
    if x.ndim > 1:
        x = x[0]

    d1 = np.diff(x, prepend=x[0])
    d2 = np.abs(np.diff(d1, prepend=d1[0]))

    threshold = np.percentile(d2, threshold_percentile)
    peaks, _ = signal.find_peaks(
        d2, height=threshold, distance=int(sample_rate * 0.001))
    amplitudes = d2[peaks]

    stats = {
        "num_impulses": int(len(peaks)),
        "impulses_per_second": len(peaks) / (len(x) / sample_rate),
        "mean_amplitude": (float(np.mean(amplitudes)) if len(amplitudes)
                           else 0.0),
        "median_amplitude": (float(np.median(amplitudes)) if len(amplitudes)
                             else 0.0),
        "max_amplitude": float(np.max(amplitudes)) if len(amplitudes) else 0.0,
        "std_amplitude": float(np.std(amplitudes)) if len(amplitudes) else 0.0,
        "threshold_used": float(threshold),
    }
    if len(peaks) > 1:
        intervals = np.diff(peaks) / sample_rate
        stats["mean_interval"] = float(np.mean(intervals))
        stats["median_interval"] = float(np.median(intervals))
        stats["min_interval"] = float(np.min(intervals))
    return peaks, amplitudes, stats
