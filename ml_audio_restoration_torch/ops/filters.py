"""Butterworth design on the host and the cutoff-bank index.

Counterpart of the parts of ml_audio_restoration_tpu/ops/filters.py that
the artifact simulator's FIR path uses: `butter_sos` (scipy, cached as
numpy) and `bank_index`, the nearest-grid rule every coefficient bank
shares. The IIR scans (`sosfilt`, `sosfiltfilt`), which only
`filter_mode="iir"` runs, are not ported yet (the simulator's IIR path,
ROADMAP §1).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def butter_sos(order: int, cutoff_hz: float, sample_rate: float, btype: str):
    """Butterworth as cascaded biquads (SOS) and per-section sosfilt_zi:
    (sos [S, 6], zi [S, 2]) float32 numpy arrays."""
    from scipy import signal as _sig

    wn = cutoff_hz / (sample_rate / 2.0)
    sos = _sig.butter(order, wn, btype=btype, output="sos")
    zi = _sig.sosfilt_zi(sos)
    return np.asarray(sos, np.float32), np.asarray(zi, np.float32)


def bank_index(num: int, freq, f_lo: float, f_hi: float):
    """Nearest index of a `num`-point linspace over [f_lo, f_hi] for each
    cutoff in `freq` (a float32 tensor): round half to even, clipped."""
    idx = torch.round((freq - f_lo) / (f_hi - f_lo) * (num - 1))
    return torch.clamp(idx.to(torch.int32), 0, num - 1)
