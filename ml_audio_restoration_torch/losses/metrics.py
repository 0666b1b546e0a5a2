"""Restoration quality metrics, counterpart of ml_audio_restoration_tpu/
losses/metrics.py: SNR, scale-invariant SDR and log-spectral distance,
all in dB.
"""
from __future__ import annotations

import torch

from ..ops import stft_magnitude

_EPS = 1e-8


def snr(estimate, target, axis=-1):
    """10 log10(||target||^2 / ||target - estimate||^2) in dB."""
    signal = torch.sum(torch.square(target), dim=axis)
    noise = torch.sum(torch.square(target - estimate), dim=axis)
    return 10.0 * torch.log10((signal + _EPS) / (noise + _EPS))


def si_sdr(estimate, target, axis=-1):
    """Scale-invariant SDR: project the estimate onto the target first."""
    dot = torch.sum(estimate * target, dim=axis, keepdim=True)
    energy = torch.sum(torch.square(target), dim=axis, keepdim=True)
    projection = dot / (energy + _EPS) * target
    residual = estimate - projection
    return 10.0 * torch.log10(
        (torch.sum(torch.square(projection), dim=axis) + _EPS)
        / (torch.sum(torch.square(residual), dim=axis) + _EPS))


def lsd(estimate, target, n_fft: int = 2048, hop: int | None = None):
    """Log-spectral distance in dB over [B, T] (or [T]) signals: mean over
    frames of the RMS over bins of 10*(log10|S_est|^2 - log10|S_tgt|^2)."""
    hop = hop or n_fft // 4
    est = torch.atleast_2d(estimate)
    tgt = torch.atleast_2d(target)
    em = stft_magnitude(est, n_fft, hop)
    tm = stft_magnitude(tgt, n_fft, hop)
    d = 10.0 * (torch.log10(torch.square(em) + _EPS)
                - torch.log10(torch.square(tm) + _EPS))
    return torch.mean(torch.sqrt(torch.mean(torch.square(d), dim=-1)))
