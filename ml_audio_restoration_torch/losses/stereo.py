"""Stereo-quality losses and metrics, counterpart of
ml_audio_restoration_tpu/losses/stereo.py.

- spectral_clustering_loss / temporal_consistency_loss: the two stereo
  terms of the training loss (weights 0.1 / 0.05);
- stereo_balance_loss / decorrelation_loss / low_frequency_centering_loss
  / stereo_stats_match_loss: optional terms, weight 0 by default;
- stereo_metrics: L/R correlation and width, for monitoring.

All take [B, T, 2] channels-last stereo.
"""
from __future__ import annotations

import torch

from ..ops import stft_magnitude

_EPS = 1e-8


def _smooth_l1(x):
    """Huber with beta=1, F.smooth_l1_loss's default."""
    absx = torch.abs(x)
    return torch.mean(torch.where(absx < 1.0, 0.5 * x * x, absx - 0.5))


def spectral_clustering_loss(stereo, n_fft: int = 2048):
    """Smooth-L1 on adjacent-frequency-bin differences of the stereo
    position (L-R)/(L+R): similar frequencies should pan together."""
    hop = n_fft // 4
    left_mag = stft_magnitude(stereo[:, :, 0], n_fft, hop)
    right_mag = stft_magnitude(stereo[:, :, 1], n_fft, hop)
    position = (left_mag - right_mag) / (left_mag + right_mag + _EPS)
    return _smooth_l1(torch.diff(position, dim=-1))


def temporal_consistency_loss(stereo, window: int = 512, hop: int = 256):
    """L2 on adjacent-window changes of the width side/(mid+side), over the
    RMS energies of 512-sample windows."""
    t = stereo.shape[1]
    num_windows = (t - window) // hop + 1
    if num_windows < 2:
        # fewer than two windows (T < window + hop): the diff over windows
        # would be empty and its mean NaN, poisoning the whole loss
        return torch.zeros((), dtype=stereo.dtype, device=stereo.device)
    lw = stereo[:, :, 0].unfold(1, window, hop)  # [B, W, window]
    rw = stereo[:, :, 1].unfold(1, window, hop)
    l_rms = torch.sqrt(torch.mean(lw ** 2, dim=-1) + _EPS)
    r_rms = torch.sqrt(torch.mean(rw ** 2, dim=-1) + _EPS)
    mid = (l_rms + r_rms) / 2.0
    side = torch.abs(l_rms - r_rms) / 2.0
    width = side / (mid + side + _EPS)
    return torch.mean(torch.square(torch.diff(width, dim=-1)))


def stereo_balance_loss(output, target, threshold: float = 0.5):
    """Hinge on |log L/R RMS ratio deviation| beyond `threshold`."""
    def ratio(x):
        l_rms = torch.sqrt(torch.mean(x[:, :, 0] ** 2, dim=1) + _EPS)
        r_rms = torch.sqrt(torch.mean(x[:, :, 1] ** 2, dim=1) + _EPS)
        return l_rms / (r_rms + _EPS)

    diff = torch.log(ratio(output) + _EPS) - torch.log(ratio(target) + _EPS)
    return torch.mean(torch.clamp(torch.abs(diff) - threshold, min=0.0))


def _lr_correlation(x):
    """Per-item Pearson correlation of L and R -> [B] (signed)."""
    left, right = x[:, :, 0], x[:, :, 1]
    ln = (left - left.mean(dim=1, keepdim=True)) / (
        left.std(dim=1, correction=0, keepdim=True) + _EPS)
    rn = (right - right.mean(dim=1, keepdim=True)) / (
        right.std(dim=1, correction=0, keepdim=True) + _EPS)
    return torch.mean(ln * rn, dim=1)


def decorrelation_loss(output):
    """Squared Pearson correlation of L and R."""
    return torch.mean(_lr_correlation(output) ** 2)


def low_frequency_centering_loss(output, n_fft: int = 2048,
                                 low_freq_bins: int = 14):
    """L1 between L/R STFT magnitudes below ~150 Hz (bins 0..13 at
    22.05 kHz)."""
    hop = n_fft // 4
    lm = stft_magnitude(output[:, :, 0], n_fft, hop)[:, :, :low_freq_bins]
    rm = stft_magnitude(output[:, :, 1], n_fft, hop)[:, :, :low_freq_bins]
    return torch.mean(torch.abs(lm - rm))


def stereo_stats_match_loss(output, target):
    """Squared error between the output's and the target's per-item L/R
    correlation and energy width side/(mid+side)."""
    def stats(x):
        left, right = x[:, :, 0], x[:, :, 1]
        corr = _lr_correlation(x)
        mid_e = torch.mean(torch.square((left + right) / 2.0), dim=1)
        side_e = torch.mean(torch.square((left - right) / 2.0), dim=1)
        return corr, side_e / (mid_e + side_e + _EPS)

    corr_out, width_out = stats(output)
    corr_tgt, width_tgt = stats(target)
    return (torch.mean(torch.square(corr_out - corr_tgt))
            + torch.mean(torch.square(width_out - width_tgt)))


def stereo_moments(output):
    """The batch means stereo_metrics reads: [mean L/R correlation, mid
    energy, side energy]. A data-parallel step averages them over the
    ranks before the metrics are formed."""
    left = output[:, :, 0]
    right = output[:, :, 1]
    return torch.stack([torch.mean(_lr_correlation(output)),
                        torch.mean(((left + right) / 2.0) ** 2),
                        torch.mean(((left - right) / 2.0) ** 2)])


def stereo_metrics(output=None, moments=None):
    """Monitoring metrics: |L/R correlation| and width = side/(mid+side),
    of `output` or of its stereo_moments."""
    corr, mid_e, side_e = (stereo_moments(output) if moments is None
                           else moments)
    return {"correlation": torch.abs(corr),
            "width": side_e / (mid_e + side_e + _EPS)}
