"""Spectral losses.

Counterpart of ml_audio_restoration_tpu/losses/spectral.py:
- multiscale_spectral_loss: log-magnitude L1 at FFT sizes (512, 1024,
  2048), hop = fft/4, periodic Hann, log(|S| + 1e-5), averaged over
  scales, channels and batch;
- detect_transients / transient_spectral_loss: the standalone SpectralLoss
  of the reference's super-resolution module in the JAX package's intended
  form (length-preserving smoothing): alpha * MSE + w * (2x-weighted
  transient L1) + (1 - alpha - w) * the multi-scale term.
Takes [B, T, C] (channels last), as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import moving_average, stft_magnitude

FFT_SIZES = (512, 1024, 2048)
LOG_EPS = 1e-5


def multiscale_spectral_loss(output, target, fft_sizes=FFT_SIZES):
    """Multi-scale log-magnitude L1. output/target: [B, T, C]."""
    b, t, c = output.shape
    out_flat = output.transpose(1, 2).reshape(b * c, t)
    tgt_flat = target.transpose(1, 2).reshape(b * c, t)
    loss = 0.0
    for n_fft in fft_sizes:
        hop = n_fft // 4
        om = stft_magnitude(out_flat, n_fft, hop)
        tm = stft_magnitude(tgt_flat, n_fft, hop)
        loss = loss + torch.mean(torch.abs(torch.log(om + LOG_EPS)
                                           - torch.log(tm + LOG_EPS)))
    return loss / len(fft_sizes)


def _quantile(x, q: float):
    """The q-quantile along the last axis with linear interpolation, as
    jnp.quantile computes it (torch.quantile refuses inputs above 2^24
    elements): the sorted row read at q (n - 1) between its neighbours,
    with n, that position and the weights in f32 as JAX takes them (so past
    2^24 elements the position rounds where JAX's does)."""
    f32 = np.float32
    n = x.shape[-1]
    last = f32(n) - f32(1)
    pos = f32(f32(q) * last)
    high_w = f32(pos - np.floor(pos))
    low_w = f32(1) - high_w

    def index(v):
        return min(int(min(max(v, f32(0)), last)), n - 1)

    srt = torch.sort(x, dim=-1).values
    lo, hi = index(np.floor(pos)), index(np.ceil(pos))
    return (srt[..., lo:lo + 1] * float(low_w)
            + srt[..., hi:hi + 1] * float(high_w))


def detect_transients(audio):
    """Envelope-derivative transient mask: audio [B, T] -> [B, T] in [0, 1].
    The envelope |x| smoothed over 65 samples, its first difference, the
    rows' 90th percentile as the threshold, then dilated over 129
    samples."""
    env = torch.abs(audio)[:, None]  # [B, 1, T]
    env_smooth = moving_average(env, 65)[:, 0]
    diff = torch.abs(env_smooth[:, 1:] - env_smooth[:, :-1])
    diff = torch.nn.functional.pad(diff, (0, 1))
    threshold = _quantile(diff, 0.9)
    mask = (diff > threshold).to(audio.dtype)
    dilated = moving_average(mask[:, None], 129)[:, 0] * 129.0
    return torch.clamp(dilated, 0.0, 1.0)


def transient_spectral_loss(output, target, fft_sizes=FFT_SIZES,
                            alpha: float = 0.3,
                            transient_weight: float = 0.3):
    """alpha * MSE + w * (2x-weighted transient L1) + (1 - alpha - w) *
    multi-scale spectral, on [B, T, C]; the mask comes from the target's
    first channel."""
    time_loss = torch.mean(torch.square(output - target))
    mask = detect_transients(target[:, :, 0])[:, :, None]
    diff = torch.abs(output - target)
    transient_loss = torch.mean(diff * mask)
    steady_loss = torch.mean(diff * (1.0 - mask))
    transient_time_loss = transient_loss * 2.0 + steady_loss
    spec = multiscale_spectral_loss(output, target, fft_sizes)
    return (alpha * time_loss + transient_weight * transient_time_loss
            + (1.0 - alpha - transient_weight) * spec)
