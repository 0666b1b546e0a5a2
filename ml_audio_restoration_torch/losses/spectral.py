"""Multi-scale spectral loss.

Counterpart of multiscale_spectral_loss in ml_audio_restoration_tpu/losses/
spectral.py: log-magnitude L1 at FFT sizes (512, 1024, 2048), hop = fft/4,
periodic Hann, log(|S| + 1e-5), averaged over scales, channels and batch.
Takes [B, T, C] (channels last), as the JAX package does. The transient
spectral loss is not ported yet.
"""
from __future__ import annotations

import torch

from ..ops import stft_magnitude

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
