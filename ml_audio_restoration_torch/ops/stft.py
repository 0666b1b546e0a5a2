"""STFT with torch.stft's framing: center=True reflect padding, a periodic
Hann window, one-sided spectrum, 1 + T//hop frames.

Counterpart of ml_audio_restoration_tpu/ops/stft.py (hann_window, frame,
stft, stft_magnitude). The frequency axis is last, [B, frames, bins], as in
the JAX package. The inverse STFT is not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def hann_window(n_fft: int, dtype=torch.float32, device=None):
    """Periodic Hann window 0.5 - 0.5*cos(2*pi*n/N), computed in float64
    and rounded once, as the JAX package builds it with numpy."""
    n = torch.arange(n_fft, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)).to(dtype)


def frame(x, frame_length: int, hop: int, *, center: bool = True):
    """Slice [B, T] into overlapping frames [B, num_frames, frame_length].

    center=True reflect-pads by frame_length//2 on both sides (torch.stft's
    default), giving 1 + T//hop frames. The result is a strided view."""
    if center:
        pad = frame_length // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(-1, frame_length, hop)


def stft(x, n_fft: int, hop: int, *, window=None, center: bool = True):
    """Complex STFT of [B, T] -> [B, frames, n_fft//2 + 1]."""
    if window is None:
        window = hann_window(n_fft, x.dtype, x.device)
    return torch.fft.rfft(frame(x, n_fft, hop, center=center) * window,
                          dim=-1)


def stft_magnitude(x, n_fft: int, hop: int, *, window=None,
                   center: bool = True):
    return torch.abs(stft(x, n_fft, hop, window=window, center=center))
