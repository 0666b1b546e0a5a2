"""STFT with torch.stft's framing: center=True reflect padding, a periodic
Hann window, one-sided spectrum, 1 + T//hop frames.

Counterpart of ml_audio_restoration_tpu/ops/stft.py (hann_window, frame,
stft, stft_magnitude, istft). The frequency axis is last, [B, frames, bins],
as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
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


def istft(spec, n_fft: int, hop: int, *, window=None,
          length: int | None = None):
    """Inverse STFT: overlap-add with window-square normalization, the JAX
    package's arithmetic (not torch.istft, whose envelope check and
    normalization differ).

    spec: [B, frames, n_fft//2 + 1] complex -> [B, length] real (the
    centre padding cropped, then the first `length` samples kept). With
    the default window and hop dividing n_fft, the overlap-add is n_fft/hop
    shifted adds of hop-sized segments and the normalization is built in
    float64 numpy and cast once; a given window or hop that does not divide
    n_fft takes the scatter form."""
    out = overlap_add_frames(spec, n_fft, hop, window=window)
    pad = n_fft // 2
    out = out[:, pad:out.shape[1] - pad]
    if length is not None:
        out = out[:, :length]
    return out


def overlap_add_frames(spec, n_fft: int, hop: int, *, window=None):
    """`istft`'s overlap-add before the centre crop: [B, frames, n_fft//2 +
    1] complex -> [B, n_fft + hop * (frames - 1)] real."""
    win_np = None
    if window is None:
        win_np = hann_window(n_fft).numpy()
        window = torch.from_numpy(win_np).to(spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    b, nf, _ = frames.shape
    total = n_fft + hop * (nf - 1)
    if n_fft % hop == 0 and win_np is not None:
        k = n_fft // hop
        segs = frames.reshape(b, nf, k, hop)
        out = torch.zeros((b, nf + k - 1, hop), dtype=frames.dtype,
                          device=frames.device)
        for s in range(k):
            out = out + torch.nn.functional.pad(
                segs[:, :, s, :], (0, 0, s, k - 1 - s))
        out = out.reshape(b, total)
        w2 = win_np.astype(np.float64) ** 2
        norm = np.zeros((nf + k - 1, hop))
        for s in range(k):
            norm[s:s + nf] += w2[s * hop:(s + 1) * hop]
        out = out / torch.from_numpy(np.maximum(norm.reshape(total), 1e-8)
                                     ).to(frames.dtype).to(frames.device)
    else:
        idx = (torch.arange(nf, device=frames.device)[:, None] * hop
               + torch.arange(n_fft, device=frames.device)[None, :])
        out = torch.zeros((b, total), dtype=frames.dtype,
                          device=frames.device)
        out = out.index_add(1, idx.reshape(-1), frames.reshape(b, -1))
        norm = torch.zeros((total,), dtype=frames.dtype,
                           device=frames.device)
        norm = norm.index_add(0, idx.reshape(-1),
                              (window ** 2).to(frames.dtype).repeat(nf))
        out = out / torch.clamp(norm, min=1e-8)
    return out
