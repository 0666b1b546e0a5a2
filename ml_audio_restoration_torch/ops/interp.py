"""Linear interpolation, counterpart of ml_audio_restoration_tpu/ops/interp.py.

torch's `interpolate(mode="linear", align_corners=False)` computes its source
positions in float32 for float32 tensors, which is what the JAX version
reproduces; passing `size` (not a scale factor) gives the same scale
T / out_len as the JAX code.

`upsample_linear` (the SR residual and source-rate stereo's side) computes
the JAX version's arithmetic itself, from each output sample's index in the
whole recording, so that a time window of a recording (sequence-parallel
serving, parallel/sequence.py) gives the matching slice of the whole bit
for bit: past output index 2**23, `dst + 0.5` rounds in float32, and a
window that counted from its own start would round elsewhere.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def interp_linear(x, out_len: int):
    """Resize [B, C, T] -> [B, C, out_len] (half-pixel centres, edge clamped)."""
    return F.interpolate(x, size=out_len, mode="linear", align_corners=False)


def upsample_linear(x, factor: int, *, offset: int = 0,
                    total: Optional[int] = None):
    """[B, C, t] -> [B, C, t * factor], linear with half-pixel centres.

    `x` holds samples [offset, offset + t) of a recording of `total`
    samples (default: x is the whole recording); the result holds the
    upsampled recording's samples [offset * factor, (offset + t) * factor).
    Each source position is (dst + 0.5) * (1 / factor) - 0.5 in float32
    from the output's index dst in the whole recording, as the JAX
    version computes it, clamped at the recording's real ends only. So an
    output sample whose two source samples lie inside the window equals
    the whole's bit for bit; at the window's own edges the missing
    neighbour is the window's edge sample (a halo the caller crops)."""
    t = x.shape[-1]
    total = t if total is None else total
    dst = torch.arange(offset * factor, (offset + t) * factor,
                       device=x.device).to(torch.float32)
    src = (dst + 0.5) * (total / (total * factor)) - 0.5
    src = torch.clamp(src, 0.0, total - 1)
    lo = torch.floor(src)
    w = (src - lo).to(x.dtype)
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=total - 1)
    lo = torch.clamp(lo - offset, 0, t - 1)
    hi = torch.clamp(hi - offset, 0, t - 1)
    return x[..., lo] * (1 - w) + x[..., hi] * w
