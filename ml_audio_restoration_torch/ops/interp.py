"""Linear interpolation, counterpart of ml_audio_restoration_tpu/ops/interp.py.

torch's `interpolate(mode="linear", align_corners=False)` computes its source
positions in float32 for float32 tensors, which is what the JAX version
reproduces; passing `size` (not a scale factor) gives the same scale
T / out_len as the JAX code.
"""
from __future__ import annotations

import torch.nn.functional as F


def interp_linear(x, out_len: int):
    """Resize [B, C, T] -> [B, C, out_len] (half-pixel centres, edge clamped)."""
    return F.interpolate(x, size=out_len, mode="linear", align_corners=False)


def upsample_linear(x, factor: int):
    """interp_linear with out_len = T * factor (the SR residual path)."""
    return interp_linear(x, x.shape[-1] * factor)
