"""Attention of the band-split transformer (models/bs_roformer.py).

- `rope_table(freqs, n)`: the rotary position embedding's rotations for
  positions 0..n-1 along the attended axis, as unit complex numbers
  exp(i * position * freq), one per pair of channels; the angles are
  computed in float32 whatever the activations' dtype;
- `rope(x, table)`: rotates the channel pairs of x by them (the table
  broadcast against x's pairs, so q and k rotate in one product). The
  pairs are interleaved, channels (2i, 2i + 1), as
  `rotary_embedding_torch` (`rotate_half` on `... (d r)` with r = 2)
  pairs them: the pair is one complex number, so the rotation is one
  complex product;
- `attention(q, k, v)`: softmax(q k^T / sqrt(D)) v over [B, H, n, D]. On
  the card it is `F.scaled_dot_product_attention` restricted to the fused
  backends (in float32, where flash attention takes no float32, that is
  the memory-efficient kernel), so it never falls back to the math
  backend, which would hold the [n, n] scores of every sequence; its
  batch is cut into pieces the kernel's launch grid takes. Elsewhere it
  is `attention_plain`, the formula written out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# the fused kernel's launch grid puts the batch on its z axis (at most
# 65,535 blocks)
MAX_BATCH = 32768


def rope_table(freqs, n: int):
    """exp(i * p * freqs[j]) for p in 0..n-1 -> complex64 [n, len(freqs)].
    `freqs` is the embedding's `freqs` (theta ** (-2j / D)), on the
    activations' device."""
    pos = torch.arange(n, dtype=torch.float32, device=freqs.device)
    angles = pos[:, None] * freqs.float()[None, :]
    return torch.polar(torch.ones_like(angles), angles)


def rope(x, table):
    """x [..., D] rotated pair by pair: (x[..., 2j] + i x[..., 2j+1]) times
    the entry of `table` (complex, broadcast against [..., D/2]) at the
    same place. Computed in float32, returned in x's dtype."""
    pairs = x.float().unflatten(-1, (-1, 2))
    if pairs.stride(-1) != 1 or any(s % 2 for s in pairs.stride()[:-1]):
        pairs = pairs.contiguous()
    rotated = torch.view_as_complex(pairs) * table
    return torch.view_as_real(rotated).flatten(-2).to(x.dtype)


def attention_plain(q, k, v):
    """softmax(q k^T / sqrt(D)) v, the scores written out: [B, H, n, D]."""
    scores = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.softmax(scores, dim=-1) @ v


def attention(q, k, v):
    """Scaled dot-product attention over [B, H, n, D] -> [B, H, n, D]."""
    if q.device.type != "cuda":
        return attention_plain(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    with sdpa_kernel(fused):
        if q.shape[0] <= MAX_BATCH:
            return F.scaled_dot_product_attention(q, k, v)
        return torch.cat([F.scaled_dot_product_attention(*parts)
                          for parts in zip(q.split(MAX_BATCH),
                                           k.split(MAX_BATCH),
                                           v.split(MAX_BATCH))])
