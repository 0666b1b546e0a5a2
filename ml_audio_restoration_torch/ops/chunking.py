"""Chunk framing and crossfaded overlap-add for long-signal inference.

Counterpart of ml_audio_restoration_tpu/ops/chunking.py, with its layouts:
a recording is [C, T], a chunk batch from `frame_structured` is
[N, chunk, C], and `overlap_add` takes per-chunk outputs [N, C, chunk].
Both use reshapes and one shifted add, no gather or scatter.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def num_chunks(length: int, chunk_size: int, hop: int) -> int:
    if length <= chunk_size:
        return 1
    return 1 + math.ceil((length - chunk_size) / hop)


def chunk_signal(x, chunk_size: int, hop: int):
    """Frame [C, T] into [N, C, chunk_size] chunks `hop` apart, the tail
    zero-padded. Returns (chunks, original length)."""
    c, t = x.shape
    n = num_chunks(t, chunk_size, hop)
    total = (n - 1) * hop + chunk_size
    xp = F.pad(x, (0, total - t))
    return xp.unfold(-1, chunk_size, hop).transpose(0, 1).contiguous(), t


def crossfade_window(chunk_size: int, overlap: int, dtype=torch.float32,
                     device=None):
    """Trapezoid window with linear ramps of `overlap` samples at both ends;
    overlapping trapezoids sum to 1 when hop = chunk_size - overlap."""
    if overlap <= 0:
        return torch.ones((chunk_size,), dtype=dtype, device=device)
    ramp = (torch.arange(overlap, dtype=dtype, device=device) + 1.0) / (
        overlap + 1.0)
    body = torch.ones((chunk_size - 2 * overlap,), dtype=dtype, device=device)
    return torch.cat([ramp, body, ramp.flip(0)])


def _fold(body, tail, hop: int, overlap: int, total: int):
    """Sum chunk bodies [N, C, hop] and tails [N, C, overlap] into [C, total],
    each tail landing at the start of the next chunk's body."""
    n, c, _ = body.shape
    flat_body = F.pad(body.transpose(0, 1).reshape(c, n * hop), (0, overlap))
    tail = F.pad(tail, (0, hop - overlap))
    flat_tail = tail.transpose(0, 1).reshape(c, n * hop)
    shifted_tail = F.pad(flat_tail, (hop, 0))[:, :total]
    return flat_body + shifted_tail


def overlap_add(chunks, hop: int, length: int, *, overlap: int = 0,
                valid=None):
    """Reassemble [N, C, chunk_size] into [C, length] with crossfade.

    Each chunk is weighted by the trapezoid window and the output divided by
    the summed window, so any chunk/hop split is exact. `valid`: number of
    real chunks; chunks with index >= valid (chunk-count bucket padding) get
    zero weight in the output and the normalizer. Requires overlap <= hop."""
    n, c, chunk_size = chunks.shape
    if hop > chunk_size or (chunk_size - hop) != overlap:
        raise ValueError("expect chunk_size = hop + overlap")
    if overlap > hop:
        raise ValueError("overlap must be <= hop (each sample in <=2 chunks)")
    win = crossfade_window(chunk_size, overlap, chunks.dtype, chunks.device)
    total = (n - 1) * hop + chunk_size
    weighted = chunks * win
    mask = None
    if valid is not None:
        mask = (torch.arange(n, device=chunks.device) < valid).to(
            chunks.dtype)[:, None, None]
        weighted = weighted * mask

    if overlap == 0:
        out = weighted.transpose(0, 1).reshape(c, n * chunk_size)
        return out[:, :length]

    out = _fold(weighted[:, :, :hop], weighted[:, :, hop:], hop, overlap,
                total)
    ones = win.expand(n, 1, chunk_size)
    if mask is not None:
        ones = ones * mask
    norm = _fold(ones[:, :, :hop], ones[:, :, hop:], hop, overlap, total)
    return (out / torch.clamp(norm, min=1e-12))[:, :length]


def frame_structured(audio, n_chunks: int, chunk_size: int, hop: int):
    """Frame padded [C, total] into [N, chunk_size, C] without a gather:
    chunk i = row i of a [N, hop] reshape plus the head of row i+1.
    Requires overlap = chunk_size - hop <= hop and
    audio.shape[1] == (n_chunks-1)*hop + chunk_size."""
    c = audio.shape[0]
    overlap = chunk_size - hop
    if overlap == 0:
        return audio.reshape(c, n_chunks, chunk_size).permute(1, 2, 0)
    if overlap > hop:
        raise ValueError("overlap must be <= hop")
    body = audio[:, :n_chunks * hop].reshape(c, n_chunks, hop)
    rest = audio[:, n_chunks * hop:]
    last_head = F.pad(rest, (0, max(hop - rest.shape[1], 0)))[:, None, :hop]
    next_head = torch.cat(
        [audio[:, hop:n_chunks * hop].reshape(c, n_chunks - 1, hop),
         last_head], dim=1)  # [C, N, hop]
    chunks = torch.cat([body, next_head[:, :, :overlap]], dim=-1)
    return chunks.permute(1, 2, 0)  # [N, chunk, C]
