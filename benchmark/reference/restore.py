"""Plain reference of offline restoration: the recording framed into
overlapping chunks, the three models on each chunk, the chunks crossfaded
back with trapezoid windows.

The definition the program's `RestorationPipeline.restore` computes, with
none of its machinery: no chunk-count buckets, no slabs (the program's
slab crossfade reproduces the single-shot chunk overlap-add), chunks run
in blocks only to bound memory, and each output added in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import models as M


def framing(chunk_seconds: float, overlap_seconds: float, rate: int):
    """(chunk, hop, overlap) in samples at `rate`."""
    chunk = int(round(chunk_seconds * rate))
    overlap = int(round(overlap_seconds * rate))
    return chunk, chunk - overlap, overlap


def count(length: int, chunk: int, hop: int) -> int:
    return 1 if length <= chunk else 1 + -(-(length - chunk) // hop)


def window(length: int, overlap: int, device) -> torch.Tensor:
    """Linear ramps of `overlap` samples, (k+1)/(overlap+1), at both ends."""
    w = torch.ones(length, device=device)
    if overlap > 0:
        ramp = (torch.arange(overlap, device=device) + 1.0) / (overlap + 1.0)
        w[:overlap] = ramp
        w[-overlap:] = ramp.flip(0)
    return w


class Crossfade:
    """Accumulates windowed frames [..., C, length] `hop` apart into
    [..., C, total] and divides by the summed window."""

    def __init__(self, lead: tuple, total: int, length: int, overlap: int,
                 device):
        self.out = torch.zeros((*lead, total), device=device)
        self.norm = torch.zeros(total, device=device)
        self.win = window(length, overlap, device)
        self.length = length

    def add(self, start: int, frame):
        self.out[..., start:start + self.length] += frame * self.win
        self.norm[start:start + self.length] += self.win

    def result(self, length: int):
        return (self.out / self.norm.clamp(min=1e-12))[..., :length]


def stereo_stage(cfg, sd, x, rate, ops, lstm):
    """The stereo stage on [N, 1, T2] -> [N, 2, T2]; over internal windows
    when the configuration sets `stereo_chunk_seconds`."""
    t2 = x.shape[-1]
    windows = sub_windows(cfg, t2, rate)
    if windows is None:
        return M.stereo(sd, x, ops=ops, lstm=lstm)
    sub, hop, ov = windows
    m = count(t2, sub, hop)
    total = (m - 1) * hop + sub
    xp = F.pad(x, (0, total - t2))
    frames = torch.stack([xp[..., i * hop:i * hop + sub]
                          for i in range(m)], dim=1)  # [N, M, 1, s]
    n = x.shape[0]
    y = M.stereo(sd, frames.reshape(n * m, 1, sub), ops=ops,
                 lstm=lstm).reshape(n, m, 2, sub)
    fade = Crossfade((n, 2), total, sub, ov, x.device)
    for i in range(m):
        fade.add(i * hop, y[:, i].float())
    return fade.result(t2).to(x.dtype)


def sub_windows(cfg, t2: int, rate: int):
    """The stereo stage's internal windows over a chunk of t2 stage
    samples, (sub, hop, overlap), or None where the configuration sets no
    `stereo_chunk_seconds` or a window covers the chunk."""
    p = cfg["pipeline"]
    if p.get("stereo_chunk_seconds") is None:
        return None
    f = cfg["super_resolution"]["upscale_factor"]
    sub = max(4, int(round(p["stereo_chunk_seconds"] * rate * f)) // 4 * 4)
    ov = min(int(round(p["overlap_seconds"] * rate * f)), sub // 4)
    return None if sub >= t2 else (sub, sub - ov, ov)


def chain(cfg, sds, x, rate, ops=M.F32, lstm=None):
    """Denoiser, super-resolution, stereo on chunks [N, 1, T] ->
    [N, 2, T*f]."""
    h = M.denoiser(sds["denoiser"], x, ops=ops,
                   levels=len(cfg["denoiser"]["features"]))
    h = M.super_resolution(sds["super_resolution"], h, ops=ops,
                           blocks=cfg["super_resolution"][
                               "num_residual_blocks"])
    return stereo_stage(cfg, sds["stereo_separator"], h, rate, ops, lstm)


@torch.no_grad()
def restore(cfg, sds, audio, ops=M.F32, block: int = 64):
    """audio [T] on the device -> [2, T*f] float32, computed in the dtype
    of `audio` and of the state dicts."""
    p = cfg["pipeline"]
    rate = p["sample_rate"]
    f = cfg["super_resolution"]["upscale_factor"]
    chunk, hop, overlap = framing(p["chunk_seconds"], p["overlap_seconds"],
                                  rate)
    t = audio.shape[-1]
    n = count(t, chunk, hop)
    total = (n - 1) * hop + chunk
    xp = F.pad(audio, (0, total - t))
    lstm = M.lstm_module(sds["stereo_separator"], audio.device)
    fade = Crossfade((2,), total * f, chunk * f, overlap * f, audio.device)
    for b0 in range(0, n, block):
        idx = range(b0, min(n, b0 + block))
        x = torch.stack([xp[i * hop:i * hop + chunk] for i in idx])[:, None]
        y = chain(cfg, sds, x, rate, ops, lstm).float()
        for j, i in enumerate(idx):
            fade.add(i * hop * f, y[j])
    return fade.result(t * f)
