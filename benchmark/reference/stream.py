"""Plain reference of live restoration: the three models over each whole
stream at once, which the program's block-by-block output equals past its
first `context` samples (its windows carry enough history and lookahead
for every convolution's reach, and its LSTM state runs unbroken).

Computed in time blocks only to bound memory: the denoiser, SR and the
stereo encoder on each block with a halo of input samples on both sides
(a multiple of 8, the U-Net's pooling grid, and far beyond the nets'
reach), the LSTM through the blocks in order with its state carried, the
decoders on blocks of its output with a halo of their own.
"""
from __future__ import annotations

import torch

from . import models as M

HALO = 1024  # input samples each side of a block
DEC_HALO = 16  # stage-rate frames each side of a decoder block (reach 12)


@torch.no_grad()
def stream(cfg, sds, x, emit: int, ops=M.F32, block: int = 176400):
    """x [S, N] float32 (each stream's whole input, N >= emit + HALO + 8)
    -> [S, 2, emit * f]: the first `emit` input samples' output."""
    f = cfg["super_resolution"]["upscale_factor"]
    dn, sr, st = (sds[k] for k in ("denoiser", "super_resolution",
                                   "stereo_separator"))
    levels = len(cfg["denoiser"]["features"])
    blocks = cfg["super_resolution"]["num_residual_blocks"]
    lstm = M.lstm_module(st, x.device)
    hidden = st["lstm.weight_hh_l0"].shape[1]
    need = emit + DEC_HALO  # input samples whose LSTM output is needed
    lout = torch.empty((x.shape[0], hidden, need * f), device=x.device)
    carry = None
    for a in range(0, need, block):
        b = min(a + block, need)
        lo = max(0, a - HALO)
        seg = x[:, lo:b + HALO][:, None]
        h = M.denoiser(dn, seg, ops=ops, levels=levels)
        h = M.super_resolution(sr, h, ops=ops, blocks=blocks)
        feats = M.stereo_encode(st, h, ops=ops)[..., (a - lo) * f:(b - lo) * f]
        y, carry = M.lstm_run(lstm, feats, carry, ops=ops)
        lout[..., a * f:b * f] = y
    out = torch.empty((x.shape[0], 2, emit * f), device=x.device)
    for a in range(0, emit * f, block * f):
        b = min(a + block * f, emit * f)
        lo = max(0, a - DEC_HALO)
        y = M.stereo_decode(st, lout[..., lo:b + DEC_HALO], ops=ops)
        out[..., a:b] = y[..., a - lo:b - lo]
    return out
