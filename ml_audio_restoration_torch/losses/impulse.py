"""Impulse/transient loss of the denoiser, counterpart of
ml_audio_restoration_tpu/losses/impulse.py: L1 on second derivatives plus
0.5x a transient error masked where the target's first-derivative
magnitude exceeds twice its mean.
"""
from __future__ import annotations

import torch

from ..parallel import distributed as dist


def impulse_loss(output, target):
    """output/target: [B, T, C] -> scalar."""
    out_d1 = torch.abs(output[:, 1:] - output[:, :-1])
    tgt_d1 = torch.abs(target[:, 1:] - target[:, :-1])
    out_d2 = torch.abs(out_d1[:, 1:] - out_d1[:, :-1])
    tgt_d2 = torch.abs(tgt_d1[:, 1:] - tgt_d1[:, :-1])

    l1_d2 = torch.mean(torch.abs(out_d2 - tgt_d2))

    transient_error = torch.abs(out_d1 - tgt_d1)
    level = torch.mean(tgt_d1)
    if dist.in_global_batch():  # the global batch's mean, as under JAX
        level = dist.mean_over_ranks(level)
    high_energy = (tgt_d1 > level * 2.0).to(output.dtype)
    weighted = torch.mean(transient_error * high_energy)
    return l1_d2 + weighted * 0.5
