"""Semi-supervised losses for mixed synthetic and real degraded training.

The port's copy of ml_audio_restoration_tpu/losses/semi_supervised.py, on
channels-last [B, T, C] tensors: supervised MSE on the synthetic items, a
consistency regularizer for the real ones (smoothness hinge x0.3, energy
MSE x0.2, rfft log-magnitude L1 x0.5), cycle consistency (re-degrade the
restored audio, restore it again) and a cosine contrastive loss. Every
branch runs over the whole batch weighted by the item mask, no boolean
indexing, so shapes never depend on the mix.
"""
from __future__ import annotations

import torch

from ..parallel import distributed as dist

_EPS = 1e-8


def _masked_mean(x, mask):
    """Mean of x over the items whose mask entry is 1: x [B, ...], mask
    [B] in {0, 1}; `x[mask].mean()` for equal-size items. Inside a
    data-parallel train step (parallel.distributed.global_batch) the mean
    is over every rank's masked items: the numerator and the count are
    summed over the ranks, since the ranks may hold different numbers of
    them."""
    per_item = x.reshape(x.shape[0], -1).mean(dim=-1)
    if dist.in_global_batch():
        total, count = dist.all_reduce_sum(
            torch.stack([(per_item * mask).sum(),
                         mask.sum().to(per_item.dtype)])).unbind(0)
        return total / torch.clamp(count, min=1.0)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (per_item * mask).sum() / denom


def supervised_loss(output, target, mask=None):
    sq = torch.square(output - target)
    return sq.mean() if mask is None else _masked_mean(sq, mask)


def consistency_loss(output, inputs, mask=None):
    """Regularizer for real degraded audio (no ground truth):
    output/inputs [B, T, C]."""
    out_diff = torch.abs(output[:, 1:] - output[:, :-1])
    in_diff = torch.abs(inputs[:, 1:] - inputs[:, :-1])
    energy_sq = torch.square(torch.sum(output ** 2, dim=1)
                             - torch.sum(inputs ** 2, dim=1))
    if mask is None:
        smoothness = torch.relu(out_diff.mean() - in_diff.mean() * 0.5)
        energy = energy_sq.mean()
    else:
        smoothness = torch.relu(_masked_mean(out_diff, mask)
                                - _masked_mean(in_diff, mask) * 0.5)
        energy = _masked_mean(energy_sq, mask)

    n_fft = min(2048, inputs.shape[1])
    out_mag = torch.abs(torch.fft.rfft(output, n=n_fft, dim=1))
    in_mag = torch.abs(torch.fft.rfft(inputs, n=n_fft, dim=1))
    log_l1 = torch.abs(torch.log(out_mag + _EPS) - torch.log(in_mag + _EPS))
    spectral = log_l1.mean() if mask is None else _masked_mean(log_l1, mask)
    return smoothness * 0.3 + energy * 0.2 + spectral * 0.5


def contrastive_loss(features_a, features_b, label):
    """MSE of the cosine similarity of two [B, D] feature sets against a
    same (1) / different (0) type label [B]."""
    a = features_a / (torch.linalg.vector_norm(features_a, dim=-1,
                                               keepdim=True) + _EPS)
    b = features_b / (torch.linalg.vector_norm(features_b, dim=-1,
                                               keepdim=True) + _EPS)
    similarity = torch.sum(a * b, dim=-1)
    return torch.mean(torch.square(similarity - label.to(similarity.dtype)))


def cycle_consistency_loss(restored, clean, redegrade_fn, model_fn,
                           mask=None):
    """clean -> degrade -> restore -> re-degrade -> restore again.
    redegrade_fn: a fresh degradation (no gradient flows through it);
    model_fn: the forward pass on the step's parameters."""
    re_degraded = redegrade_fn(restored).detach()
    re_restored = model_fn(re_degraded)
    cycle = torch.square(re_restored - restored)
    clean_term = torch.square(restored - clean)
    if mask is None:
        return cycle.mean() * 0.5 + clean_term.mean() * 0.5
    return (_masked_mean(cycle, mask) * 0.5
            + _masked_mean(clean_term, mask) * 0.5)


def semi_supervised_loss(output, inputs, target, is_synthetic, *,
                         model_fn=None, redegrade_fn=None,
                         supervised_weight: float = 1.0,
                         consistency_weight: float = 0.3,
                         cycle_weight: float = 0.2):
    """The combined loss; is_synthetic [B] (float or bool). Returns
    (total, {component: value})."""
    syn = is_synthetic.to(output.dtype)
    real = 1.0 - syn
    losses = {}
    total = 0.0

    sup = supervised_loss(output, target, syn)
    losses["supervised"] = sup
    total += sup * supervised_weight

    if consistency_weight > 0:
        cons = consistency_loss(output, inputs, real)
        losses["consistency"] = cons
        total += cons * consistency_weight

    if cycle_weight > 0 and model_fn is not None and redegrade_fn is not None:
        cyc = cycle_consistency_loss(output, target, redegrade_fn, model_fn,
                                     syn)
        losses["cycle"] = cyc
        total += cyc * cycle_weight

    losses["total"] = total
    return total, losses
