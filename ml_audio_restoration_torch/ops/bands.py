"""Per-band layers of a band-split model (models/bs_roformer.py), grouped.

A band-split model gives every frequency band its own small layer: a
norm and a linear map into the model's width, and back out through a
per-band MLP. Run band by band that is dozens of launches of a few
microseconds of work each. Here the bands of one width that follow one
another (a `run`) share one batched product: the ep_317 layout's 62
bands are 7 runs, and the mask estimator's 62 first layers, all of one
shape, are one product.

Band-major tensors are [k, M, width]: band j's rows at [j], M rows (the
batch's frames) each. Weights are stacked per run as nn.Linear keeps
them, [k, out, in].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-12  # F.normalize's floor on the norm


def runs(widths) -> list[tuple[int, int, int]]:
    """(first band, number of bands, width) of each run of consecutive
    bands of one width, in band order."""
    out = []
    for j, w in enumerate(widths):
        if out and out[-1][2] == w:
            out[-1] = (out[-1][0], out[-1][1] + 1, w)
        else:
            out.append((j, 1, w))
    return out


def rms_norm(x, gamma):
    """The band-split transformer's RMSNorm, F.normalize(x, dim=-1) *
    sqrt(d) * gamma, which is x * rsqrt(mean(x^2)) * gamma, with the floor
    on the norm moved under the root. `gamma` broadcasts against x: [d],
    or [k, d] for k bands at [..., k, d]."""
    d = x.shape[-1]
    if gamma.dim() == 1:
        return F.rms_norm(x, (d,), gamma, eps=EPS ** 2 / d)
    return F.rms_norm(x, (d,), eps=EPS ** 2 / d) * gamma


def band_linear(x, weight, bias):
    """x [k, M, in] band-major -> [k, M, out]: band j's rows through
    weight[j] [out, in] and bias[j], one batched product for the k bands.
    x may be a strided view whose last axis is contiguous."""
    return torch.baddbmm(bias[:, None, :], x, weight.transpose(1, 2))


def stack(layers, name: str):
    """The parameter `name` of each layer, stacked: [k, ...]."""
    return torch.stack([getattr(layer, name) for layer in layers])
