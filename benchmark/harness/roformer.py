"""The fourth stage of a configuration with a `bs_roformer` group:
BS-RoFormer at its widths (`ml_audio_restoration_torch.models.BSRoformer`),
on the device, in eval mode, with seeded weights made there in one draw
of a generator seeded by (seed, 11): every Linear weight and bias
U(+-1/sqrt(fan_in)) (torch's default), every RMSNorm gamma U(0.5, 1.5), so
that no norm is an identity. The rotary embeddings' `freqs` keep the
values the model is built with; the reference makes its own from
dim_head, so they are held to theta 10,000 too.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .signals import seed_seq


def _leaves(model: nn.Module):
    """(tensor, fn(u) -> value) for every seeded leaf, in module order."""
    out = []
    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            for p in (m.weight, m.bias):
                if p is not None:
                    out.append((p, lambda u, b=bound: (u * 2.0 - 1.0) * b))
        elif isinstance(getattr(m, "gamma", None), nn.Parameter):
            out.append((m.gamma, lambda u: u + 0.5))
    return out


def seed_enhancer(model: nn.Module, generator: torch.Generator):
    """Fill the model's Linear and RMSNorm leaves from one draw of
    `generator` (on the model's device); returns the model."""
    leaves = _leaves(model)
    u = torch.rand(sum(t.numel() for t, _ in leaves), generator=generator,
                   device=generator.device)
    with torch.no_grad():
        i = 0
        for t, fn in leaves:
            t.copy_(fn(u[i:i + t.numel()]).view_as(t))
            i += t.numel()
    return model


def build_enhancer(config: dict, device, seed: int) -> nn.Module:
    """The configuration's BS-RoFormer on `device`, seeded, in eval mode."""
    from ml_audio_restoration_torch.models import BSRoformer

    kw = dict(config["bs_roformer"])
    kw["freqs_per_bands"] = tuple(kw["freqs_per_bands"])
    gen = torch.Generator(device=device).manual_seed(seed_seq(seed, 11))
    model = BSRoformer(kw.pop("dim"), **kw).to(device)
    return seed_enhancer(model, gen).eval()
