"""Seeded weights, made on the device in one draw a model.

The distributions are torch's defaults (conv and transpose-conv weights
and biases U(+-1/sqrt(fan_in)), LSTM weights U(+-1/sqrt(H))), with random
batch-norm affines and statistics, as the program's smoke test seeds its
serving models (`chip_smoke.py::_models`), so that a folded BN is not an
identity. One `torch.rand` call on the device's generator gives every leaf
of a model; the leaves are slices of it.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _leaves(model: nn.Module):
    """(tensor, fn(u) -> value) for every float leaf, in module order."""
    out = []
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            bound = 1.0 / math.sqrt(m.weight.shape[1] * m.weight.shape[2])
            for p in (m.weight, m.bias):
                out.append((p, lambda u, b=bound: (u * 2.0 - 1.0) * b))
        elif isinstance(m, nn.BatchNorm1d):
            out += [(m.weight, lambda u: u + 0.5),
                    (m.bias, lambda u: (u - 0.5) * 0.2),
                    (m.running_mean, lambda u: (u - 0.5) * 0.2),
                    (m.running_var, lambda u: u + 0.5)]
        elif hasattr(m, "hidden_size") and list(m.parameters(recurse=False)):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters(recurse=False):
                out.append((p, lambda u, b=bound: (u * 2.0 - 1.0) * b))
    return out


def seed_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every leaf of `model` (already on the generator's device) from
    one draw of `generator`; returns the model."""
    leaves = _leaves(model)
    total = sum(t.numel() for t, _ in leaves)
    u = torch.rand(total, generator=generator, device=generator.device)
    with torch.no_grad():
        i = 0
        for t, fn in leaves:
            t.copy_(fn(u[i:i + t.numel()]).view_as(t))
            i += t.numel()
    return model


def snapshot(model: nn.Module) -> dict:
    """A detached copy of the state dict: what the reference is given."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
