"""Shared building blocks of the port's models.

Counterpart of ml_audio_restoration_tpu/models/common.py. The models are
`nn.Module`s whose submodule names are the upstream state-dict keys, so an
upstream `.pth` loads through `load_state_dict(strict=True)`. In eval mode batch norm
is folded into the preceding conv; in train mode batch norm normalizes by
the batch statistics. bf16 serving
runs a copy of each model cast by `cast_model`; bf16 training runs on the
parameters `cast_params` casts, with the BN statistics left in f32.
"""
from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..ops import batch_norm_train, conv1d, conv1d_epilogue, leaky_relu

LRELU_SLOPE = 0.2


def fold_conv_bn(conv: nn.Conv1d, bn: nn.BatchNorm1d, *, host: bool = False):
    """Fold eval batch norm into the conv: conv(x, w, b) then BN ==
    conv(x, w*g, (b-mean)*g + beta) with g = scale*rsqrt(var+eps).
    Computed in f32, cast to the conv weight's dtype. `host=True` computes
    it on the CPU and returns it on the weights' device, so the result does
    not depend on the device's rsqrt (the int8 path quantizes it)."""
    w_dtype = conv.weight.dtype
    f32 = torch.float32
    dev = "cpu" if host else conv.weight.device
    t = lambda a: a.to(dev, f32)  # noqa: E731
    g = t(bn.weight) * torch.rsqrt(t(bn.running_var) + bn.eps)
    w = (t(conv.weight) * g[:, None, None]).to(w_dtype)
    b = ((t(conv.bias) - t(bn.running_mean)) * g + t(bn.bias)).to(w_dtype)
    return w.to(conv.weight.device), b.to(conv.weight.device)


def cast_model(model, dtype: torch.dtype):
    """`model` for an eval forward in `dtype`: the model itself in f32
    (None passes through), else a copy with every float parameter and buffer
    cast, the BN statistics included, as the JAX package casts every float
    leaf for bf16 serving. `fold_conv_bn` then folds in f32 from the rounded
    weights and statistics and casts the result to `dtype`, which is the
    JAX fold's arithmetic too."""
    if model is None or dtype == torch.float32:
        return model
    return copy.deepcopy(model).to(dtype)


def cast_params(model: nn.Module, dtype: torch.dtype, params=None) -> dict:
    """The parameters of a bf16 training or validation forward, for
    `torch.func.functional_call`: `params` ({name: tensor}, default the
    model's own) cast to `dtype`, each by a differentiable cast, so the
    gradients reach the f32 originals. Buffers are left out, so the BN
    running statistics stay f32 (JAX's trainer casts params only, never
    `model_state`). A submodule marked `casts_own_weights` (the LSTM) keeps
    its parameters as given: it casts them to its input's dtype inside its
    own autograd Function, which hands the bias gradients back as JAX's
    f32 sums instead of the bf16 that a cast copy would round them to."""
    src = dict(model.named_parameters()) if params is None else params
    own = tuple(f"{name}." for name, m in model.named_modules()
                if getattr(m, "casts_own_weights", False))
    return {n: p if n.startswith(own) else p.to(dtype)
            for n, p in src.items()}


def conv_bn(conv: nn.Conv1d, bn: nn.BatchNorm1d, x, *, lrelu: bool = True,
            train: bool = False, update_stats: bool = True, residual=None):
    """conv -> BN (-> + residual) -> optional LeakyReLU(0.2).

    Eval (train=False): BN folded into the conv, whose bias, residual and
    activation are ops.conv1d_epilogue's. Train: BN by the batch
    statistics (ops.batch_norm_train), and `bn`'s running buffers are
    updated IN PLACE (num_batches_tracked too, as nn.BatchNorm1d does),
    where the JAX package returns them as a new state; update_stats=False
    leaves them as they are (the JAX caller discarding the new state)."""
    if not train:
        w, b = fold_conv_bn(conv, bn)
        return conv1d_epilogue(x, w, b, residual=residual, lrelu=lrelu,
                               padding=conv.padding[0],
                               dilation=conv.dilation[0])
    y = conv1d(x, conv.weight, conv.bias, padding=conv.padding[0],
               dilation=conv.dilation[0])
    y, mean, var = batch_norm_train(y, bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var, eps=bn.eps,
                                    momentum=bn.momentum)
    if update_stats:
        with torch.no_grad():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
            bn.num_batches_tracked += 1
    if residual is not None:
        y = y + residual
    return leaky_relu(y) if lrelu else y


def epilogue_convs(model: nn.Module) -> list:
    """(output channels, LeakyReLU) of each conv whose eval forward ends in
    ops.conv_epilogue, in module order, read off the module tree: the layer
    after a conv in its parent, past an optional BatchNorm, says whether
    the epilogue applies the LeakyReLU; a conv followed by a Sigmoid (the
    denoiser's transient head) keeps ATen's ops. On the card an eval
    forward launches the kernel once for each entry."""
    out = []
    for parent in model.modules():
        layers = list(parent.children())
        for i, m in enumerate(layers):
            if not isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                continue
            after = [n for n in layers[i + 1:i + 3]
                     if not isinstance(n, nn.BatchNorm1d)][:1]
            if after and isinstance(after[0], nn.Sigmoid):
                continue
            out.append((m.out_channels,
                        bool(after) and isinstance(after[0], nn.LeakyReLU)))
    return out


def conv_bn_lrelu_layers(in_ch: int, out_ch: int, k: int, *, padding: int,
                         dilation: int = 1):
    """The layers of Sequential(conv, BN, LeakyReLU), so the conv and BN
    land at the upstream keys `.0` and `.1`."""
    return [nn.Conv1d(in_ch, out_ch, k, padding=padding, dilation=dilation),
            nn.BatchNorm1d(out_ch), nn.LeakyReLU(LRELU_SLOPE)]


def double_conv_block(in_ch: int, out_ch: int) -> nn.Sequential:
    """The U-Net block (conv3-BN-LeakyReLU) x2: keys .0/.1 and .3/.4."""
    return nn.Sequential(
        *conv_bn_lrelu_layers(in_ch, out_ch, 3, padding=1),
        *conv_bn_lrelu_layers(out_ch, out_ch, 3, padding=1))


def double_conv_block_apply(block: nn.Sequential, x, train: bool = False,
                            update_stats: bool = True):
    x = conv_bn(block[0], block[1], x, train=train, update_stats=update_stats)
    return conv_bn(block[3], block[4], x, train=train,
                   update_stats=update_stats)


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight from `generator` with torch's default
    distributions: conv and transpose-conv weights and biases
    U(+-1/sqrt(fan_in)) (fan_in from weight dim 1 times k, as torch
    computes it), LSTM weights U(+-1/sqrt(H)). BN keeps scale 1, shift 0,
    mean 0, var 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                bound = 1.0 / math.sqrt(m.weight.shape[1] * m.weight.shape[2])
                for p in (m.weight, m.bias):
                    _uniform(p, bound, generator)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
            elif hasattr(m, "hidden_size"):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters(recurse=False):
                    _uniform(p, bound, generator)
    return model


def _uniform(p, bound: float, generator: torch.Generator):
    u = torch.rand(p.shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    p.copy_((u * 2.0 - 1.0) * bound)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
