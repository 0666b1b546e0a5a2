"""AudioSuperResolution: x2 (or x4) bandwidth extension.

Counterpart of ml_audio_restoration_tpu/models/super_resolution.py
(`apply` in eval and train mode): a k7 stem, residual blocks (conv3-BN-LeakyReLU-conv3-BN +
identity), a middle conv+BN (no activation) with a long skip from the stem,
log2(upscale) transpose-conv (k4, s2, p1) stages, a k5 HF-emphasis conv, a
k7 reconstruction, and a global residual of the linearly interpolated
input. The default configuration (base 32, 4 blocks) has 38,273 parameters.
`model.train()` gives the train forward (BN by batch statistics, running
buffers updated in place); the JAX package's `apply_train_packed` is TPU
layout work that equals the plain path up to float reassociation.
"""
from __future__ import annotations

import math

from torch import nn

from ..ops import conv1d, conv_transpose1d, leaky_relu, upsample_linear
from .common import LRELU_SLOPE, conv_bn


class ResidualBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv1d(c, c, 3, padding=1)
        self.bn1 = nn.BatchNorm1d(c)
        self.conv2 = nn.Conv1d(c, c, 3, padding=1)
        self.bn2 = nn.BatchNorm1d(c)

    def forward(self, x):
        h = conv_bn(self.conv1, self.bn1, x, train=self.training)
        return conv_bn(self.conv2, self.bn2, h, lrelu=False,
                       train=self.training) + x


class AudioSuperResolution(nn.Module):
    def __init__(self, upscale_factor: int = 2, channels: int = 1,
                 base_channels: int = 32, num_residual_blocks: int = 4):
        super().__init__()
        c = base_channels
        self.upscale_factor = upscale_factor
        self.initial = nn.Sequential(nn.Conv1d(channels, c, 7, padding=3),
                                     nn.LeakyReLU(LRELU_SLOPE))
        self.residual_blocks = nn.ModuleList(
            ResidualBlock(c) for _ in range(num_residual_blocks))
        self.middle = nn.Sequential(nn.Conv1d(c, c, 3, padding=1),
                                    nn.BatchNorm1d(c))
        self.upsample_blocks = nn.ModuleList(
            nn.Sequential(nn.ConvTranspose1d(c, c, 4, stride=2, padding=1),
                          nn.LeakyReLU(LRELU_SLOPE))
            for _ in range(int(math.log2(upscale_factor))))
        self.hf_emphasis = nn.Sequential(nn.Conv1d(c, c, 5, padding=2),
                                         nn.LeakyReLU(LRELU_SLOPE))
        self.reconstruction = nn.Conv1d(c, channels, 7, padding=3)

    def forward(self, x):
        """x [B, ch, T] -> [B, ch, T * upscale], in the module's mode."""
        stem = self.initial[0]
        h0 = leaky_relu(conv1d(x, stem.weight, stem.bias, padding=3))
        h = h0
        for block in self.residual_blocks:
            h = block(h)
        h = h0 + conv_bn(self.middle[0], self.middle[1], h, lrelu=False,
                         train=self.training)
        for up in self.upsample_blocks:
            h = leaky_relu(conv_transpose1d(h, up[0].weight, up[0].bias,
                                            stride=2, padding=1))
        hf = self.hf_emphasis[0]
        h = leaky_relu(conv1d(h, hf.weight, hf.bias, padding=2))
        out = conv1d(h, self.reconstruction.weight, self.reconstruction.bias,
                     padding=3)
        return out + upsample_linear(x, 2 ** len(self.upsample_blocks))
