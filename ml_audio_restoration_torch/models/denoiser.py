"""AudioDenoiser: 1-D U-Net with learned and analytic impulse suppression.

Counterpart of ml_audio_restoration_tpu/models/denoiser.py (`apply` in
eval and train mode, and `encode`): a 3-level encoder (32/64/128), a
256-wide bottleneck, a transpose-conv decoder with skip concatenation, a
3-conv sigmoid transient mask, the analytic impulse score of the raw input,
the element-wise max of the two masks, and up to 90% suppression at
detected impulses. The default configuration has 676,242 parameters.
Tensors are NCW.

`model.eval()` gives the eval forward (BN folded); `model.train()` the
train forward (BN by batch statistics, running buffers updated in place).
Only the plain path is ported: the JAX package's `apply_train_packed` is
TPU layout work that equals it up to float reassociation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv1d, conv_transpose1d, max_pool1d, moving_average
from ..ops import leaky_relu
from .common import LRELU_SLOPE, double_conv_block, double_conv_block_apply

DEFAULT_FEATURES = (32, 64, 128)


def detect_impulses(x):
    """|d1|, |d2| and amplitude blended 1:2:0.5 / 3.5, box-smoothed (k=5)
    and clipped to [0, 1]. x: [B, 1, T] -> [B, 1, T]."""
    diff = F.pad(torch.abs(x[..., 1:] - x[..., :-1]), (0, 1))
    diff2 = F.pad(torch.abs(diff[..., 1:] - diff[..., :-1]), (0, 1))
    amplitude = torch.abs(x)
    score = (diff2 * 2.0 + diff + amplitude * 0.5) / 3.5
    score = moving_average(score, 5)
    return torch.clamp(score, 0.0, 1.0)


class AudioDenoiser(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 features=DEFAULT_FEATURES):
        super().__init__()
        self.features = tuple(features)
        ch = in_channels
        self.encoder = nn.ModuleList()
        for f in features:
            self.encoder.append(double_conv_block(ch, f))
            ch = f
        self.bottleneck = double_conv_block(features[-1], features[-1] * 2)
        # decoder.{2i} is the transpose conv, decoder.{2i+1} the conv block
        self.decoder = nn.ModuleList()
        for f in reversed(features):
            self.decoder.append(nn.ConvTranspose1d(f * 2, f, 2, stride=2))
            self.decoder.append(double_conv_block(f * 2, f))
        f0 = features[0]
        self.transient_detector = nn.Sequential(
            nn.Conv1d(f0, f0 // 2, 3, padding=1), nn.LeakyReLU(LRELU_SLOPE),
            nn.Conv1d(f0 // 2, f0 // 4, 3, padding=1),
            nn.LeakyReLU(LRELU_SLOPE),
            nn.Conv1d(f0 // 4, 1, 3, padding=1), nn.Sigmoid())
        self.final_conv = nn.Conv1d(f0, out_channels, 1)

    def encode(self, x):
        """Encoder + bottleneck: x [B, in_ch, T] -> [B, 2 * features[-1],
        T / 2**len(features)], the contrastive loss's features. In train
        mode BN uses the batch statistics but never updates its running
        buffers (the JAX package discards that state)."""
        h = x
        for block in self.encoder:
            h = max_pool1d(double_conv_block_apply(block, h, self.training,
                                                   update_stats=False))
        return double_conv_block_apply(self.bottleneck, h, self.training,
                                       update_stats=False)

    def forward(self, x):
        """x [B, in_ch, T] -> [B, out_ch, T], in the module's mode."""
        train = self.training
        skips = []
        h = x
        for block in self.encoder:
            h = double_conv_block_apply(block, h, train)
            skips.append(h)
            h = max_pool1d(h)
        h = double_conv_block_apply(self.bottleneck, h, train)

        for i in range(len(self.features)):
            up, block = self.decoder[2 * i], self.decoder[2 * i + 1]
            h = conv_transpose1d(h, up.weight, up.bias, stride=2, padding=0)
            skip = skips[-(i + 1)]
            if h.shape[-1] != skip.shape[-1]:
                # odd-length level: right-pad to the skip length
                h = F.pad(h, (0, skip.shape[-1] - h.shape[-1]))
            h = double_conv_block_apply(block, torch.cat([skip, h], dim=1),
                                        train)

        td = h
        convs = [self.transient_detector[j] for j in (0, 2, 4)]
        for j, conv in enumerate(convs):
            td = conv1d(td, conv.weight, conv.bias, padding=1)
            td = torch.sigmoid(td) if j == 2 else leaky_relu(td)

        mask = torch.maximum(td, detect_impulses(x))
        denoised = conv1d(h, self.final_conv.weight, self.final_conv.bias)
        return denoised * (1.0 - mask * 0.9)
