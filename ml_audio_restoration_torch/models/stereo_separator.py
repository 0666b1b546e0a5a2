"""StereoSeparator: mono -> stereo upmix (dilated convs + LSTM + two decoders).

Counterpart of ml_audio_restoration_tpu/models/stereo_separator.py (`apply`
in eval and train mode, `encode`, `decode`): a conv-k7 stem, 4 dilated
blocks (k3 at dilations 1/2/4/8 then a pointwise k1, each
conv-BN-LeakyReLU), a unidirectional LSTM (hidden 64)
whose recurrence is a CUDA kernel on the card, and two 4-conv k7 decoders
for L and R. Output channel order is (L, R). The default configuration has
494,786 parameters.

`model.eval()` gives the eval forward (BN folded); `model.train()` the
train forward (BN by batch statistics, running buffers updated in place).
Only the plain path is ported: the JAX package's `apply_train_packed` is
TPU layout work that equals it up to float reassociation. Under grad the
LSTM runs the training recurrence (K2 forward, K3 backward), in either mode.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import conv1d
from ..ops.lstm import stacked_lstm
from .common import conv_bn, conv_bn_lrelu_layers

DILATIONS = (1, 2, 4, 8)


class LSTMWeights(nn.Module):
    """The weights of torch's nn.LSTM under its state-dict names
    (weight_ih_l{k} [4H, C], weight_hh_l{k} [4H, H], bias_ih_l{k},
    bias_hh_l{k}); the computation is ops.lstm.stacked_lstm."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        for k in range(num_layers):
            c = input_size if k == 0 else hidden_size
            g = 4 * hidden_size
            self.register_parameter(f"weight_ih_l{k}",
                                    nn.Parameter(torch.empty(g, c)))
            self.register_parameter(f"weight_hh_l{k}",
                                    nn.Parameter(torch.empty(g, hidden_size)))
            self.register_parameter(f"bias_ih_l{k}",
                                    nn.Parameter(torch.empty(g)))
            self.register_parameter(f"bias_hh_l{k}",
                                    nn.Parameter(torch.empty(g)))

    def layers(self):
        """Per-layer param dicts in the ops.lstm layout."""
        return [{"w_ih": getattr(self, f"weight_ih_l{k}").T,
                 "w_hh": getattr(self, f"weight_hh_l{k}").T,
                 "b_ih": getattr(self, f"bias_ih_l{k}"),
                 "b_hh": getattr(self, f"bias_hh_l{k}")}
                for k in range(self.num_layers)]

    def forward(self, x):
        """x [B, T, C] -> [B, T, H]."""
        return stacked_lstm(x, self.layers())


def _decoder(hidden: int, c: int) -> nn.Sequential:
    return nn.Sequential(
        *conv_bn_lrelu_layers(hidden, c * 4, 7, padding=3),
        *conv_bn_lrelu_layers(c * 4, c * 2, 7, padding=3),
        *conv_bn_lrelu_layers(c * 2, c, 7, padding=3),
        nn.Conv1d(c, 1, 7, padding=3))


def _decoder_apply(dec: nn.Sequential, h, train: bool):
    for i in (0, 3, 6):
        h = conv_bn(dec[i], dec[i + 1], h, train=train)
    return conv1d(h, dec[9].weight, dec[9].bias, padding=3)


class StereoSeparator(nn.Module):
    def __init__(self, base_channels: int = 32, lstm_hidden: int = 64,
                 num_lstm_layers: int = 1):
        super().__init__()
        c = base_channels
        specs = [(c, c * 2), (c * 2, c * 4), (c * 4, c * 4), (c * 4, c * 4)]
        self.encoder = nn.ModuleList(
            [nn.Sequential(*conv_bn_lrelu_layers(1, c, 7, padding=3))]
            + [nn.Sequential(
                *conv_bn_lrelu_layers(i, o, 3, padding=d, dilation=d),
                *conv_bn_lrelu_layers(o, o, 1, padding=0))
               for (i, o), d in zip(specs, DILATIONS)])
        self.lstm = LSTMWeights(c * 4, lstm_hidden, num_lstm_layers)
        self.left_decoder = _decoder(lstm_hidden, c)
        self.right_decoder = _decoder(lstm_hidden, c)

    def encode(self, x):
        """Stem + dilated blocks: x [B, 1, T] -> [B, 4C, T]. In train mode
        BN uses the batch statistics and updates its running buffers."""
        train = self.training
        stem = self.encoder[0]
        h = conv_bn(stem[0], stem[1], x, train=train)
        for block in self.encoder[1:]:
            h = conv_bn(block[0], block[1], h, train=train)
            h = conv_bn(block[3], block[4], h, train=train)
        return h

    def decode(self, h):
        """The two decoders: LSTM output [B, H, T] -> [B, 2, T], channels
        (L, R)."""
        train = self.training
        return torch.cat([_decoder_apply(self.left_decoder, h, train),
                          _decoder_apply(self.right_decoder, h, train)], dim=1)

    def forward(self, x):
        """x [B, 1, T] -> [B, 2, T], channels (L, R): encode, the LSTM,
        decode."""
        h = self.encode(x)
        h = self.lstm(h.transpose(1, 2)).transpose(1, 2)  # [B, H, T]
        return self.decode(h)
