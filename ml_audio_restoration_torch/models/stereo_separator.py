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
The float forwards compute the plain path only: the JAX package's packed
float forwards are TPU layout work that equals it up to float
reassociation. `apply_packed` is the int8 serving forward (and its
calibration pass) in the packed layout. Under grad the LSTM runs the
training recurrence (K2 forward, K3 backward), in either mode.
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
    bias_hh_l{k}); the computation is ops.lstm.stacked_lstm, which casts
    the weights to its input's dtype itself (`cast_params` leaves them)."""

    casts_own_weights = True

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

    def recur(self, h):
        """The LSTM over the encoder output: [B, 4C, T] -> [B, H, T]."""
        return self.lstm(h.transpose(1, 2)).transpose(1, 2)

    def forward(self, x):
        """x [B, 1, T] -> [B, 2, T], channels (L, R): encode, the LSTM,
        decode."""
        return self.decode(self.recur(self.encode(x)))


# ------------------------------------------------------- int8 serving path
def encode_packed(model: StereoSeparator, x, q=None):
    """The eval encoder with the C<=64 stages packed, under an int8 context
    (ops/quant.py): the stem enters r=4 from the plain input, dilated block
    0 runs at r=4, and block 1's dilated conv exits to plain. Blocks 1-3
    (C>=128) run float in "packed" scope and as quantized r=1 packed convs
    under "full". x: NWC [B, T, 1], T % 4 == 0 -> float [B, T, 4C]."""
    from ..ops.packed import packed_conv, packed_conv_r
    from ..ops.quant import ctx_or_null, lrelu, make_qops
    from .denoiser import folded_wio

    q = ctx_or_null(q)
    qconv, _ = make_qops(q)
    b, t, _ = x.shape
    assert t % 4 == 0, t
    enc = model.encoder
    xq = q.quantize_in("in", x)
    w, bb = folded_wio(q, "stem", enc[0][0], enc[0][1])
    h = qconv("stem", xq, w, bb, op=packed_conv_r, act=lrelu,
              r_in=1, r_out=4, padding=3, t_in=t)
    w, bb = folded_wio(q, "b0.d", enc[1][0], enc[1][1])
    h = qconv("b0.d", h, w, bb, op=packed_conv, act=lrelu, r=4, padding=1)
    w, bb = folded_wio(q, "b0.p", enc[1][3], enc[1][4])
    h = qconv("b0.p", h, w, bb, op=packed_conv, act=lrelu, r=4, padding=0)
    w, bb = folded_wio(q, "b1.d", enc[2][0], enc[2][1])
    full_tail = q.active and q.full
    h = qconv("b1.d", h, w, bb, op=packed_conv_r, act=lrelu,
              requant=full_tail, r_in=4, r_out=1, padding=2, dilation=2,
              t_in=t)                               # -> plain [B, T, 4C]
    if not full_tail:
        # the float tail in the compute dtype, as the plain forward (NCW)
        h = h.to(w.dtype).permute(0, 2, 1)
        h = conv_bn(enc[2][3], enc[2][4], h)
        for blk in enc[3:]:
            h = conv_bn(blk[0], blk[1], h)
            h = conv_bn(blk[3], blk[4], h)
        return h.permute(0, 2, 1)
    w, bb = folded_wio(q, "b1.p", enc[2][3], enc[2][4])
    h = qconv("b1.p", h, w, bb, op=packed_conv, act=lrelu, r=1, padding=0)
    for i, (blk, dil) in enumerate(zip(enc[3:], DILATIONS[2:]), start=2):
        w, bb = folded_wio(q, f"b{i}.d", blk[0], blk[1])
        h = qconv(f"b{i}.d", h, w, bb, op=packed_conv, act=lrelu,
                  r=1, padding=dil, dilation=dil)
        w, bb = folded_wio(q, f"b{i}.p", blk[3], blk[4])
        last = i == len(enc) - 2
        h = qconv(f"b{i}.p", h, w, bb, op=packed_conv, act=lrelu,
                  r=1, padding=0, requant=not last)
    return h  # float: the LSTM stays f32 / bf16


def _decoder_apply_packed(dec: nn.Sequential, h, t: int, q=None,
                          name: str = "dec"):
    """One eval decoder r=2-packed: l1 raises the plain LSTM output into
    packed space, l2/l3 run r=2, the final conv exits to plain [B, T, 1]."""
    from ..ops.packed import packed_conv, packed_conv_r
    from ..ops.quant import ctx_or_null, lrelu, make_qops
    from .denoiser import _wio, folded_wio

    q = ctx_or_null(q)
    qconv, _ = make_qops(q)
    w1, b1 = folded_wio(q, f"{name}.l1", dec[0], dec[1])
    hp = qconv(f"{name}.l1", h, w1, b1, op=packed_conv_r, act=lrelu,
               r_in=1, r_out=2, padding=3, t_in=t)
    w2, b2 = folded_wio(q, f"{name}.l2", dec[3], dec[4])
    hp = qconv(f"{name}.l2", hp, w2, b2, op=packed_conv, act=lrelu,
               r=2, padding=3)
    w3, b3 = folded_wio(q, f"{name}.l3", dec[6], dec[7])
    hp = qconv(f"{name}.l3", hp, w3, b3, op=packed_conv, act=lrelu,
               r=2, padding=3)
    fin = dec[9]
    return qconv(f"{name}.final", hp, _wio(fin), fin.bias, op=packed_conv_r,
                 requant=False, r_in=2, r_out=1, padding=3, t_in=t)


def lstm_packed(model: StereoSeparator, h):
    """The LSTM of the packed forward: NWC [B, T, 4C] float in the
    parameters' dtype (K1 on the card) -> [B, T, H]."""
    return model.lstm(h.to(model.lstm.weight_hh_l0.dtype))


def decode_packed(model: StereoSeparator, h, q=None):
    """The packed decoders on the LSTM output [B, T, H], quantized at the
    `lstm_out` point -> [B, T, 2]."""
    from ..ops.quant import ctx_or_null

    q = ctx_or_null(q)
    t = h.shape[1]
    hq = q.quantize_in("lstm_out", h.float() if q.quantized else h)
    left = _decoder_apply_packed(model.left_decoder, hq, t, q, "left")
    right = _decoder_apply_packed(model.right_decoder, hq, t, q, "right")
    return torch.cat([left, right], dim=-1)


def apply_packed(model: StereoSeparator, x, q=None):
    """The eval forward with the packed encoder and decoder stages under an
    int8 context (ops/quant.py): the JAX package's `apply_packed` on its
    ungrouped route, the one it takes for int8 and calibration. The LSTM
    runs float in the parameters' dtype (K1 on the card); its output is
    the `lstm_out` point. x: NWC [B, T, 1], T % 4 == 0 -> [B, T, 2]."""
    from ..ops.quant import ctx_or_null

    q = ctx_or_null(q)
    h = lstm_packed(model, encode_packed(model, x, q=q))
    return decode_packed(model, h, q)


def packed_amax(model: StereoSeparator, x) -> dict:
    """Calibration forward: {point: per-channel amax} of apply_packed."""
    from ..ops.quant import QuantCtx

    ctx = QuantCtx()
    apply_packed(model, x, q=ctx)
    return ctx.amax
