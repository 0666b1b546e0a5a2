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
`apply_packed` is the int8 serving forward (and its calibration pass) in
the packed layout, the JAX package's `apply_packed` under a QuantCtx; the
float forwards compute the plain path only (the JAX package's packed float
forwards equal it up to float reassociation).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (conv1d, conv1d_epilogue, conv_transpose1d_epilogue,
                   max_pool1d, moving_average)
from .common import (LRELU_SLOPE, double_conv_block, double_conv_block_apply,
                     fold_conv_bn)

DEFAULT_FEATURES = (32, 64, 128)
IMPULSE_BOX = 5  # detect_impulses' box filter


def detect_impulses(x):
    """|d1|, |d2| and amplitude blended 1:2:0.5 / 3.5, box-smoothed (k =
    IMPULSE_BOX) and clipped to [0, 1]. x: [B, 1, T] -> [B, 1, T]."""
    diff = F.pad(torch.abs(x[..., 1:] - x[..., :-1]), (0, 1))
    diff2 = F.pad(torch.abs(diff[..., 1:] - diff[..., :-1]), (0, 1))
    amplitude = torch.abs(x)
    score = (diff2 * 2.0 + diff + amplitude * 0.5) / 3.5
    score = moving_average(score, IMPULSE_BOX)
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
            h = conv_transpose1d_epilogue(h, up.weight, up.bias, stride=2,
                                          padding=0)
            skip = skips[-(i + 1)]
            if h.shape[-1] != skip.shape[-1]:
                # odd-length level: right-pad to the skip length
                h = F.pad(h, (0, skip.shape[-1] - h.shape[-1]))
            h = double_conv_block_apply(block, torch.cat([skip, h], dim=1),
                                        train)

        td = h
        for j in (0, 2):
            conv = self.transient_detector[j]
            td = conv1d_epilogue(td, conv.weight, conv.bias, lrelu=True,
                                 padding=1)
        head = self.transient_detector[4]
        td = torch.sigmoid(conv1d(td, head.weight, head.bias, padding=1))

        mask = torch.maximum(td, detect_impulses(x))
        denoised = conv1d_epilogue(h, self.final_conv.weight,
                                   self.final_conv.bias)
        return denoised * (1.0 - mask * 0.9)


# ------------------------------------------------------- int8 serving path
# Quantization points that stay float under int8 (the JAX package's
# sensitivity-measured skip set: the last two decoder blocks' quantization
# noise reaches the output unattenuated).
INT8_FLOAT_LAYERS = frozenset(
    {"dec1.c1", "dec1.c2", "dec2.c1", "dec2.c2"})


def _detect_impulses_dense(xf):
    """detect_impulses on [B, T] (shifted-slice differences and an unrolled
    k=5 box filter), as the JAX package's packed forward computes it."""
    d1 = F.pad(torch.abs(xf[:, 1:] - xf[:, :-1]), (0, 1))
    d2 = F.pad(torch.abs(d1[:, 1:] - d1[:, :-1]), (0, 1))
    score = (d2 * 2.0 + d1 + torch.abs(xf) * 0.5) / 3.5
    sp = F.pad(score, (2, 2))
    ma = (sp[:, 0:-4] + sp[:, 1:-3] + sp[:, 2:-2] + sp[:, 3:-1]
          + sp[:, 4:]) / 5.0
    return torch.clamp(ma, 0.0, 1.0)


def max_pool_int8(x):
    """MaxPool1d(2) on an s8 [B, T, C] tensor (floor mode)."""
    b, t, c = x.shape
    return x[:, :t // 2 * 2].reshape(b, t // 2, 2, c).amax(dim=2)


def _wio(conv):
    """A Conv1d's weight as WIO [k, Cin, Cout] (a view)."""
    return conv.weight.permute(2, 1, 0)


def _wio_t(up):
    """A ConvTranspose1d's weight as [k, Cin, Cout] in torch's tap order."""
    return up.weight.permute(2, 0, 1)


def folded_wio(q, key, conv, bn):
    """The eval fold of (conv, bn) as a WIO kernel and its bias, built once
    per int8 context and device (ops/quant.py::QuantCtx.folded), on the
    CPU: the quantized kernels are then the same whichever device serves
    them."""
    def make():
        w, b = fold_conv_bn(conv, bn, host=True)
        return w.permute(2, 1, 0), b
    return q.folded((conv.weight.device, key), make)


def apply_packed(model: AudioDenoiser, x, q=None):
    """The eval forward with the C<=64 full-rate stages r-packed, under an
    int8 context `q` (ops/quant.py): its calibration pass or int8 serving;
    the JAX package's `apply_packed`. x: plain NWC [B, t, 1] with t % 4 ==
    0 -> [B, t, 1].

    enc0 (r4) -> pool -> enc1 (r2) -> pool (exits to the plain layout) ->
    the C>=128 middle (float in "packed" scope; r=1 packed convs under
    "full") -> up1 (r1->r2) -> dec1 (r2) -> up2 (r2->r4) -> dec2, the
    detector and the final conv (r4, exits to plain). The concat-consuming
    convs run as sums of two convs (qconv2). The sigmoid exit, the analytic
    impulse score and the mask multiply stay float."""
    from ..ops.packed import (packed_conv, packed_conv_r,
                              packed_conv_transpose, packed_max_pool2)
    from ..ops.quant import (QT, ctx_or_null, lrelu, make_qops,
                             pooled_scale, tie_pool_pairs)

    q = ctx_or_null(q)
    b_sz, t, cin = x.shape
    assert t % 4 == 0 and cin == 1, (t, cin)
    enc, dec = model.encoder, model.decoder
    qconv, qconv2 = make_qops(q)

    def block(name, blk, h, r, split=None, pool_tie_c=None):
        w1, b1 = folded_wio(q, f"{name}.c1", blk[0], blk[1])
        if split is None:
            h = qconv(f"{name}.c1", h, w1, b1, op=packed_conv, act=lrelu,
                      r=r, padding=1)
        else:
            skip, up, c_skip = split
            h = qconv2(f"{name}.c1", skip, w1[:, :c_skip], up,
                       w1[:, c_skip:], b1, act=lrelu, r=r, padding=1)
        w2, b2 = folded_wio(q, f"{name}.c2", blk[3], blk[4])
        return qconv(f"{name}.c2", h, w2, b2, op=packed_conv, act=lrelu,
                     r=r, padding=1,
                     scale_tx=(tie_pool_pairs(pool_tie_c)
                               if pool_tie_c else None))

    def qpool_packed(h, c):
        if isinstance(h, QT):
            return QT(packed_max_pool2(h.q, c), pooled_scale(h.scale, c))
        return packed_max_pool2(h, c)

    def arr(h):
        return h.q if isinstance(h, QT) else h

    xq = q.quantize_in("in", x)
    w1, b1 = folded_wio(q, "enc0.c1", enc[0][0], enc[0][1])
    h = qconv("enc0.c1", xq, w1, b1, op=packed_conv_r, act=lrelu,
              r_in=1, r_out=4, padding=1, t_in=t)
    w2, b2 = folded_wio(q, "enc0.c2", enc[0][3], enc[0][4])
    c_e0 = enc[0][3].out_channels
    skip0 = qconv("enc0.c2", h, w2, b2, op=packed_conv, act=lrelu,
                  r=4, padding=1, scale_tx=tie_pool_pairs(c_e0))
    h = qpool_packed(skip0, c_e0)
    c_e1 = enc[1][3].out_channels
    skip1 = block("enc1", enc[1], h, 2, pool_tie_c=c_e1)   # [B, t/4, 128]
    h = qpool_packed(skip1, c_e1)

    up0 = dec[0]
    if not (q.active and q.full):
        # the float middle, as the plain eval forward computes it (NCW)
        h = q.deq(h).to(up0.weight.dtype).permute(0, 2, 1)
        skip2 = double_conv_block_apply(enc[2], h)
        h = max_pool1d(skip2)
        h = double_conv_block_apply(model.bottleneck, h)
        h = conv_transpose1d_epilogue(h, up0.weight, up0.bias, stride=2,
                                      padding=0)
        if h.shape[-1] != skip2.shape[-1]:
            h = F.pad(h, (0, skip2.shape[-1] - h.shape[-1]))
        h = double_conv_block_apply(dec[1], torch.cat([skip2, h], dim=1))
        h = h.permute(0, 2, 1)
    else:
        # the quantized middle: r=1 packed convs; dec0.c1 as a sum
        skip2 = block("enc2", enc[2], h, 1)
        if isinstance(skip2, QT):
            h = QT(max_pool_int8(skip2.q), skip2.scale)
        else:
            h = max_pool1d(skip2.permute(0, 2, 1)).permute(0, 2, 1)
        h = block("bot", model.bottleneck, h, 1)
        t8 = arr(h).shape[1]
        h = qconv("up0", h, _wio_t(up0), up0.bias,
                  op=packed_conv_transpose, r_in=1, r_out=1, stride=2,
                  padding=0, t_in=t8)
        pad = arr(skip2).shape[1] - arr(h).shape[1]
        if pad:
            h = (QT(F.pad(h.q, (0, 0, 0, pad)), h.scale)
                 if isinstance(h, QT) else F.pad(h, (0, 0, 0, pad)))
        h = block("dec0", dec[1], None, 1,
                  split=(skip2, h, arr(skip2).shape[-1]))

    c1 = arr(skip1).shape[-1] // 2  # 64
    up1 = dec[2]
    h = qconv("up1", h, _wio_t(up1), up1.bias, op=packed_conv_transpose,
              r_in=1, r_out=2, stride=2, padding=0, t_in=t // 4)
    h = block("dec1", dec[3], None, 2, split=(skip1, h, c1))

    c0 = arr(skip0).shape[-1] // 4  # 32
    up2 = dec[4]
    h = qconv("up2", h, _wio_t(up2), up2.bias, op=packed_conv_transpose,
              r_in=2, r_out=4, stride=2, padding=0, t_in=t // 2)
    h = block("dec2", dec[5], None, 4, split=(skip0, h, c0))

    l0, l1, l2 = (model.transient_detector[j] for j in (0, 2, 4))
    td = qconv("td0", h, _wio(l0), l0.bias, op=packed_conv, act=lrelu,
               r=4, padding=1)
    td = qconv("td1", td, _wio(l1), l1.bias, op=packed_conv, act=lrelu,
               r=4, padding=1)
    td = qconv("td2", td, _wio(l2), l2.bias, op=packed_conv_r,
               act=torch.sigmoid, requant=False, r_in=4, r_out=1,
               padding=1, t_in=t)                            # [B, t, 1]

    imp = _detect_impulses_dense(x[..., 0])
    combined = torch.maximum(td, imp[..., None])

    fc = model.final_conv
    denoised = qconv("final", h, _wio(fc), fc.bias, op=packed_conv_r,
                     requant=False, r_in=4, r_out=1, padding=0, t_in=t)
    return denoised * (1.0 - combined * 0.9)


def packed_amax(model: AudioDenoiser, x) -> dict:
    """Calibration forward: {point: per-channel amax} of apply_packed."""
    from ..ops.quant import QuantCtx

    ctx = QuantCtx()
    apply_packed(model, x, q=ctx)
    return ctx.amax
