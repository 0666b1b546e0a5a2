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
`apply_packed` is the int8 serving forward (and its calibration pass).
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

    def forward(self, x, offset: int = 0, total=None):
        """x [B, ch, T] -> [B, ch, T * upscale], in the module's mode. A
        time window of a longer recording passes its `offset` and the
        recording's `total` length, so the interpolated residual counts
        from the recording's start (ops/interp.py::upsample_linear)."""
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
        return out + upsample_linear(x, 2 ** len(self.upsample_blocks),
                                     offset=offset, total=total)


# ------------------------------------------------------- int8 serving path
def apply_packed(model: AudioSuperResolution, x, q=None, offset: int = 0,
                 total=None):
    """The eval forward in r-packed form under an int8 context `q`
    (ops/quant.py): its calibration pass or int8 serving; the JAX
    package's `apply_packed`. The stem enters r=4 from the plain input,
    each k4/s2 upsample doubles the packing rate (r4 -> r8 for x2), and the
    reconstruction exits to plain; residual adds are dequantized in the
    consuming conv's epilogue. The linear-interpolation residual stays
    float (the port's upsample_linear, held to the JAX package's
    transpose-conv form within 1e-6; `offset` and `total` as in
    `forward`). x: plain NWC [B, t, 1], t % 4 == 0 -> [B, m*t, 1]."""
    from ..ops.packed import packed_conv, packed_conv_r, packed_conv_transpose
    from ..ops.quant import ctx_or_null, lrelu, make_qops
    from .denoiser import _wio, _wio_t, folded_wio

    q = ctx_or_null(q)
    qconv, _ = make_qops(q)
    b_sz, t, cin = x.shape
    assert t % 4 == 0 and cin == 1, (t, cin)
    r = 4

    xq = q.quantize_in("in", x)
    stem = model.initial[0]
    h0 = qconv("stem", xq, _wio(stem), stem.bias, op=packed_conv_r,
               act=lrelu, r_in=1, r_out=r, padding=3, t_in=t)
    h = h0
    for i, blk in enumerate(model.residual_blocks):
        w1, b1 = folded_wio(q, f"blk{i}.c1", blk.conv1, blk.bn1)
        hh = qconv(f"blk{i}.c1", h, w1, b1, op=packed_conv, act=lrelu,
                   r=r, padding=1)
        w2, b2 = folded_wio(q, f"blk{i}.c2", blk.conv2, blk.bn2)
        h = qconv(f"blk{i}.c2", hh, w2, b2, op=packed_conv, add=h,
                  r=r, padding=1)
    wm, bm = folded_wio(q, "middle", model.middle[0], model.middle[1])
    h = qconv("middle", h, wm, bm, op=packed_conv, add=h0, r=r, padding=1)

    t_cur = t
    for i, up in enumerate(model.upsample_blocks):
        h = qconv(f"up{i}", h, _wio_t(up[0]), up[0].bias,
                  op=packed_conv_transpose, act=lrelu, r_in=r, r_out=2 * r,
                  stride=2, padding=1, t_in=t_cur)
        r, t_cur = 2 * r, 2 * t_cur
    hf = model.hf_emphasis[0]
    h = qconv("hf", h, _wio(hf), hf.bias, op=packed_conv, act=lrelu, r=r,
              padding=2)
    rc = model.reconstruction
    out = qconv("recon", h, _wio(rc), rc.bias, op=packed_conv_r,
                requant=False, r_in=r, r_out=1, padding=3, t_in=t_cur)
    m = 2 ** len(model.upsample_blocks)
    return out + upsample_linear(x.permute(0, 2, 1), m, offset=offset,
                                 total=total).permute(0, 2, 1)


def packed_amax(model: AudioSuperResolution, x) -> dict:
    """Calibration forward: {point: per-channel amax} of apply_packed."""
    from ..ops.quant import QuantCtx

    ctx = QuantCtx()
    apply_packed(model, x, q=ctx)
    return ctx.amax
