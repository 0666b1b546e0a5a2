"""Halo arithmetic of sequence-parallel serving (the mesh's 'model' axis).

The JAX package shards each chunk's time over the 'model' axis and lets XLA
insert every conv's halo exchange. Every stage in front of the stereo LSTM
(the denoiser, super-resolution and the stereo encoder) and the stereo
decoders behind it are local in time, so the port runs them on overlapping
windows instead: a window is a core of the time axis plus a halo on each
side that covers the stage's receptive radius, cut from the recording and
clipped at its real ends, and each output is cropped back to its core. The
stage's own zero padding (and the denoiser's odd-level right-pad) then
happens only at the real ends, as in the whole, and no neighbour exchange
is needed inside a layer. The LSTM is the one global step: time is gathered
before it.

The radii are derived from the modules: each layer maps the interval of
output samples it must produce to the interval of input samples it reads
(kernel size, dilation, padding, stride, pools, transposed convs, the
interpolated residual and the denoiser's impulse score). Cores are cut on
the stages' grid (the denoiser's pools, and under int8 the packing of the
packed forwards), so a window's pools and packed phases line up with the
whole's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

# samples a packed frame holds at the stage input in the int8 forwards
# (models/*.py::apply_packed: r=4 at the denoiser's and SR's input rate,
# 4 at the stereo encoder's, 2 at the stereo decoders')
PACKED_GRID = {"denoiser": 4, "super_resolution": 4, "stereo_encoder": 4,
               "stereo_decoder": 2}


class Window(NamedTuple):
    """A core [lo, hi) of the time axis inside its window [start, stop)."""
    lo: int
    hi: int
    start: int
    stop: int


def windows(cores, halo: int, length: int) -> list:
    """Each core with `halo` samples on both sides, clipped at the
    recording's real ends [0, length)."""
    return [Window(lo, hi, max(0, lo - halo), min(length, hi + halo))
            for lo, hi in cores]


# ------------------------------------------------ receptive intervals
# A field maps the interval [a, b] (inclusive) of samples a layer must
# produce to the interval of its input that they read.

def _conv(conv):
    k, d = conv.kernel_size[0], conv.dilation[0]
    p, s = conv.padding[0], conv.stride[0]
    return lambda a, b: (a * s - p, b * s - p + (k - 1) * d)


def _conv_transpose(up):
    k, s, p = up.kernel_size[0], up.stride[0], up.padding[0]
    # out[o] = sum over in[i] * w[j] with o = i * s - p + j, 0 <= j < k
    return lambda a, b: (-((k - 1 - a - p) // s), (b + p) // s)


def _pool(window: int = 2, stride: int = 2):
    return lambda a, b: (a * stride, b * stride + window - 1)


def _forward_difference(a, b):
    return a, b + 1


def _chain(*fields):
    """The fields of layers applied in order (first to last)."""
    def need(a, b):
        for field in reversed(fields):
            a, b = field(a, b)
        return a, b
    return need


def _union(*fields):
    """Several paths reading one input (a residual, a skip, a mask)."""
    def need(a, b):
        ivs = [field(a, b) for field in fields]
        return min(i[0] for i in ivs), max(i[1] for i in ivs)
    return need


def _identity(a, b):
    return a, b


def _block(seq, idx=(0, 3)):
    """A conv-BN-LReLU block's convs (at Sequential indices `idx`)."""
    return _chain(*(_conv(seq[i]) for i in idx))


def denoiser_field(model):
    """The U-Net (models/denoiser.py::AudioDenoiser.forward): encoder
    blocks and pools down, transpose convs and blocks on [skip, up], the
    transient detector and final conv, and detect_impulses on the raw
    input (two forward differences and a box of IMPULSE_BOX)."""
    from ..models.denoiser import IMPULSE_BOX

    levels = len(model.encoder)
    skips = []  # the field of skip i, from the input
    down = _identity
    for i, block in enumerate(model.encoder):
        skips.append(_chain(down, _block(block)))
        down = _chain(skips[-1], _pool())
    h = _chain(down, _block(model.bottleneck))
    for i in range(levels):
        up, block = model.decoder[2 * i], model.decoder[2 * i + 1]
        h = _chain(_union(skips[-(i + 1)], _chain(h, _conv_transpose(up))),
                   _block(block))
    td = model.transient_detector
    head = _union(_chain(h, _conv(model.final_conv)),
                  _chain(h, *(_conv(td[j]) for j in (0, 2, 4))))
    half = IMPULSE_BOX // 2
    impulses = _chain(_forward_difference, _forward_difference,
                      lambda a, b: (a - half, b + half))
    return _union(head, impulses)


def super_resolution_field(model):
    """models/super_resolution.py: the k7 stem, residual blocks, the middle
    conv with its long skip, the transpose convs, the HF conv and the
    reconstruction, beside the linearly interpolated input."""
    f = 2 ** len(model.upsample_blocks)
    h0 = _conv(model.initial[0])
    h = h0
    for blk in model.residual_blocks:
        h = _union(h, _chain(h, _conv(blk.conv1), _conv(blk.conv2)))
    h = _union(h0, _chain(h, _conv(model.middle[0])))
    for up in model.upsample_blocks:
        h = _chain(h, _conv_transpose(up[0]))
    h = _chain(h, _conv(model.hf_emphasis[0]), _conv(model.reconstruction))
    # out[o] reads x[floor((o + 0.5) / f - 0.5)] and the sample after it
    residual = lambda a, b: ((2 * a + 1 - f) // (2 * f),  # noqa: E731
                             (2 * b + 1 - f) // (2 * f) + 1)
    return _union(h, residual)


def encoder_field(model):
    """models/stereo_separator.py::StereoSeparator.encode: the stem conv and
    each block's dilated and pointwise convs."""
    stem = model.encoder[0]
    return _chain(_conv(stem[0]),
                  *(_block(blk) for blk in model.encoder[1:]))


def decoder_field(model):
    """StereoSeparator.decode: both decoders' convs."""
    def one(dec):
        return _chain(*(_conv(dec[i]) for i in (0, 3, 6, 9)))
    return _union(one(model.left_decoder), one(model.right_decoder))


def radius(field, rate: int = 1, grid: int = 1) -> int:
    """The halo, in input samples, that reproduces `field`'s output on any
    core cut on multiples of `grid` input samples: `rate` output samples
    an input sample. Evaluated on one grid cell far from the ends (the
    interval of a longer core is the union of its cells')."""
    lo = 1024 * grid
    a, b = field(lo * rate, (lo + grid) * rate - 1)
    return max(lo - a, b - (lo + grid - 1), 0)


def _round_up(n: int, grid: int) -> int:
    return -(-n // grid) * grid


class SequencePlan(NamedTuple):
    """The halos and grid of one stage stack: `grid` and `front_halo` in
    input samples (the stages in front of the LSTM, one halo for all);
    `back_halo` in stage-rate samples (the stereo decoders, or 0)."""
    grid: int
    front_halo: int
    back_halo: int


def plan(dn=None, sr=None, st=None, *, source_rate: bool = False,
         stereo_windows: bool = False, packed: bool = False) -> SequencePlan:
    """The cut grid and halos of a stack of the given stages (None: not
    run). `source_rate`: the stereo stage reads the denoiser's output, not
    SR's; `stereo_windows`: the stereo stage runs on the gathered input
    (sub-chunked stereo), so the front halo covers the denoiser and SR
    only; `packed`: the int8 forwards run, whose packing the cuts must
    respect too."""
    f = 2 ** len(sr.upsample_blocks) if sr is not None else 1
    st_f = 1 if source_rate else f  # stage-rate samples an input sample
    grid = 2 ** len(dn.encoder) if dn is not None else 1
    if packed:
        for name, on, rate in (("denoiser", dn, 1),
                               ("super_resolution", sr, 1),
                               ("stereo_encoder", st, st_f),
                               ("stereo_decoder", st, st_f)):
            if on is not None:
                grid = math.lcm(grid, -(-PACKED_GRID[name] // rate))
    # the front: input -> (denoiser) -> (SR) -> encoder input, and the
    # encoder on top of whichever signal it reads
    mid = []
    if dn is not None:
        mid.append(denoiser_field(dn))
    enc_input = list(mid)
    if sr is not None:
        sr_field = super_resolution_field(sr)
        mid.append(sr_field)
        if not source_rate:
            enc_input.append(sr_field)
    fields = [(_chain(*mid) if mid else _identity, f)]
    if st is not None and not stereo_windows:
        fields.append((_chain(*enc_input, encoder_field(st)), st_f))
    elif st is not None and source_rate:
        fields.append((_chain(*enc_input) if enc_input else _identity, 1))
    front = max(radius(field, rate, grid) for field, rate in fields)
    back = 0
    if st is not None and not stereo_windows:
        back = _round_up(radius(decoder_field(st)), grid * st_f)
    return SequencePlan(grid, _round_up(front, grid), back)


def crop(x, window: Window, rate: int = 1):
    """The core of a window's output `x` ([..., (stop - start) * rate]):
    samples [lo * rate, hi * rate) of the whole."""
    s = window.start * rate
    return x[..., window.lo * rate - s:window.hi * rate - s]
