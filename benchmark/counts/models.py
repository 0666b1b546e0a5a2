"""Model FLOPs from shapes: the multiply-adds of every convolution and
matrix product (2 per multiply-add), as `torch.utils.flop_counter`
counts them (a transposed convolution over its input's length); biases,
activations, normalization and the FFTs are not counted.

`config` is a configuration file of `benchmark/configs/` (its
`denoiser`, `super_resolution`, `stereo_separator` and `pipeline`
groups); lengths are samples of one item (batch 1).
"""
from __future__ import annotations


def conv(cin: int, cout: int, k: int, t_out: int) -> float:
    return 2.0 * cin * cout * k * t_out


def tconv(cin: int, cout: int, k: int, t_in: int) -> float:
    return 2.0 * cin * cout * k * t_in


def denoiser(t: int, features=(32, 64, 128), in_channels: int = 1,
             out_channels: int = 1) -> float:
    """The U-Net on t samples: encoder levels at t, t//2, ..., the
    bottleneck, transpose-conv decoder, transient detector, final conv
    and the impulse score's 5-tap box filter."""
    lengths = [t]
    for _ in features:
        lengths.append(lengths[-1] // 2)
    f, ch = 0.0, in_channels
    for i, fe in enumerate(features):
        f += conv(ch, fe, 3, lengths[i]) + conv(fe, fe, 3, lengths[i])
        ch = fe
    fb, lb = 2 * features[-1], lengths[len(features)]
    f += conv(features[-1], fb, 3, lb) + conv(fb, fb, 3, lb)
    for i, fe in enumerate(reversed(features)):
        lvl = len(features) - i
        f += tconv(2 * fe, fe, 2, lengths[lvl])
        f += conv(2 * fe, fe, 3, lengths[lvl - 1]) + conv(fe, fe, 3,
                                                          lengths[lvl - 1])
    f0 = features[0]
    f += (conv(f0, f0 // 2, 3, t) + conv(f0 // 2, f0 // 4, 3, t)
          + conv(f0 // 4, 1, 3, t) + conv(f0, out_channels, 1, t))
    return f + conv(1, 1, 5, t)


def super_resolution(t: int, upscale_factor: int = 2, channels: int = 1,
                     base_channels: int = 32,
                     num_residual_blocks: int = 4) -> float:
    """The SR net on t samples -> t * upscale_factor."""
    c = base_channels
    f = conv(channels, c, 7, t) + num_residual_blocks * 2 * conv(c, c, 3, t)
    f += conv(c, c, 3, t)
    n = t
    while upscale_factor > 1:
        f += tconv(c, c, 4, n)
        n *= 2
        upscale_factor //= 2
    return f + conv(c, c, 5, n) + conv(c, channels, 7, n)


def stereo_separator(t: int, base_channels: int = 32, lstm_hidden: int = 64,
                     num_lstm_layers: int = 1) -> float:
    """The stereo net on t samples: stem, four dilated blocks, the LSTM
    (input projection and the h @ W_hh products) and two decoders."""
    c, h = base_channels, lstm_hidden
    f = conv(1, c, 7, t)
    for i, o in [(c, 2 * c), (2 * c, 4 * c), (4 * c, 4 * c), (4 * c, 4 * c)]:
        f += conv(i, o, 3, t) + conv(o, o, 1, t)
    cin = 4 * c
    for _ in range(num_lstm_layers):
        f += 2.0 * t * cin * 4 * h + 2.0 * t * h * 4 * h
        cin = h
    dec = (conv(h, 4 * c, 7, t) + conv(4 * c, 2 * c, 7, t)
           + conv(2 * c, c, 7, t) + conv(c, 1, 7, t))
    return f + 2 * dec


def stereo_windows(config: dict, t2: int, rate: int) -> list[int]:
    """The stereo stage's window lengths over a stage input of t2 samples:
    [t2], or the 0.25 s-style windows of `stereo_chunk_seconds`, framed as
    the pipeline frames them (window rounded down to a multiple of 4, an
    overlap of `overlap_seconds` capped at a quarter of it)."""
    p = config["pipeline"]
    sub_s = p.get("stereo_chunk_seconds")
    f = config["super_resolution"]["upscale_factor"]
    if sub_s is None:
        return [t2]
    sub = max(4, int(round(sub_s * rate * f)) // 4 * 4)
    ov = min(int(round(p["overlap_seconds"] * rate * f)), sub // 4)
    if sub >= t2:
        return [t2]
    hop = sub - ov
    m = 1 if t2 <= sub else 1 + -(-(t2 - sub) // hop)
    return [sub] * m


def chain(config: dict, t: int) -> float:
    """The three stages on one chunk of t input samples."""
    rate = config["pipeline"]["sample_rate"]
    sr = config["super_resolution"]
    t2 = t * sr["upscale_factor"]
    f = denoiser(t, **config["denoiser"]) + super_resolution(t, **sr)
    return f + sum(stereo_separator(w, **config["stereo_separator"])
                   for w in stereo_windows(config, t2, rate))
