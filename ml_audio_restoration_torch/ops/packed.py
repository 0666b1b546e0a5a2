"""Packed ("space-to-depth") 1-D convolutions, for the int8 forwards only.

Counterpart of ml_audio_restoration_tpu/ops/packed.py. The port computes
the plain layout everywhere else; it carries the packed layout here because
the int8 serving result is defined on it: weights are quantized after the
block-Toeplitz gather (one scale per packed output channel), activation
scales are per packed channel, and the input scales are folded into the
packed kernel's rows before weight quantization (ops/quant.py).

Representation ("r-packed"): P_r(x)[n, t, phase*C + c] = x[n, r*t + phase, c].
Tensors are NWC [B, Tp, r*C], contiguous in channels, as the int8 conv
kernel (csrc/int8_conv.cu) reads them; kernels are WIO [kp, Cin, Cout] as
in the JAX package. A plain conv weight [Cout, Cin, k] enters as
`w.permute(2, 1, 0)`, a transpose conv's [Cin, Cout, k] as
`w.permute(2, 0, 1)` (torch's tap order; the packed op flips it).

Every packed op hands its input, a thunk that gathers (packed kernel,
tiled bias), and the conv's window stride, padding and lhs dilation to an
executor: `_plain_exec` (cuDNN / ATen `F.conv1d` on the packed tensor) by
default, or the int8 executor of ops/quant.py, which gathers only when its
cache of quantized kernels misses.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


# ------------------------------------------------------------- kernel maps
# Copies of the JAX package's static index maps (numpy, no JAX).
@functools.lru_cache(maxsize=None)
def _conv_index_map(k: int, r: int, padding: int, dilation: int):
    """Static (m, b, a) -> j map for a stride-1 'same' conv at packing r.

    Returns (jmap [kp, r, r] int32 with k as the zero slot, (lo, hi) packed
    conv padding)."""
    entries = []  # (delta, b, a, j)
    for j in range(k):
        for a in range(r):
            num = j * dilation - padding + a  # = r*delta + b
            b = num % r
            entries.append(((num - b) // r, b, a, j))
    deltas = [e[0] for e in entries]
    lo, hi = -min(deltas), max(deltas)
    kp = lo + hi + 1
    jmap = np.full((kp, r, r), k, np.int32)
    for delta, b, a, j in entries:
        slot = jmap[delta + lo, b, a]
        assert slot == k, "duplicate packed-kernel slot"
        jmap[delta + lo, b, a] = j
    return jmap, (lo, hi)


@functools.lru_cache(maxsize=None)
def _transpose_index_map(k: int, r_in: int, r_out: int, stride: int,
                         padding: int, dilation: int = 1):
    """Static (m, b, a) -> j map for a transpose conv between packing rates:
    j*dilation = r_out*Delta + a - stride*b + padding. Returns (jmap, lo,
    packed lhs dilation)."""
    dil, rem = divmod(stride * r_in, r_out)
    assert rem == 0 and dil >= 1, (
        f"unsupported packing: stride {stride} r_in {r_in} r_out {r_out}")
    entries = []
    for j in range(k):
        for a in range(r_out):
            for b in range(r_in):
                num = stride * b + j * dilation - a - padding
                if num % r_out == 0:
                    entries.append((num // r_out, b, a, j))
    deltas = [e[0] for e in entries]
    lo, hi = -min(deltas), max(deltas)
    kp = lo + hi + 1
    jmap = np.full((kp, r_in, r_out), k, np.int32)
    for delta, b, a, j in entries:
        slot = jmap[delta + lo, b, a]
        assert slot == k, "duplicate packed-transpose slot"
        jmap[delta + lo, b, a] = j
    return jmap, lo, dil


@functools.lru_cache(maxsize=None)
def _conv_raise_index_map(k: int, r_in: int, r_out: int, padding: int,
                          dilation: int):
    """Static map for a stride-1 plain conv whose output is packed at a
    higher rate than its input (r_out = s*r_in): a packed-level conv with
    window stride s. j*dilation = r_in*Delta + b - a + padding. Returns
    (jmap, lo, s)."""
    s, rem = divmod(r_out, r_in)
    assert rem == 0 and s >= 1, (r_in, r_out)
    entries = []
    for j in range(k):
        for a in range(r_out):
            num = j * dilation + a - padding
            b = num % r_in
            entries.append(((num - b) // r_in, b, a, j))
    deltas = [e[0] for e in entries]
    lo, hi = -min(deltas), max(deltas)
    kp = lo + hi + 1
    jmap = np.full((kp, r_in, r_out), k, np.int32)
    for delta, b, a, j in entries:
        assert jmap[delta + lo, b, a] == k, "duplicate packed-raise slot"
        jmap[delta + lo, b, a] = j
    return jmap, lo, s


def _gather_kernel(w, jmap):
    """w [k, cin, cout] + jmap [kp, bi, ao] -> packed [kp, bi*cin, ao*cout],
    phase-major: (b, cin) rows, (a, cout) columns."""
    k, cin, cout = w.shape
    kp, bi, ao = jmap.shape
    w_ext = torch.cat([w, w.new_zeros((1, cin, cout))])
    idx = torch.from_numpy(jmap.reshape(-1).astype(np.int64)).to(w.device)
    wp = w_ext[idx].reshape(kp, bi, ao, cin, cout)
    return wp.permute(0, 1, 3, 2, 4).reshape(kp, bi * cin, ao * cout)


def _group_kernels(w, b, jmap, r_out: int, flip: bool = False):
    """(packed kernel, tiled bias) of one plain kernel [k, Cin, Cout] and
    bias [Cout] (or None): the single-group case of the JAX package's
    _group_kernels."""
    wp = _gather_kernel(w, jmap)
    if flip:
        wp = torch.flip(wp, [0])
    bias = None if b is None else b.repeat(r_out)
    return wp, bias


# ------------------------------------------------------------ packed ops
def _plain_exec(xp, kernel, *, window_strides, padding, lhs_dilation=None):
    """Default executor: the float conv of an NWC tensor [B, T, Cin] with
    the WIO kernel [kp, Cin, Cout] that `kernel()` returns beside its bias,
    lhs dilation (zeros inserted), padding (lo, hi) (a negative side crops,
    as in XLA) and window stride, in the input's dtype; then + bias.
    Returns NWC [B, T_out, Cout]."""
    wp, bias = kernel()
    x = xp.permute(0, 2, 1)
    d = 1 if lhs_dilation is None else int(lhs_dilation[0])
    if d > 1:
        t = x.shape[2]
        xd = x.new_zeros((x.shape[0], x.shape[1], (t - 1) * d + 1))
        xd[..., ::d] = x
        x = xd
    lo, hi = padding[0]
    x = F.pad(x, (lo, hi))
    y = F.conv1d(x, wp.permute(2, 1, 0).to(x.dtype),
                 stride=int(window_strides[0]))
    y = y.permute(0, 2, 1)
    if bias is not None:
        y = y + bias
    return y


def packed_conv(xp, w, b=None, *, r: int, padding: int, dilation: int = 1,
                _exec=None, **epilogue):
    """Stride-1 'same' conv on an r-packed tensor, equal to the plain conv
    of the unpacked signal at every valid sample.
    xp [B, Tp, r*Cin]; w [k, Cin, Cout] (WIO) -> [B, Tp, r*Cout].
    `epilogue` goes to the executor (the int8 one takes it)."""
    jmap, (lo, hi) = _conv_index_map(int(w.shape[0]), r, padding, dilation)
    return (_exec or _plain_exec)(
        xp, lambda: _group_kernels(w, b, jmap, r), window_strides=(1,),
        padding=[(lo, hi)], **epilogue)


def packed_conv_transpose(xp, w, b=None, *, r_in: int, r_out: int,
                          stride: int, padding: int, t_in: int,
                          dilation: int = 1, _exec=None, **epilogue):
    """ConvTranspose1d on packed tensors, possibly changing the packing
    rate; w [k, Cin, Cout] in torch's tap order. `t_in` is the plain input
    length. Requires t_in % r_in == 0 and the plain output length % r_out
    == 0."""
    k, cin, cout = w.shape
    assert t_in % r_in == 0, (t_in, r_in)
    t_out = (t_in - 1) * stride - 2 * padding + dilation * (k - 1) + 1
    assert t_out % r_out == 0, (t_out, r_out)
    jmap, lo, dil = _transpose_index_map(int(k), r_in, r_out, stride,
                                         padding, dilation)
    kp = jmap.shape[0]
    tp_in = t_in // r_in
    # flipped kernel + lhs dilation with padding (kp-1-lo, kp-1-p_hi), p_hi
    # trimming the packed output to exactly t_out/r_out steps; a negative
    # side crops (both executors take it)
    p_hi = dil * (tp_in - 1) + kp - lo - t_out // r_out
    return (_exec or _plain_exec)(
        xp, lambda: _group_kernels(w, b, jmap, r_out, flip=True),
        window_strides=(1,), padding=[(kp - 1 - lo, kp - 1 - p_hi)],
        lhs_dilation=(dil,), **epilogue)


def packed_conv_r(xp, w, b=None, *, r_in: int, r_out: int, padding: int,
                  dilation: int = 1, t_in: int, _exec=None, **epilogue):
    """Stride-1 'same' plain-conv semantics between two packing rates (one
    dividing the other; r=1 is the plain layout). r_in < r_out enters
    packed space (a packed conv of window stride r_out/r_in); r_in > r_out
    leaves it (the conv as its transpose with a flipped kernel)."""
    if r_in == r_out:
        return packed_conv(xp, w, b, r=r_in, padding=padding,
                           dilation=dilation, _exec=_exec, **epilogue)
    k = int(w.shape[0])
    if r_in > r_out:
        return packed_conv_transpose(
            xp, torch.flip(w, [0]), b, r_in=r_in, r_out=r_out, stride=1,
            padding=(k - 1) * dilation - padding, dilation=dilation,
            t_in=t_in, _exec=_exec, **epilogue)
    assert t_in % r_out == 0, (t_in, r_out)
    jmap, lo, s = _conv_raise_index_map(k, r_in, r_out, padding, dilation)
    kp = jmap.shape[0]
    return (_exec or _plain_exec)(
        xp, lambda: _group_kernels(w, b, jmap, r_out), window_strides=(s,),
        padding=[(lo, kp - s - lo)], **epilogue)


def packed_max_pool2(xp, c: int):
    """MaxPool1d(2) on an r-packed tensor: [B, Tp, r*C] -> [B, Tp, (r/2)*C]
    (pairwise max over adjacent phases); int8 too."""
    b, tp, rc = xp.shape
    r = rc // c
    assert r % 2 == 0 and r * c == rc
    return xp.reshape(b, tp, r // 2, 2, c).amax(dim=3).reshape(
        b, tp, (r // 2) * c)
