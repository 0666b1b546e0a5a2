"""The int8 conv of the int8 serving path: s8 x s8 -> s32, then a fused
requantizing epilogue.

What `ops/quant.py::int8_exec` plus `qconv` compute for one conv layer of
the JAX package, where XLA runs `conv_general_dilated(...,
preferred_element_type=int32)`:

    acc[n, t, o] = sum_m sum_i xd[n, t*s + m - lo, i] * wq[m, i, o]   (int32)

with xd the NWC s8 input, lhs-dilated by d (zeros inserted) and padded
(lo, hi) (a negative side crops), then in f32 and in this order:
y = float(acc) * ws[o], + bias[o], + add (an f32 tensor, or an s8 tensor
times its per-channel scale), the activation (none or leaky-ReLU 0.2 as
y >= 0 ? y : 0.2*y), and either s8 codes clip(rint(y * inv[o]), -127, 127)
or y stored as f32 / bf16.

On a CUDA tensor this is csrc/int8_conv.cu, built by ops/_build.py and
launched on the current stream; on a CPU tensor it is `int8_conv_plain`,
the same function in PyTorch ops (the conv in float64, which is exact:
|acc| <= 127^2 * K < 2^53). There is no fallback: a CUDA tensor the kernel
cannot take, a failed build or a failed launch raises.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import _build
from .lstm import _launch

# Launches since the last reset; the launch site adds one, and nothing else
# touches it but reset_launch_count.
launch_count = 0
_force_plain = False

ACTS = {None: 0, "lrelu": 1}
_OUT_MODES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_ADD_MODES = {None: 0, torch.float32: 1, torch.int8: 2}
# K is padded to this many bytes (the kernel's K tile), Cout to this many
# columns (its widest N tile)
K_TILE = 64
N_TILE = 64
# the plain version bounds its float64 intermediates to this many elements
_PLAIN_ELEMS = 1 << 27


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


@contextlib.contextmanager
def plain_int8_conv():
    """Test hook: inside this block the int8 conv runs its plain version
    even on a CUDA tensor, so a check can hold a kernel run against a
    plain run on the same card."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


class Int8Weight:
    """One quantized layer: the packed s8 kernel wq [kp, Cin, Cout], its
    per-output-channel scales ws [Cout] f32 and the bias [Cout] f32 (or
    None). The kernel reads wq as [Cout_pad, K_pad] (K = kp*Cin, taps
    outer), zero-padded to its tiles; that copy is made at the first launch
    and kept with the weight."""

    def __init__(self, wq, ws, bias=None):
        self.wq = wq
        self.ws = ws.float().contiguous()
        self.bias = None if bias is None else bias.float().contiguous()
        self._rows = None

    @property
    def shape(self):
        return tuple(self.wq.shape)

    def rows(self):
        """wq as [Cout_pad, K_pad] s8 on wq's device."""
        if self._rows is None:
            kp, cin, cout = self.wq.shape
            k = kp * cin
            k_pad = -(-k // K_TILE) * K_TILE
            c_pad = -(-cout // N_TILE) * N_TILE
            rows = torch.zeros((c_pad, k_pad), dtype=torch.int8,
                               device=self.wq.device)
            rows[:cout, :k] = self.wq.reshape(k, cout).T
            self._rows = rows
        return self._rows


def out_length(t_in: int, kp: int, stride: int, lhs_dilation: int,
               padding) -> int:
    """Output steps of the conv (XLA's rule; a negative pad crops)."""
    lo, hi = padding
    span = (t_in - 1) * lhs_dilation + 1 + lo + hi
    return max(0, (span - kp) // stride + 1)


def _check(x, weight, add, add_scale, act, out_inv, out_dtype, t_out):
    n, _, cin = x.shape
    kp, wcin, cout = weight.shape
    if x.dtype != torch.int8 or weight.wq.dtype != torch.int8:
        raise TypeError(f"int8 conv takes s8 input and kernel, got "
                        f"{x.dtype} and {weight.wq.dtype}")
    if wcin != cin:
        raise ValueError(f"input has {cin} channels, the kernel {wcin}")
    if act not in ACTS:
        raise ValueError(f"activation must be one of {list(ACTS)}, got "
                         f"{act!r}")
    if out_inv is None and out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"float output is f32 or bf16, got {out_dtype}")
    if add is not None:
        if add.dtype not in (torch.float32, torch.int8):
            raise TypeError(f"add must be f32 or s8, got {add.dtype}")
        if tuple(add.shape) != (n, t_out, cout):
            raise ValueError(f"add must be {[n, t_out, cout]}, got "
                             f"{list(add.shape)}")
        if (add.dtype == torch.int8) != (add_scale is not None):
            raise ValueError("an s8 add takes its scale, an f32 add none")


def int8_conv_plain(x, weight: Int8Weight, *, stride: int = 1,
                    lhs_dilation: int = 1, padding=(0, 0), add=None,
                    add_scale=None, act=None, out_inv=None,
                    out_dtype=torch.float32):
    """The plain version: `plain_accumulate`, then the epilogue in f32
    PyTorch ops. Arguments as for `int8_conv`."""
    kp = weight.shape[0]
    t_out = out_length(x.shape[1], kp, stride, lhs_dilation, padding)
    _check(x, weight, add, add_scale, act, out_inv, out_dtype, t_out)
    acc = plain_accumulate(x, weight.wq, stride=stride,
                           lhs_dilation=lhs_dilation, padding=padding)
    return _epilogue_plain(acc, weight, add, add_scale, act, out_inv,
                           out_dtype)


def plain_accumulate(x, wq, *, stride: int = 1, lhs_dilation: int = 1,
                     padding=(0, 0)):
    """The int32 accumulators [N, T_out, Cout] of the s8 conv: the conv in
    float64 on the s8 values (lhs dilation by zero insertion, padding by
    F.pad), in batch slices that bound the float64 intermediates, taken to
    int32 (exact: every partial sum is an integer below 2^53)."""
    n, t_in, cin = x.shape
    w = wq.permute(2, 1, 0).double()  # [Cout, Cin, kp]
    lo, hi = padding
    span = (t_in - 1) * lhs_dilation + 1 + max(lo, 0) + max(hi, 0)
    step = max(1, _PLAIN_ELEMS // max(1, cin * span))
    accs = []
    for s0 in range(0, n, step):
        xs = x[s0:s0 + step].permute(0, 2, 1).double()
        if lhs_dilation > 1:
            xd = xs.new_zeros((xs.shape[0], cin,
                               (t_in - 1) * lhs_dilation + 1))
            xd[..., ::lhs_dilation] = xs
            xs = xd
        xs = F.pad(xs, (lo, hi))
        accs.append(F.conv1d(xs, w, stride=stride).to(torch.int32))
    return torch.cat(accs).permute(0, 2, 1)


def _epilogue_plain(acc, weight, add, add_scale, act, out_inv, out_dtype):
    y = acc.float() * weight.ws
    if weight.bias is not None:
        y = y + weight.bias
    if add is not None:
        y = y + (add.float() * add_scale if add.dtype == torch.int8
                 else add)
    if act == "lrelu":
        y = torch.where(y >= 0, y, y * 0.2)
    if out_inv is not None:
        return torch.clamp(torch.round(y * out_inv), -127, 127).to(
            torch.int8)
    return y.to(out_dtype)


def _aligned(t):
    """t contiguous and starting on a 16-byte boundary (the kernel loads
    16 bytes at a time where the channel count allows)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _int8_conv_cuda(x, weight, *, stride, lhs_dilation, padding, add,
                    add_scale, act, out_inv, out_dtype):
    global launch_count
    n, t_in, cin = x.shape
    kp, _, cout = weight.shape
    t_out = out_length(t_in, kp, stride, lhs_dilation, padding)
    _check(x, weight, add, add_scale, act, out_inv, out_dtype, t_out)
    dev = x.device
    for name, t in (("kernel", weight.wq), ("add", add)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the input on {dev}")
    x = _aligned(x)
    rows = weight.rows()
    odt = torch.int8 if out_inv is not None else out_dtype
    out = torch.empty((n, t_out, cout), dtype=odt, device=dev)
    if out.numel() == 0:
        return out
    f32 = lambda t: None if t is None else t.to(dev, torch.float32).contiguous()  # noqa: E731
    ws, bias = f32(weight.ws), f32(weight.bias)
    inv, a_scale = f32(out_inv), f32(add_scale)
    add = None if add is None else add.contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lo, _ = padding
    _launch("int8_conv", _build.load("int8_conv").int8_conv, 8, 13,
            [ptr(x), ptr(rows), ptr(ws), ptr(bias), ptr(add), ptr(a_scale),
             ptr(inv), ptr(out), n, t_in, cin, t_out, cout, kp,
             rows.shape[1], stride, lhs_dilation, lo,
             _ADD_MODES[None if add is None else add.dtype], ACTS[act],
             _OUT_MODES[odt]], dev)
    launch_count += 1
    return out


def int8_conv(x, weight: Int8Weight, *, stride: int = 1,
              lhs_dilation: int = 1, padding=(0, 0), add=None,
              add_scale=None, act=None, out_inv=None,
              out_dtype=torch.float32):
    """One int8 conv layer with its fused epilogue.

    x [N, T_in, Cin] s8 (NWC); `weight` an Int8Weight; window `stride`,
    `lhs_dilation`, `padding` (lo, hi). `add`: [N, T_out, Cout] f32, or s8
    with `add_scale` [Cout]. `act`: None or "lrelu". `out_inv` [Cout]
    (1/scale): s8 output; else `out_dtype` (f32 or bf16). The kernel on a
    CUDA tensor (raises if it cannot run), the plain version on a CPU
    tensor or inside plain_int8_conv()."""
    kw = dict(stride=int(stride), lhs_dilation=int(lhs_dilation),
              padding=(int(padding[0]), int(padding[1])), add=add,
              add_scale=add_scale, act=act, out_inv=out_inv,
              out_dtype=out_dtype)
    if x.device.type == "cpu" or _force_plain:
        return int8_conv_plain(x, weight, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv for device {x.device}")
    return _int8_conv_cuda(x, weight, **kw)
