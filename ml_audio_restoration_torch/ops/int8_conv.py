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

`plan` maps a layer's shapes to the kernel's path, in one place, before
the launch: "wgmma" (Cin a multiple of 16: TMA boxes of one tap's channel
block into a ring in shared memory, wgmma s8 on the tensor cores, lhs
dilation split into phases), "stem" (Cin 1, no dilation, kp <= 32: the
row block's input span in 16-byte loads, an im2col tile, one wgmma) or
"generic" (everything else: gathered rows, mma.sync / __dp4a). The plan
also names the tiling the kernel runs, each phase's taps and, through
`chunks`, the order in which the wgmma path walks K over the weight rows
of `Int8Weight.rows()`; tests/test_torch_int8_plan.py recomputes the
accumulators from them on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .lstm import _launch

PATHS = ("wgmma", "stem", "generic")
_PATH_CODES = {"generic": 0, "wgmma": 1, "stem": 2}

# Launches since the last reset, in all and by path; the launch site adds
# one to each, and nothing else touches them but reset_launch_count.
launch_count = 0
launch_count_by_path = dict.fromkeys(PATHS, 0)
_force_plain = False

ACTS = {None: 0, "lrelu": 1}
_OUT_MODES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_ADD_MODES = {None: 0, torch.float32: 1, torch.int8: 2}
#: output rows a tile of the wgmma and stem paths (two warpgroups of 64)
BM = 128
#: the wgmma N tiles: Cout is padded to the first that holds it (beyond
#: 256, blocks of 256 columns)
N_TILES = (8, 32, 64, 128, 256)
#: the generic path's K tile and its widest N tile
K_TILE = 64
N_TILE = 64
#: shared memory a CTA may use on an H100, and the ring's target size (two
#: CTAs an SM where the tile allows)
SMEM_MAX = 232448
RING_TARGET = 110 * 1024
#: the stem path's limits: K in one k32 step, the span in its window
STEM_MAX_KP = 32
STEM_MAX_STRIDE = 8
# the plain version bounds its float64 intermediates to this many elements
_PLAIN_ELEMS = 1 << 27


def reset_launch_count() -> None:
    global launch_count, launch_count_by_path
    launch_count = 0
    launch_count_by_path = dict.fromkeys(PATHS, 0)


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
    outer), zero-padded as `weight_layout` says; that copy is made at the
    first launch and kept with the weight."""

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
            rows = torch.zeros(weight_layout(kp, cin, cout),
                               dtype=torch.int8, device=self.wq.device)
            rows[:cout, :k] = self.wq.reshape(k, cout).T
            self._rows = rows
        return self._rows


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _n_tile(cout: int) -> tuple[int, int]:
    """(N tile, column blocks) of the wgmma and stem paths."""
    n_tile = next((t for t in N_TILES if t >= cout), N_TILES[-1])
    return n_tile, -(-cout // n_tile)


def weight_layout(kp: int, cin: int, cout: int) -> tuple[int, int]:
    """(Cout_pad, K_pad) of the weight rows every path reads: K_pad a
    multiple of the generic K tile with at least 16 zero columns past K
    (the wgmma path's zero chunk), Cout_pad a multiple of the generic N tile
    holding every wgmma column block."""
    n_tile, blocks = _n_tile(cout)
    return (max(_up(cout, N_TILE), n_tile * blocks),
            _up(kp * cin + 16, K_TILE))


class Plan(NamedTuple):
    """How the kernel runs one layer. `path` is one of PATHS. The output
    rows of a sequence go in `phases` phases (t = c + phases*j, j < tpc)
    of `tiles` tiles of BM rows; phase c reads `taps[c]`. wgmma and stem:
    N tile `n_tile`, `col_blocks` blocks of it. wgmma: channel block `cw`
    (bytes of one TMA box row), `rb` rows a box, `stages` in the ring."""
    path: str
    t_out: int
    phases: int
    tpc: int
    tiles: int
    taps: tuple
    n_tile: int = 0
    col_blocks: int = 0
    cw: int = 0
    rb: int = 0
    stages: int = 0


def _ring_stages(n_tile: int, cw: int, cin: int, taps) -> int:
    """The wgmma ring's depth: enough stages for the longest phase's K, up
    to RING_TARGET bytes, at least 3, within SMEM_MAX with the staging tile
    it overlaps (csrc/int8_conv.cu::launch_wgmma lays them out the same
    way)."""
    per = max(cw, 32) // cw
    stage = per * BM * cw + per * _up(n_tile * cw, 1024)
    steps = max(-(-len(t) * (cin // cw) // per) for t in taps)
    staged = BM * (n_tile + 8) * 4
    stages = max(3, min(8, steps, RING_TARGET // stage))
    while 1024 + max(stages * stage, staged) + 16 * stages > SMEM_MAX:
        stages -= 1
    return stages


def plan(x_shape, w_shape, stride: int = 1, lhs_dilation: int = 1,
         padding=(0, 0)) -> Plan:
    """The path and tiling of one int8 conv layer, from its shapes alone:
    x [N, T_in, Cin], the kernel [kp, Cin, Cout]."""
    _, t_in, cin = x_shape
    kp, _, cout = w_shape
    s, d, lo = int(stride), int(lhs_dilation), int(padding[0])
    t_out = out_length(t_in, kp, s, d, padding)
    n_tile, blocks = _n_tile(cout)
    if cin % 16 == 0 and (d == 1 or s == 1) and s <= 8:
        phases = d
        tpc = -(-t_out // phases)
        taps = tuple(tuple(range((lo - c) % d if d > 1 else 0, kp, d))
                     for c in range(phases))
        cw = next(w for w in (128, 64, 32, 16) if cin % w == 0)
        rb = next(r for r in (BM, 64, 32) if r * s <= 256)
        return Plan("wgmma", t_out, phases, tpc, -(-tpc // BM), taps,
                    n_tile, blocks, cw, rb,
                    _ring_stages(n_tile, cw, cin, taps))
    if (cin == 1 and d == 1 and kp <= STEM_MAX_KP
            and s <= STEM_MAX_STRIDE):
        return Plan("stem", t_out, 1, t_out, -(-t_out // BM),
                    (tuple(range(kp)),), n_tile, blocks)
    return Plan("generic", t_out, 1, t_out, 0, (tuple(range(kp)),))


def chunks(p: Plan, kp: int, cin: int, c: int) -> list[tuple[int, int, int]]:
    """The wgmma path's K walk for phase c: (tap, first channel, first
    weight column) of each chunk of `p.cw` channels, in K order, and the
    zero chunk (weight columns K..K+15) that pairs an odd count of 16-byte
    chunks into k32 steps (its tap and channels those of the chunk
    before)."""
    out = [(m, cb * p.cw, m * cin + cb * p.cw) for m in p.taps[c]
           for cb in range(cin // p.cw)]
    if p.cw == 16 and len(out) % 2:
        out.append((*out[-1][:2], kp * cin))
    return out


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
    """t contiguous and starting on a 16-byte boundary (the kernel's tensor
    maps and its 16-byte loads and stores need both)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_maps(p: Plan, x, rows):
    """What the wgmma path's tensor maps read must start on 16 bytes, with
    every stride a multiple of 16 bytes: x [N, T_in, Cin] and the weight
    rows [Cout_pad, K_pad], both contiguous."""
    for name, t in (("input", x), ("weight rows", rows)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8 conv {p.path}: the {name} must be "
                             f"contiguous and 16-byte aligned")
    if x.shape[2] % 16 or rows.shape[1] % 16:
        raise ValueError(f"int8 conv {p.path}: Cin {x.shape[2]} and K_pad "
                         f"{rows.shape[1]} must be multiples of 16")


def _int8_conv_cuda(x, weight, *, stride, lhs_dilation, padding, add,
                    add_scale, act, out_inv, out_dtype):
    global launch_count
    n, t_in, cin = x.shape
    kp, _, cout = weight.shape
    p = plan(x.shape, weight.shape, stride, lhs_dilation, padding)
    t_out = p.t_out
    _check(x, weight, add, add_scale, act, out_inv, out_dtype, t_out)
    dev = x.device
    for name, t in (("kernel", weight.wq), ("add", add)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the input on {dev}")
    x = _aligned(x)
    rows = weight.rows()
    if p.path == "wgmma":
        _check_maps(p, x, rows)
    odt = torch.int8 if out_inv is not None else out_dtype
    out = torch.empty((n, t_out, cout), dtype=odt, device=dev)
    if out.numel() == 0:
        return out
    f32 = lambda t: None if t is None else t.to(dev, torch.float32).contiguous()  # noqa: E731
    ws, bias = f32(weight.ws), f32(weight.bias)
    inv, a_scale = f32(out_inv), f32(add_scale)
    add = None if add is None else _aligned(add)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lo, _ = padding
    _launch("int8_conv", _build.load("int8_conv").int8_conv, 8, 22,
            [ptr(x), ptr(rows), ptr(ws), ptr(bias), ptr(add), ptr(a_scale),
             ptr(inv), ptr(out), _PATH_CODES[p.path], n, t_in, cin, t_out,
             cout, kp, rows.shape[1], rows.shape[0], stride, lhs_dilation,
             lo, p.phases, p.tiles, p.n_tile, p.col_blocks, p.cw,
             p.rb, p.stages, _ADD_MODES[None if add is None else add.dtype],
             ACTS[act], _OUT_MODES[odt]], dev)
    launch_count += 1
    launch_count_by_path[p.path] += 1
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
