"""IIR scans over time: the biquad cascade and direct form II transposed.

Counterpart of the `lax.scan`s inside ml_audio_restoration_tpu/ops/
filters.py::sosfilt (:94-122) and ::lfilter (:152-184). A scan takes rows
[R, T], each with its own coefficients and initial state, and walks time:
- `sos_scan(x, sos, zi)`: sos [R, S, 6], zi [R, S, 2], S <= 4 sections;
- `df2t_scan(x, ba, zi)`: ba [R, 2 (N + 1)] (b then a, a[0] = 1), zi
  [R, N], order N <= 8.
Both are differentiable in x and in the initial state (not in the
coefficients, as JAX's callers never need): the backward pass is the
adjoint recurrence walked in reverse time, which needs nothing of the
forward walk because the filters are linear.

The walk is a blocked parallel-in-time scan. The recurrence is linear,
state' = A state + B u, so `partition` cuts each row into P blocks of L
steps and a walk runs in three passes over them:
1. local: each block walks its L steps from the zero state, giving its end
   state b_k (block 0 starts from the initial state);
2. combine: with Phi the L-step transition of the state at zero input, the
   blocks' true end states E_k = Phi E_{k-1} + b_k come out of an
   inclusive Hillis-Steele scan over blocks, E_k += Phi^d E_{k-d} at d = 1,
   2, 4, ... (Phi^(2d) by squaring);
3. replay: each block walks again from its entry state E_{k-1} and writes
   its outputs.
The state, the transitions and the combine are float64 for any data type,
and each output is rounded once. The design needs it: the 100 Hz rumble
low-pass's poles lie within 0.03 of the unit circle and magnify every
rounding of the state, and an f32 blocked scan rounds the state in two
passes and the combine. In float64 a walk ends within 1e-6 of the peak of
the exact answer (tests/test_torch_iir.py), where JAX's serial f32 walk of
the rumble ends 3.3e-5 away. The adjoint is the transposed recursion,
whose state for such a pole grows far above its output and cancels; it
needs float64 in any design.

Where the padding goes: a walk's P L steps exceed T by pad < L, and the
padding leads in walk order (reverse time for the adjoints), so the short
block is block 0, which starts from the initial state at its step `pad`;
every later block is L steps long, so one Phi serves the whole combine.

On a CUDA tensor each walk is one launch of csrc/iir_scan.cu (one CTA a
row, one thread a block); on a CPU tensor it is the plain version here,
the same passes vectorised over [R, P] with a Python loop over the L steps
and the combine's levels (`sos_scan_plain` and friends, which take a
tensor on any device). The kernel is built with -fmad=false and takes
every operation in the plain versions' order, products and sums written
out (no matmul, whose sums a library may reorder), so the two agree bit
for bit. No fallback: a CUDA tensor the kernel cannot take raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

LIBRARY = "iir_scan"
MAX_SECTIONS = 4
MAX_ORDER = 8
BLOCK = 64          # steps a block while a row fits in MAX_BLOCKS of them
MAX_BLOCKS = 512    # blocks a row: the kernel's threads a CTA, each with
#                     up to 128 registers (csrc/iir_scan.cu)
_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}

# Launches since the last reset: forward walks (launch_count) and adjoint
# walks (adjoint_launch_count). Each launch site adds one; nothing else
# touches them but reset_launch_count.
launch_count = 0
adjoint_launch_count = 0


def reset_launch_count() -> None:
    global launch_count, adjoint_launch_count
    launch_count = adjoint_launch_count = 0


def partition(steps: int) -> tuple[int, int]:
    """(L, P) for a walk of `steps` >= 1 steps: P blocks of L steps, with
    P L - steps < L. L is BLOCK up to BLOCK * MAX_BLOCKS steps, then grows
    so that P stays <= MAX_BLOCKS."""
    if steps < 1:
        raise ValueError(f"a walk takes at least one step, got {steps}")
    block = max(BLOCK, -(-steps // MAX_BLOCKS))
    return block, -(-steps // block)


def _use_plain(x) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no IIR scan for device {x.device}")
    return False


# ------------------------------------------------------------------ steps
# One step of each recurrence on float64 tensors: the state is a list of
# its components, each [R, X] (X blocks or unit states), the coefficients
# [R, 1] columns, u the input [R, X]. Each returns (output, new state) and
# takes the operations in csrc/iir_scan.cu's order.
def _sos_coefficients(sos):
    """Per section (b0, b1, b2, a1, a2) as float64 [R, 1] columns."""
    sos = sos.double()
    return [[sos[:, s, i, None] for i in (0, 1, 2, 4, 5)]
            for s in range(sos.shape[1])]


def _sos_step(c, z, u):
    # JAX's step: out = b0*y + z0; z0 = b1*y - a1*out + z1; z1 = b2*y - a2*out
    z = list(z)
    for s, (b0, b1, b2, a1, a2) in enumerate(c):
        out = b0 * u + z[2 * s]
        z[2 * s], z[2 * s + 1] = (b1 * u - a1 * out + z[2 * s + 1],
                                  b2 * u - a2 * out)
        u = out
    return u, z


def _sos_adjoint_step(c, z, g):
    # the cotangent of each section's out, then of its input, last section
    # first; the state's cotangent becomes (d out, d z0')
    z = list(z)
    for s in range(len(c) - 1, -1, -1):
        b0, b1, b2, a1, a2 = c[s]
        go = g - a1 * z[2 * s] - a2 * z[2 * s + 1]
        g = b0 * go + b1 * z[2 * s] + b2 * z[2 * s + 1]
        z[2 * s], z[2 * s + 1] = go, z[2 * s]
    return g, z


def _df2t_coefficients(ba):
    """(b, a) as lists of float64 [R, 1] columns."""
    ba = ba.double()
    n = ba.shape[1] // 2
    return ([ba[:, i, None] for i in range(n)],
            [ba[:, n + i, None] for i in range(n)])


def _df2t_step(c, z, u):
    # y = b0*x + z0; z_i = z_{i+1} + b_{i+1}*x - a_{i+1}*y (z_N = 0)
    b, a = c
    n = len(z)
    out = b[0] * u + z[0]
    z = [(z[i + 1] + b[i + 1] * u if i + 1 < n else b[i + 1] * u)
         - a[i + 1] * out for i in range(n)]
    return out, z


def _df2t_adjoint_step(c, z, g):
    # the cotangent of y, then of x; the state's cotangent shifts up by one
    # with d y in front
    b, a = c
    n = len(z)
    for i in range(n):
        g = g - a[i + 1] * z[i]
    gu = b[0] * g
    for i in range(n):
        gu = gu + b[i + 1] * z[i]
    return gu, [g] + z[:-1]


# ----------------------------------------------------------- blocked scan
def _walk(step, c, state, xb, start=None):
    """Walk the blocks: state (components [R, X]) through xb [R, X, L]'s
    steps -> (outputs [R, X, L], end state). `start` = (j, init): block
    0's state is replaced by init (components [R]) at its step j."""
    out = torch.empty_like(xb)
    for j in range(xb.shape[-1]):
        if start is not None and j == start[0]:
            state = [torch.cat([v[:, None], s[:, 1:]], dim=1)
                     for s, v in zip(state, start[1])]
        out[:, :, j], state = step(c, state, xb[:, :, j])
    return out, state


def _matmul(a, b):
    """a @ b for [R, n, n] float64, each entry's sum in index order."""
    n = a.shape[-1]
    acc = a[:, :, 0, None] * b[:, None, 0, :]
    for m in range(1, n):
        acc = acc + a[:, :, m, None] * b[:, None, m, :]
    return acc


def _apply(q, e):
    """q e for q [R, n, n] and states e [R, X, n], each entry's sum in
    index order."""
    acc = q[:, None, :, 0] * e[:, :, 0, None]
    for m in range(1, q.shape[-1]):
        acc = acc + q[:, None, :, m] * e[:, :, m, None]
    return acc


def _blocked(step, c, x, init, reverse: bool):
    """The blocked scan of one recurrence over rows x [R, T] from the
    initial state `init` (float64 components [R]) -> (outputs [R, T] in
    x's dtype, the end state [R, n] in float64). `reverse` walks time
    backwards."""
    rows, steps = x.shape
    n = len(init)
    if steps == 0:
        return x.clone(), torch.stack(init, dim=1)
    block, blocks = partition(steps)
    pad = block * blocks - steps
    xw = x.flip(-1) if reverse else x
    xb = F.pad(xw.double(), (pad, 0)).reshape(rows, blocks, block)
    zero = torch.zeros((rows, blocks), dtype=torch.float64, device=x.device)

    # 1. local pass from the zero state (block 0 from init)
    _, ends = _walk(step, c, [zero] * n, xb, (pad, init))
    e = torch.stack(ends, dim=-1)                          # [R, P, n]
    # 2. combine: Phi from the unit states' L zero-input steps
    if blocks > 1:
        eye = torch.eye(n, dtype=torch.float64, device=x.device)
        units = [eye[i].expand(rows, n) for i in range(n)]
        _, cols = _walk(step, c, units,
                        xb.new_zeros((rows, n, block)))
        q = torch.stack(cols, dim=1)                       # [R, n, n]
        d = 1
        while d < blocks:
            e = torch.cat([e[:, :d], e[:, d:] + _apply(q, e[:, :-d])],
                          dim=1)
            d *= 2
            if d < blocks:
                q = _matmul(q, q)
    # 3. replay from each block's entry state
    entry = torch.cat([torch.zeros_like(e[:, :1]), e[:, :-1]], dim=1)
    y, _ = _walk(step, c, list(entry.unbind(-1)), xb, (pad, init))
    y = y.reshape(rows, -1)[:, pad:]
    y = y.flip(-1) if reverse else y
    return y.to(x.dtype).contiguous(), e[:, -1]


def sos_scan_plain(x, sos, zi):
    """The biquad cascade over rows x [R, T] -> y [R, T]: JAX's step, as
    the blocked scan in float64, rounded once to x's dtype."""
    init = list(zi.double().reshape(zi.shape[0], -1).unbind(-1))
    y, _ = _blocked(_sos_step, _sos_coefficients(sos), x, init, False)
    return y


def sos_adjoint_plain(gy, sos):
    """The cotangents (gx [R, T], gzi [R, S, 2]) of sos_scan for the
    cotangent gy of its output: the transposed recursion from the zero
    state in reverse time, as the blocked scan in float64, rounded once
    to gy's dtype."""
    zero = gy.new_zeros(gy.shape[0], dtype=torch.float64)
    gx, end = _blocked(_sos_adjoint_step, _sos_coefficients(sos), gy,
                       [zero] * (2 * sos.shape[1]), True)
    return gx, end.reshape(-1, sos.shape[1], 2).to(gy.dtype)


def df2t_scan_plain(x, ba, zi):
    """Direct form II transposed over rows x [R, T] -> y [R, T]: JAX's
    step, as the blocked scan in float64, rounded once to x's dtype."""
    init = list(zi.double().unbind(-1))
    y, _ = _blocked(_df2t_step, _df2t_coefficients(ba), x, init, False)
    return y


def df2t_adjoint_plain(gy, ba):
    """The cotangents (gx [R, T], gzi [R, N]) of df2t_scan for the
    cotangent gy of its output, as the blocked scan in float64 in reverse
    time, rounded once to gy's dtype."""
    order = (ba.shape[1] - 2) // 2
    zero = gy.new_zeros(gy.shape[0], dtype=torch.float64)
    gx, end = _blocked(_df2t_adjoint_step, _df2t_coefficients(ba), gy,
                       [zero] * order, True)
    return gx, end.to(gy.dtype)


# -------------------------------------------------------------------- kernel
def _launch(entry: str, ptrs, size: int, x):
    from .lstm import _launch as launch

    rows, length = x.shape
    block, blocks = partition(length)
    launch(LIBRARY, getattr(_build.load(LIBRARY), entry), len(ptrs), 6,
           [0 if t is None else t.data_ptr() for t in ptrs]
           + [rows, length, size, _KERNEL_DTYPES[x.dtype], block, blocks],
           x.device)


def _check_kernel_args(x, coef, size: int, limit: int, what: str):
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the IIR scan kernel takes f32 or f64, got "
                        f"{x.dtype}")
    if not 1 <= size <= limit:
        raise ValueError(f"the IIR scan kernel takes 1 to {limit} {what}, "
                         f"got {size}")
    if x.shape[1] < 1:
        raise ValueError("the IIR scan kernel takes at least one step")
    if coef.device != x.device:
        raise ValueError(f"coefficients on {coef.device}, input on "
                         f"{x.device}")


def _sos_forward(x, sos, zi):
    global launch_count
    if _use_plain(x):
        return sos_scan_plain(x, sos, zi)
    _check_kernel_args(x, sos, sos.shape[1], MAX_SECTIONS, "sections")
    x, sos, zi = (t.contiguous() for t in (x, sos, zi))
    y = torch.empty_like(x)
    _launch("iir_sos_forward", (x, sos, zi, y, None), sos.shape[1], x)
    launch_count += 1
    return y


def _sos_adjoint(gy, sos):
    global adjoint_launch_count
    if _use_plain(gy):
        return sos_adjoint_plain(gy, sos)
    _check_kernel_args(gy, sos, sos.shape[1], MAX_SECTIONS, "sections")
    gy, sos = gy.contiguous(), sos.contiguous()
    gx = torch.empty_like(gy)
    gzi = torch.empty((gy.shape[0], sos.shape[1], 2), dtype=gy.dtype,
                      device=gy.device)
    _launch("iir_sos_adjoint", (gy, sos, None, gx, gzi), sos.shape[1], gy)
    adjoint_launch_count += 1
    return gx, gzi


def _df2t_forward(x, ba, zi):
    global launch_count
    if _use_plain(x):
        return df2t_scan_plain(x, ba, zi)
    _check_kernel_args(x, ba, zi.shape[1], MAX_ORDER, "orders")
    x, ba, zi = (t.contiguous() for t in (x, ba, zi))
    y = torch.empty_like(x)
    _launch("iir_df2t_forward", (x, ba, zi, y, None), zi.shape[1], x)
    launch_count += 1
    return y


def _df2t_adjoint(gy, ba):
    global adjoint_launch_count
    if _use_plain(gy):
        return df2t_adjoint_plain(gy, ba)
    order = (ba.shape[1] - 2) // 2
    _check_kernel_args(gy, ba, order, MAX_ORDER, "orders")
    gy, ba = gy.contiguous(), ba.contiguous()
    gx = torch.empty_like(gy)
    gzi = torch.empty((gy.shape[0], order), dtype=gy.dtype,
                      device=gy.device)
    _launch("iir_df2t_adjoint", (gy, ba, None, gx, gzi), order, gy)
    adjoint_launch_count += 1
    return gx, gzi


class SOSScan(torch.autograd.Function):
    """sos_scan with the adjoint walk as its backward (gradients of x and
    the initial state)."""

    @staticmethod
    def forward(ctx, x, sos, zi):
        ctx.save_for_backward(sos)
        return _sos_forward(x, sos, zi)

    @staticmethod
    def backward(ctx, gy):
        (sos,) = ctx.saved_tensors
        gx, gzi = _sos_adjoint(gy, sos)
        return gx, None, gzi


class DF2TScan(torch.autograd.Function):
    """df2t_scan with the adjoint walk as its backward."""

    @staticmethod
    def forward(ctx, x, ba, zi):
        ctx.save_for_backward(ba)
        return _df2t_forward(x, ba, zi)

    @staticmethod
    def backward(ctx, gy):
        (ba,) = ctx.saved_tensors
        gx, gzi = _df2t_adjoint(gy, ba)
        return gx, None, gzi


def _no_coefficient_grad(coef):
    if coef.requires_grad:
        raise ValueError("the IIR scans are differentiable in the input and "
                         "the initial state, not in the coefficients")


def sos_scan(x, sos, zi):
    """Biquad cascade over rows x [R, T] with per-row sos [R, S, 6] and zi
    [R, S, 2] -> y [R, T]."""
    _no_coefficient_grad(sos)
    return SOSScan.apply(x, sos, zi)


def df2t_scan(x, ba, zi):
    """Direct form II transposed over rows x [R, T] with per-row ba
    [R, 2 (N + 1)] and zi [R, N] -> y [R, T]."""
    _no_coefficient_grad(ba)
    return DF2TScan.apply(x, ba, zi)
