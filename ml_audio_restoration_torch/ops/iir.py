"""IIR scans over time: the biquad cascade and direct form II transposed.

Counterpart of the `lax.scan`s inside ml_audio_restoration_tpu/ops/
filters.py::sosfilt and ::lfilter. A scan takes rows [R, T], each with its
own coefficients and initial state, and walks time:
- `sos_scan(x, sos, zi)`: sos [R, S, 6], zi [R, S, 2], S <= 4 sections;
- `df2t_scan(x, ba, zi)`: ba [R, 2 (N + 1)] (b then a, a[0] = 1), zi
  [R, N], order N <= 8.
Both are differentiable in x and in the initial state (not in the
coefficients, as JAX's callers never need): the backward pass is the
adjoint recurrence walked in reverse time, which needs nothing of the
forward walk because the filters are linear. The adjoint runs in float64
for any data type and rounds once: the transposed recursion of a pole near
the unit circle (the 100 Hz rumble low-pass) carries a state far above its
output, and in f32 its gradient strayed 2e-5 to 7e-5 of its peak from the
float64 one (JAX's scan transpose, with XLA's fused operations, 0.5e-5 to
0.9e-5).

On a CUDA tensor each walk is one launch of csrc/iir_scan.cu (one thread a
row, f32 or f64); on a CPU tensor it is the plain version here, the same
step as a Python loop over time (`sos_scan_plain` and `df2t_scan_plain`,
which take a tensor on any device). The kernel is built with -fmad=false
and takes the steps' operations in the plain versions' order, so the two
agree bit for bit. No fallback: a CUDA tensor the kernel
cannot take raises.
"""
from __future__ import annotations

import torch

from . import _build

LIBRARY = "iir_scan"
MAX_SECTIONS = 4
MAX_ORDER = 8
_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}

# Launches since the last reset: forward walks (launch_count) and adjoint
# walks (adjoint_launch_count). Each launch site adds one; nothing else
# touches them but reset_launch_count.
launch_count = 0
adjoint_launch_count = 0


def reset_launch_count() -> None:
    global launch_count, adjoint_launch_count
    launch_count = adjoint_launch_count = 0


def _use_plain(x) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no IIR scan for device {x.device}")
    return False


# ------------------------------------------------------------ plain versions
def sos_scan_plain(x, sos, zi):
    """The biquad cascade over rows x [R, T] -> y [R, T]: JAX's step
    (out = b0*y + z0; z0 = b1*y - a1*out + z1; z1 = b2*y - a2*out), in its
    operation order, as a loop over T."""
    c = [[sos[:, s, i].contiguous() for i in range(6)]
         for s in range(sos.shape[1])]
    z0 = [zi[:, s, 0] for s in range(sos.shape[1])]
    z1 = [zi[:, s, 1] for s in range(sos.shape[1])]
    xt = x.t().contiguous()
    y = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        u = xt[t]
        for s, (b0, b1, b2, _, a1, a2) in enumerate(c):
            out = b0 * u + z0[s]
            z0[s], z1[s] = b1 * u - a1 * out + z1[s], b2 * u - a2 * out
            u = out
        y[t] = u
    return y.t().contiguous()


def sos_adjoint_plain(gy, sos):
    """The cotangents (gx [R, T], gzi [R, S, 2]) of sos_scan for the
    cotangent gy of its output, walked in reverse time in float64 (the
    transposed recursion's state grows far above its output for a pole near
    the unit circle) and rounded once to gy's dtype."""
    n = sos.shape[1]
    sos = sos.double()
    c = [[sos[:, s, i].contiguous() for i in range(6)] for s in range(n)]
    zero = torch.zeros(gy.shape[0], dtype=torch.float64, device=gy.device)
    l0, l1 = [zero] * n, [zero] * n
    gt = gy.t().double().contiguous()
    gx = torch.empty_like(gt)
    for t in range(gt.shape[0] - 1, -1, -1):
        g = gt[t]
        for s in range(n - 1, -1, -1):
            b0, b1, b2, _, a1, a2 = c[s]
            go = g - a1 * l0[s] - a2 * l1[s]
            g = b0 * go + b1 * l0[s] + b2 * l1[s]
            l0[s], l1[s] = go, l0[s]
        gx[t] = g
    gzi = torch.stack([torch.stack(pair, dim=-1)
                       for pair in zip(l0, l1)], dim=1)
    return gx.t().to(gy.dtype).contiguous(), gzi.to(gy.dtype)


def df2t_scan_plain(x, ba, zi):
    """Direct form II transposed over rows x [R, T] -> y [R, T]: JAX's step
    (y = b0*x + z0; z_i = z_{i+1} + b_{i+1}*x - a_{i+1}*y, z_N = 0), in its
    operation order, as a loop over T."""
    order = zi.shape[1]
    b = [ba[:, i].contiguous() for i in range(order + 1)]
    a = [ba[:, order + 1 + i].contiguous() for i in range(order + 1)]
    z = [zi[:, i] for i in range(order)]
    zero = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    xt = x.t().contiguous()
    y = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        u = xt[t]
        out = b[0] * u + z[0]
        z = [(z[i + 1] if i + 1 < order else zero) + b[i + 1] * u
             - a[i + 1] * out for i in range(order)]
        y[t] = out
    return y.t().contiguous()


def df2t_adjoint_plain(gy, ba):
    """The cotangents (gx [R, T], gzi [R, N]) of df2t_scan for the
    cotangent gy of its output, walked in reverse time in float64 and
    rounded once to gy's dtype."""
    order = (ba.shape[1] - 2) // 2
    ba = ba.double()
    b = [ba[:, i].contiguous() for i in range(order + 1)]
    a = [ba[:, order + 1 + i].contiguous() for i in range(order + 1)]
    lam = [torch.zeros(gy.shape[0], dtype=torch.float64, device=gy.device)
           for _ in range(order)]
    gt = gy.t().double().contiguous()
    gx = torch.empty_like(gt)
    for t in range(gt.shape[0] - 1, -1, -1):
        g = gt[t]
        for i in range(order):
            g = g - a[i + 1] * lam[i]
        gu = b[0] * g
        for i in range(order):
            gu = gu + b[i + 1] * lam[i]
        lam = [g] + lam[:-1]
        gx[t] = gu
    return (gx.t().to(gy.dtype).contiguous(),
            torch.stack(lam, dim=1).to(gy.dtype))


# -------------------------------------------------------------------- kernel
def _launch(entry: str, ptrs, size: int, x):
    from .lstm import _launch as launch

    rows, length = x.shape
    launch(LIBRARY, getattr(_build.load(LIBRARY), entry), len(ptrs), 4,
           [t.data_ptr() for t in ptrs]
           + [rows, length, size, _KERNEL_DTYPES[x.dtype]], x.device)


def _check_kernel_args(x, coef, size: int, limit: int, what: str):
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the IIR scan kernel takes f32 or f64, got "
                        f"{x.dtype}")
    if not 1 <= size <= limit:
        raise ValueError(f"the IIR scan kernel takes 1 to {limit} {what}, "
                         f"got {size}")
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
    _launch("iir_sos_forward", (x, sos, zi, y), sos.shape[1], x)
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
    _launch("iir_sos_adjoint", (gy, sos, gx, gzi), sos.shape[1], gy)
    adjoint_launch_count += 1
    return gx, gzi


def _df2t_forward(x, ba, zi):
    global launch_count
    if _use_plain(x):
        return df2t_scan_plain(x, ba, zi)
    _check_kernel_args(x, ba, zi.shape[1], MAX_ORDER, "orders")
    x, ba, zi = (t.contiguous() for t in (x, ba, zi))
    y = torch.empty_like(x)
    _launch("iir_df2t_forward", (x, ba, zi, y), zi.shape[1], x)
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
    _launch("iir_df2t_adjoint", (gy, ba, gx, gzi), order, gy)
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
