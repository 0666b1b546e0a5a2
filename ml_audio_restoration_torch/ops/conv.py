"""1-D convolution primitives and batch norm, in torch's NCW layout.

Counterpart of ml_audio_restoration_tpu/ops/conv.py, which works in NWC with
[k, in, out] kernels. Here tensors are [batch, channels, time] and weights
keep torch's layouts: Conv1d [out, in, k], ConvTranspose1d [in, out, k] in
torch's kernel order (torch flips nothing; the JAX side flips the kernel
itself, so the port must not). These calls go to ATen and cuDNN.

The eval convolutions' epilogue, act(y + b[c] (+ r)), is one hand-written
pass in place on the conv's output (csrc/conv_epilogue.cu), where ATen
would run the bias add, the residual add and F.leaky_relu as separate
passes. `conv1d_epilogue` and `conv_transpose1d_epilogue` take it where
no gradient is wanted on a CUDA tensor: cuDNN's convolution without its
bias, then `conv_epilogue`; bit for bit ATen's ops, which round the same
way. The kernel takes NCW, so an output (or residual) in another layout
is copied to it first: cuDNN hands back the output of an input whose
strides read as channels-last, such as the trainer's [B, T, 1] batch
transposed to [B, 1, T], with C innermost. Elsewhere (a CPU tensor, where ATen folds the bias into the conv's
sum; under grad; inside `aten_epilogue()`) they run ATen's ops as before.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..parallel import distributed as dist
from . import _build

LIBRARY = "conv_epilogue"
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of csrc/conv_epilogue.cu since the last reset: the launch site
# adds one, and nothing else touches it but reset_epilogue_launch_count.
epilogue_launch_count = 0
_force_aten = False


def reset_epilogue_launch_count() -> None:
    global epilogue_launch_count
    epilogue_launch_count = 0


@contextlib.contextmanager
def aten_epilogue():
    """Test hook: inside this block the eval convolutions on a CUDA tensor
    run ATen's ops as before (the conv with its bias, the residual add,
    F.leaky_relu), so a check can hold the kernel's route against ATen's
    on the same card."""
    global _force_aten
    prev, _force_aten = _force_aten, True
    try:
        yield
    finally:
        _force_aten = prev


def conv1d(x, w, b=None, *, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1):
    """x [B, Cin, T], w [Cout, Cin // groups, K] -> [B, Cout, T_out]."""
    return F.conv1d(x, w, b, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def conv_transpose1d(x, w, b=None, *, stride: int = 2, padding: int = 0):
    """x [B, Cin, T], w [Cin, Cout, K] -> [B, Cout, (T-1)*stride - 2p + K]."""
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding)


def conv_epilogue_plain(y, b, residual=None, *, lrelu: bool = False):
    """act(y + b[c] (+ residual)) in place on y [B, C, T], as ATen's
    separate ops round it: the cuDNN backend's `add_` of the bias, the
    residual add, then F.leaky_relu(0.2). Returns y."""
    y.add_(b.view(1, -1, 1))
    if residual is not None:
        y.add_(residual)
    return F.leaky_relu(y, 0.2, inplace=True) if lrelu else y


def _check_epilogue_args(y, b, residual):
    """Raise on what csrc/conv_epilogue.cu does not take."""
    if y.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the conv epilogue takes f32 or bf16, got {y.dtype}")
    if y.dim() != 3 or not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError("the conv epilogue takes a contiguous [B, C, T] "
                         "output starting on 16 bytes, got shape "
                         f"{tuple(y.shape)} strides {y.stride()}")
    if (tuple(b.shape) != (y.shape[1],) or b.dtype != y.dtype
            or b.device != y.device):
        raise ValueError(f"bias must be [{y.shape[1]}] {y.dtype} on "
                         f"{y.device}, got {tuple(b.shape)} {b.dtype} on "
                         f"{b.device}")
    if residual is not None and (
            residual.shape != y.shape or residual.dtype != y.dtype
            or residual.device != y.device or not residual.is_contiguous()
            or residual.data_ptr() % 16):
        raise ValueError("the residual must be a contiguous tensor of the "
                         "output's shape, type and device starting on 16 "
                         f"bytes, got {tuple(residual.shape)} "
                         f"{residual.dtype} strides {residual.stride()}")


def conv_epilogue(y, b, residual=None, *, lrelu: bool = False):
    """act(y + b[c] (+ residual)) in place on a conv's output y [B, C, T];
    returns y. One launch of csrc/conv_epilogue.cu for a CUDA tensor, the
    plain version for a CPU tensor. No fallback: a CUDA tensor the kernel
    does not take raises."""
    global epilogue_launch_count
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, b, residual, lrelu=lrelu)
    if y.device.type != "cuda":
        raise ValueError(f"no conv epilogue for device {y.device}")
    _check_epilogue_args(y, b, residual)
    from .lstm import _launch

    bsz, c, t = y.shape
    b = b.contiguous()
    _launch(LIBRARY, _build.load(LIBRARY).conv_epilogue, 3, 5,
            [y.data_ptr(), b.data_ptr(),
             0 if residual is None else residual.data_ptr(),
             bsz * c, t, c, int(lrelu), _KERNEL_DTYPES[y.dtype]], y.device)
    epilogue_launch_count += 1
    return y


def _grad_wanted(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _takes_epilogue(*tensors) -> bool:
    """The kernel's route: a CUDA tensor, no gradient wanted (grad mode off
    or no input requiring grad) and not inside aten_epilogue()."""
    return (tensors[0].device.type == "cuda" and not _force_aten
            and not _grad_wanted(*tensors))


def _aten_epilogue(y, residual, lrelu: bool):
    """The route's ATen form, out of place, on an output whose bias the
    conv already added: under grad autograd needs y unchanged, and on the
    CPU ATen folds the bias into the conv's sum, which rounds otherwise
    than `conv_epilogue_plain`'s add after it (the card's unfused order,
    in place, the kernel's reference)."""
    if residual is not None:
        y = y + residual
    return leaky_relu(y) if lrelu else y


def conv1d_epilogue(x, w, b, *, residual=None, lrelu: bool = False,
                    padding: int = 0, dilation: int = 1):
    """act(conv1d(x, w, b) (+ residual)): the conv without its bias, then
    conv_epilogue where no gradient is wanted on a CUDA tensor; otherwise
    ATen's ops (module docstring)."""
    if _takes_epilogue(x, w, b, residual):
        y = conv1d(x, w, padding=padding, dilation=dilation).contiguous()
        return conv_epilogue(y, b, None if residual is None
                             else residual.contiguous(), lrelu=lrelu)
    return _aten_epilogue(conv1d(x, w, b, padding=padding, dilation=dilation),
                          residual, lrelu)


def conv_transpose1d_epilogue(x, w, b, *, lrelu: bool = False,
                              stride: int = 2, padding: int = 0):
    """act(conv_transpose1d(x, w, b)), routed as conv1d_epilogue."""
    if _takes_epilogue(x, w, b):
        y = conv_transpose1d(x, w, stride=stride, padding=padding)
        return conv_epilogue(y.contiguous(), b, lrelu=lrelu)
    return _aten_epilogue(conv_transpose1d(x, w, b, stride=stride,
                                           padding=padding), None, lrelu)


def max_pool1d(x, *, window: int = 2, stride: int = 2):
    """Floor-mode max pool: [B, C, T] -> [B, C, T // stride]."""
    return F.max_pool1d(x, window, stride, ceil_mode=False)


def moving_average(x, kernel_size: int):
    """Box filter with zero 'same' padding on [B, 1, T]."""
    w = torch.ones((1, 1, kernel_size), dtype=x.dtype,
                   device=x.device) / kernel_size
    return F.conv1d(x, w, padding=kernel_size // 2)


def leaky_relu(x, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)


def batch_norm(x, scale, bias, mean, var, *, eps: float = 1e-5):
    """Inference-mode batch norm over the channel axis of [B, C, T]."""
    inv = torch.rsqrt(var + eps)
    return ((x - mean[:, None]) * inv[:, None] * scale[:, None]
            + bias[:, None])


def batch_norm_train(x, scale, bias, running_mean, running_var, *,
                     eps: float = 1e-5, momentum: float = 0.1):
    """Training-mode batch norm over the channel axis of [B, C, T].

    Normalizes by the batch statistics and returns (y, new_mean, new_var)
    with torch's momentum convention, running <- (1-m)*running + m*batch,
    the running variance unbiased with n = B*T. As in the JAX package, the
    statistics are computed in at least f32 (a bf16 x in f32, an f64 x in
    f64), as E[x^2] - E[x]^2 clamped at 0 (in bf16 that difference can go
    negative and turn the forward NaN), and y comes back in x's dtype. The
    new running statistics carry no gradient.

    Inside a data-parallel train step (parallel.distributed.global_batch)
    the statistics are the global batch's: every rank holds B items of
    the same T, so E[x] and E[x^2] are the means over the ranks of the
    local ones (one differentiable all-reduce) and n = B*T*ranks."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    n = x.shape[0] * x.shape[2]
    m = xf.mean(dim=(0, 2))
    sq = xf.square().mean(dim=(0, 2))
    if dist.in_global_batch():
        m, sq = dist.mean_over_ranks(torch.stack([m, sq])).unbind(0)
        n *= dist.process_count()
    v = torch.clamp(sq - m.square(), min=0.0)
    k = torch.rsqrt(v + eps) * scale.to(xf.dtype)
    y = torch.addcmul(bias.to(xf.dtype)[:, None], xf - m[:, None],
                      k[:, None]).to(x.dtype)
    with torch.no_grad():
        unbiased = v * (n / max(n - 1, 1))
        new_mean = ((1 - momentum) * running_mean
                    + momentum * m.to(running_mean.dtype))
        new_var = ((1 - momentum) * running_var
                   + momentum * unbiased.to(running_var.dtype))
    return y, new_mean, new_var
