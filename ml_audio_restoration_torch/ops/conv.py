"""1-D convolution primitives and batch norm, in torch's NCW layout.

Counterpart of ml_audio_restoration_tpu/ops/conv.py, which works in NWC with
[k, in, out] kernels. Here tensors are [batch, channels, time] and weights
keep torch's layouts: Conv1d [out, in, k], ConvTranspose1d [in, out, k] in
torch's kernel order (torch flips nothing; the JAX side flips the kernel
itself, so the port must not). These calls go to ATen and cuDNN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import distributed as dist


def conv1d(x, w, b=None, *, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1):
    """x [B, Cin, T], w [Cout, Cin // groups, K] -> [B, Cout, T_out]."""
    return F.conv1d(x, w, b, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def conv_transpose1d(x, w, b=None, *, stride: int = 2, padding: int = 0):
    """x [B, Cin, T], w [Cin, Cout, K] -> [B, Cout, (T-1)*stride - 2p + K]."""
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding)


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
