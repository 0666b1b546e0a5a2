"""Unidirectional LSTM: one projection GEMM, then the recurrence.

Counterpart of ml_audio_restoration_tpu/ops/lstm.py. The input projection
`x @ W_ih + b_ih + b_hh` runs as one matrix product that emits time-major
gates [T, B, 4H]; the recurrence over those gates is the hand-written CUDA
kernel csrc/lstm_recurrence.cu on a CUDA tensor, and the plain loop
`lstm_recurrence_plain` on a CPU tensor. Gate order is torch's (i, f, g, o).

Parameter dicts use the JAX package's layout: w_ih [C, 4H], w_hh [H, 4H],
b_ih and b_hh [4H].
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build

# Launches of the CUDA recurrence kernel since the last reset; the launch
# site adds one, and nothing else touches it but reset_launch_count.
launch_count = 0
_force_plain = False


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


@contextlib.contextmanager
def plain_recurrence():
    """Test hook: inside this block `lstm_recurrence` runs the plain loop
    even on a CUDA tensor, so a check can hold the whole pipeline's kernel
    run against a plain run on the same card."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def lstm_recurrence_plain(gates_tm, w_hh, h0, c0):
    """Reference recurrence, a Python loop over T.

    gates_tm [T, B, 4H] (f32 or bf16), w_hh [H, 4H], h0/c0 [B, H]
    -> (out [B, T, H] in the gates' dtype, hf [B, H] f32, cf [B, H] f32).

    Same arithmetic as the kernel: h is rounded to the gates' dtype before
    the product, which accumulates in f32; h and c stay f32."""
    t_len, b, g4 = gates_tm.shape
    hid = g4 // 4
    dtype = gates_tm.dtype
    w = w_hh.to(dtype).float()
    h = h0.float()
    c = c0.float()
    out = torch.empty((b, t_len, hid), dtype=dtype, device=gates_tm.device)
    for t in range(t_len):
        a = gates_tm[t].float() + h.to(dtype).float() @ w
        i = torch.sigmoid(a[:, :hid])
        f = torch.sigmoid(a[:, hid:2 * hid])
        g = torch.tanh(a[:, 2 * hid:3 * hid])
        o = torch.sigmoid(a[:, 3 * hid:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        out[:, t] = h.to(dtype)
    return out, h, c


_KERNEL_HIDDEN = (16, 32, 64)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lstm_recurrence_cuda(gates_tm, w_hh, h0, c0):
    global launch_count
    t_len, b, g4 = gates_tm.shape
    hid = g4 // 4
    if gates_tm.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"CUDA recurrence takes f32 or bf16 gates, got "
                        f"{gates_tm.dtype}")
    if hid not in _KERNEL_HIDDEN or g4 != 4 * hid:
        raise ValueError(f"CUDA recurrence supports H in {_KERNEL_HIDDEN}, "
                         f"got gates width {g4}")
    if tuple(w_hh.shape) != (hid, g4):
        raise ValueError(f"w_hh must be [{hid}, {g4}], got {tuple(w_hh.shape)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if tuple(s.shape) != (b, hid):
            raise ValueError(f"{name} must be [{b}, {hid}], got "
                             f"{tuple(s.shape)}")
    dev = gates_tm.device
    for name, x in (("w_hh", w_hh), ("h0", h0), ("c0", c0)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, gates on {dev}")
    gx = gates_tm.contiguous()
    w = w_hh.to(gx.dtype).contiguous()
    h0 = h0.float().contiguous()
    c0 = c0.float().contiguous()
    out = torch.empty((b, t_len, hid), dtype=gx.dtype, device=dev)
    hf = torch.empty((b, hid), dtype=torch.float32, device=dev)
    cf = torch.empty((b, hid), dtype=torch.float32, device=dev)
    fn = _build.load("lstm_recurrence").lstm_recurrence
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gx.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                 out.data_ptr(), hf.data_ptr(), cf.data_ptr(), t_len, b, hid,
                 _KERNEL_DTYPES[gx.dtype], stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    return out, hf, cf


def lstm_recurrence(gates_tm, w_hh, h0, c0):
    """The recurrence over time-major gates: the CUDA kernel for a CUDA
    tensor, the plain loop for a CPU tensor. No fallback: a CUDA tensor the
    kernel cannot take raises. Shapes as `lstm_recurrence_plain`."""
    if gates_tm.device.type == "cpu" or _force_plain:
        return lstm_recurrence_plain(gates_tm, w_hh, h0, c0)
    if gates_tm.device.type != "cuda":
        raise ValueError(f"no recurrence for device {gates_tm.device}")
    return _lstm_recurrence_cuda(gates_tm, w_hh, h0, c0)


def lstm(x, params, *, carry=None, return_carry: bool = False):
    """Single-layer LSTM over batch-major x [B, T, C] -> [B, T, H].

    The projection emits TIME-MAJOR gates [T, B, 4H], the layout the
    recurrence streams. The state starts at zero unless `carry` = (h, c)."""
    b, t_len, c_in = x.shape
    bias = params["b_ih"] + params["b_hh"]
    # one GEMM with the bias fused; its [T*B, 4H] result is already the
    # contiguous time-major layout the kernel reads
    gates_tm = torch.addmm(bias, x.transpose(0, 1).reshape(t_len * b, c_in),
                           params["w_ih"]).view(t_len, b, -1)
    w_hh = params["w_hh"]
    hid = w_hh.shape[0]
    if carry is None:
        h0 = torch.zeros((b, hid), dtype=torch.float32, device=x.device)
        c0 = torch.zeros_like(h0)
    else:
        h0, c0 = carry
    out, hf, cf = lstm_recurrence(gates_tm, w_hh, h0.float(), c0.float())
    out = out.to(x.dtype)
    if return_carry:
        return out, (hf.to(x.dtype), cf.to(x.dtype))
    return out


def stacked_lstm(x, layers, *, carries=None, return_carries: bool = False):
    """Multi-layer LSTM: each layer's [B, T, H] output feeds the next.
    `layers`: per-layer param dicts; `carries`: optional per-layer (h, c)."""
    new_carries = []
    for i, params in enumerate(layers):
        carry = carries[i] if carries is not None else None
        if return_carries:
            x, c = lstm(x, params, carry=carry, return_carry=True)
            new_carries.append(c)
        else:
            x = lstm(x, params, carry=carry)
    return (x, new_carries) if return_carries else x
