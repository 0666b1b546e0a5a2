"""Unidirectional LSTM: one projection GEMM, then the recurrence.

Counterpart of ml_audio_restoration_tpu/ops/lstm.py. The input projection
`x @ W_ih + b_ih + b_hh` runs as one matrix product that emits time-major
gates [T, B, 4H]; the recurrence over those gates is a hand-written CUDA
kernel on a CUDA tensor and a plain PyTorch loop on a CPU tensor. Gate
order is torch's (i, f, g, o).

Two routes, as in the JAX package:
- inference (no gradient wanted): K1, csrc/lstm_recurrence.cu, beside
  `lstm_recurrence_plain`;
- training (grad enabled and an input requires grad): K2 forward and K3
  backward (csrc/lstm_train.cu), beside `lstm_recurrence_train_plain` and
  `lstm_recurrence_bwd_plain`, in f32 whatever the gates' dtype. `lstm`
  trains through the autograd Function `LSTMTrain`, which owns the
  projection too, so the f32 gate cotangent reaches the projection's
  backward as it does in JAX (see there); `lstm_recurrence` takes gates
  already projected through `LSTMRecurrenceTrain`.

Parameter dicts use the JAX package's layout: w_ih [C, 4H], w_hh [H, 4H],
b_ih and b_hh [4H].
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build

# Launches since the last reset, one count per kernel: K1 (launch_count),
# K2 (train_fwd_launch_count) and K3 (train_bwd_launch_count). Each launch
# site adds one, and nothing else touches them but reset_launch_count.
launch_count = 0
train_fwd_launch_count = 0
train_bwd_launch_count = 0
_force_plain = False


def reset_launch_count() -> None:
    global launch_count, train_fwd_launch_count, train_bwd_launch_count
    launch_count = train_fwd_launch_count = train_bwd_launch_count = 0


@contextlib.contextmanager
def plain_recurrence():
    """Test hook: inside this block the recurrence runs its plain versions
    even on a CUDA tensor (K1's, and K2's and K3's for a training forward
    started inside the block), so a check can hold a kernel run against a
    plain run on the same card."""
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


def _check_kernel_args(kernel: str, gates_tm, w_hh, h0, c0):
    """Raise on what the recurrence kernels do not take."""
    t_len, b, g4 = gates_tm.shape
    hid = g4 // 4
    if gates_tm.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{kernel} takes f32 or bf16 gates, got "
                        f"{gates_tm.dtype}")
    if hid not in _KERNEL_HIDDEN or g4 != 4 * hid:
        raise ValueError(f"{kernel} supports H in {_KERNEL_HIDDEN}, got "
                         f"gates width {g4}")
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


def _contiguous16(x):
    """x contiguous and starting on a 16-byte boundary: the kernels copy
    their per-step rows into shared memory 16 bytes at a time (cp.async),
    so a view that starts elsewhere is copied to a fresh tensor."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(kernel: str, fn, n_ptrs: int, n_ints: int, args, dev) -> None:
    """Call a C entry point of csrc/ on the current stream of `dev`: n_ptrs
    pointers, then n_ints ints, then the stream. Raises on a non-zero
    cudaError_t."""
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def _lstm_recurrence_cuda(gates_tm, w_hh, h0, c0):
    global launch_count
    _check_kernel_args("CUDA recurrence", gates_tm, w_hh, h0, c0)
    t_len, b, g4 = gates_tm.shape
    hid = g4 // 4
    dev = gates_tm.device
    gx = _contiguous16(gates_tm)
    w = w_hh.to(gx.dtype).contiguous()
    h0 = h0.float().contiguous()
    c0 = c0.float().contiguous()
    out = torch.empty((b, t_len, hid), dtype=gx.dtype, device=dev)
    hf = torch.empty((b, hid), dtype=torch.float32, device=dev)
    cf = torch.empty((b, hid), dtype=torch.float32, device=dev)
    _launch("lstm_recurrence", _build.load("lstm_recurrence").lstm_recurrence,
            7, 4, [gx.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                   out.data_ptr(), hf.data_ptr(), cf.data_ptr(), t_len, b,
                   hid, _KERNEL_DTYPES[gx.dtype]], dev)
    launch_count += 1
    return out, hf, cf


def recurrence_resources(hidden: int, dtype=torch.float32,
                         device="cuda") -> dict:
    """K1's resources on the card for (hidden, dtype): registers a thread,
    static shared bytes a CTA and CTAs an SM (the occupancy API), with the
    card's SM count. A launch of B rows takes ceil(B / (ctas_per_sm * sms))
    waves."""
    info = (ctypes.c_int * 3)()
    fn = _build.load("lstm_recurrence").lstm_recurrence_resources
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    with torch.cuda.device(device):
        err = fn(hidden, _KERNEL_DTYPES[dtype], info)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    if err != 0:
        raise RuntimeError(f"lstm_recurrence resources: CUDA error {err}")
    return {"regs_per_thread": info[0], "static_smem_bytes": info[1],
            "ctas_per_sm": info[2], "sms": sms}


def lstm_recurrence(gates_tm, w_hh, h0, c0):
    """The recurrence over time-major gates [T, B, 4H] -> (out [B, T, H],
    hf, cf).

    When grad is enabled and an input requires grad, it runs through
    `LSTMRecurrenceTrain` (K2 forward, K3 backward; out in f32). Otherwise
    it is K1 for a CUDA tensor and the plain loop for a CPU tensor, with out
    in the gates' dtype. No fallback: a CUDA tensor the kernels cannot take
    raises."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (gates_tm, w_hh, h0, c0)):
        out_tm, hf, cf = LSTMRecurrenceTrain.apply(gates_tm, w_hh, h0, c0)
        return out_tm.transpose(0, 1), hf, cf
    if _use_plain(gates_tm):
        return lstm_recurrence_plain(gates_tm, w_hh, h0, c0)
    return _lstm_recurrence_cuda(gates_tm, w_hh, h0, c0)


def _use_plain(x) -> bool:
    """Plain version for a CPU tensor or inside plain_recurrence(); the
    kernel for a CUDA tensor; anything else raises."""
    if x.device.type == "cpu" or _force_plain:
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no recurrence for device {x.device}")
    return False


# ------------------------------------------------------------- training
def _train_dtype(dtype):
    """The training recurrence runs in f32 (f64 only for a float64
    gradient check of the plain versions)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def lstm_recurrence_train_plain(gates_tm, w_hh, h0, c0):
    """K2's plain version: the recurrence that also returns the backward's
    residuals.

    gates_tm [T, B, 4H] (f32 or bf16), w_hh [H, 4H], h0/c0 [B, H] ->
    (out [T, B, H], hf [B, H], cf [B, H], acts [T, B, 4H] (post-activation
    i, f, g, o), cseq [T, B, H]), all f32. W_hh and h stay f32: unlike the
    inference recurrence, h is not rounded to the gates' dtype."""
    t_len, b, g4 = gates_tm.shape
    hid = g4 // 4
    dt = _train_dtype(gates_tm.dtype)
    w = w_hh.to(dt)
    h = h0.to(dt).clone()
    c = c0.to(dt).clone()
    out = torch.empty((t_len, b, hid), dtype=dt, device=gates_tm.device)
    cseq = torch.empty_like(out)
    acts = torch.empty((t_len, b, g4), dtype=dt, device=gates_tm.device)
    for t in range(t_len):
        a = gates_tm[t].to(dt) + h @ w
        i = torch.sigmoid(a[:, :hid])
        f = torch.sigmoid(a[:, hid:2 * hid])
        g = torch.tanh(a[:, 2 * hid:3 * hid])
        o = torch.sigmoid(a[:, 3 * hid:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        acts[t] = torch.cat([i, f, g, o], dim=-1)
        cseq[t] = c
        out[t] = h
    return out, h, c, acts, cseq


def lstm_recurrence_bwd_plain(acts, cseq, out, h0, c0, w_hh, dout, dhf, dcf):
    """K3's plain version: the reverse-time backward of the recurrence.

    Residuals from K2 (acts [T, B, 4H], cseq and out [T, B, H]) and its
    inputs (h0, c0 [B, H], w_hh [H, 4H]); cotangents dout [T, B, H] and
    (dhf, dcf) [B, H] of the final carry, which enter at step T-1 ->
    (dgx [T, B, 4H], dW_hh [H, 4H], dh0 [B, H], dc0 [B, H]), all in acts'
    dtype. h_{t-1} is out[t-1] (h0 at t=0), c_{t-1} is cseq[t-1] (c0)."""
    t_len, b, g4 = acts.shape
    hid = g4 // 4
    dt = acts.dtype
    w = w_hh.to(dt)
    dgx = torch.empty_like(acts)
    dw = torch.zeros((hid, g4), dtype=dt, device=acts.device)
    dh = dhf.to(dt)
    dc = dcf.to(dt)
    for t in range(t_len - 1, -1, -1):
        i, f, g, o = acts[t].split(hid, dim=-1)
        tc = torch.tanh(cseq[t])
        c_prev = cseq[t - 1] if t > 0 else c0.to(dt)
        h_prev = out[t - 1] if t > 0 else h0.to(dt)
        dh_tot = dout[t].to(dt) + dh
        d_o = dh_tot * tc
        dct = dh_tot * o * (1.0 - tc * tc) + dc
        d_lin = torch.cat([dct * g * i * (1.0 - i),
                           dct * c_prev * f * (1.0 - f),
                           dct * i * (1.0 - g * g),
                           d_o * o * (1.0 - o)], dim=-1)
        dgx[t] = d_lin
        dh = d_lin @ w.T
        dc = dct * f
        dw += h_prev.T @ d_lin
    return dgx, dw, dh, dc


def _lstm_train_fwd_cuda(gates_tm, w_hh, h0, c0):
    """K2 on the card; same contract as `lstm_recurrence_train_plain`."""
    global train_fwd_launch_count
    _check_kernel_args("CUDA train forward", gates_tm, w_hh, h0, c0)
    t_len, b, g4 = gates_tm.shape
    hid = g4 // 4
    dev = gates_tm.device
    gx = _contiguous16(gates_tm)
    w = w_hh.float().contiguous()
    h0 = h0.float().contiguous()
    c0 = c0.float().contiguous()
    f32 = {"dtype": torch.float32, "device": dev}
    out = torch.empty((t_len, b, hid), **f32)
    cseq = torch.empty((t_len, b, hid), **f32)
    acts = torch.empty((t_len, b, g4), **f32)
    hf = torch.empty((b, hid), **f32)
    cf = torch.empty((b, hid), **f32)
    _launch("lstm_train_fwd", _build.load("lstm_train").lstm_train_fwd, 9, 4,
            [gx.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
             out.data_ptr(), hf.data_ptr(), cf.data_ptr(), acts.data_ptr(),
             cseq.data_ptr(), t_len, b, hid, _KERNEL_DTYPES[gx.dtype]], dev)
    train_fwd_launch_count += 1
    return out, hf, cf, acts, cseq


# The dW_hh pass's split-K plan: splits of a multiple of its 16-row stage
# (DW_KC in csrc/lstm_train.cu), at most 256 of them, about 1024 rows each
# for short sequences.
_DW_STAGE_ROWS = 16
_DW_MAX_SPLITS = 256


def _dw_splits(rows: int) -> tuple[int, int]:
    """(splits, rows per split) of the dW_hh pass over `rows` = T*B rows.
    Every split but the last is full and none is empty (one split of no
    rows when rows is 0). It depends on the shape alone, so the partials
    are added in the same order on every run."""
    want = max(1, min(_DW_MAX_SPLITS, -(-rows // 1024)))
    per = _DW_STAGE_ROWS * max(1, -(-rows // (_DW_STAGE_ROWS * want)))
    return max(1, -(-rows // per)), per


def _dw_pass(out, h0, dgx):
    """K3's second launch: dW_hh [H, 4H] = sum over (t, b) of
    h_{t-1, b}^T dgx[t, b], with h_{t-1} = out[t-1] (h0 at t = 0), from
    out [T, B, H], h0 [B, H] and dgx [T, B, 4H], all f32 and contiguous on
    one card. Counted by its caller, `_lstm_train_bwd_cuda`."""
    t_len, b, g4 = dgx.shape
    hid = g4 // 4
    splits, per = _dw_splits(t_len * b)
    f32 = {"dtype": torch.float32, "device": dgx.device}
    dw = torch.empty((hid, g4), **f32)
    part = torch.empty((splits, hid, g4), **f32)  # per-split partials
    _launch("lstm_train_dw", _build.load("lstm_train").lstm_train_dw, 5, 5,
            [out.data_ptr(), h0.data_ptr(), dgx.data_ptr(), dw.data_ptr(),
             part.data_ptr(), t_len, b, hid, splits, per], dgx.device)
    return dw


def _lstm_train_bwd_cuda(acts, cseq, out, h0, c0, w_hh, dout, dhf, dcf):
    """K3 on the card: the reverse-time walk (dgx, dh0, dc0), then the
    dW_hh pass over its dgx (`_dw_pass`); one count for the pair. Same
    contract as `lstm_recurrence_bwd_plain`, f32 only."""
    global train_bwd_launch_count
    t_len, b, g4 = acts.shape
    hid = g4 // 4
    if hid not in _KERNEL_HIDDEN or g4 != 4 * hid:
        raise ValueError(f"CUDA train backward supports H in "
                         f"{_KERNEL_HIDDEN}, got gates width {g4}")
    dev = acts.device
    want = {"acts": (t_len, b, g4), "cseq": (t_len, b, hid),
            "out": (t_len, b, hid), "dout": (t_len, b, hid),
            "w_hh": (hid, g4), "h0": (b, hid), "c0": (b, hid),
            "dhf": (b, hid), "dcf": (b, hid)}
    given = {"acts": acts, "cseq": cseq, "out": out, "dout": dout,
             "w_hh": w_hh, "h0": h0, "c0": c0, "dhf": dhf, "dcf": dcf}
    args = {}
    for name, x in given.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {list(want[name])}, got "
                             f"{list(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, acts on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"CUDA train backward takes f32, {name} is "
                            f"{x.dtype}")
        args[name] = _contiguous16(x)
    f32 = {"dtype": torch.float32, "device": dev}
    dgx = torch.empty((t_len, b, g4), **f32)
    dh0 = torch.empty((b, hid), **f32)
    dc0 = torch.empty((b, hid), **f32)
    _launch("lstm_train_bwd", _build.load("lstm_train").lstm_train_bwd, 10,
            3, [args[n].data_ptr() for n in ("acts", "cseq", "dout", "w_hh",
                                             "c0", "dhf", "dcf")]
            + [dgx.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), t_len, b,
               hid], dev)
    dw = _dw_pass(args["out"], args["h0"], dgx)
    train_bwd_launch_count += 1
    return dgx, dw, dh0, dc0


def _train_fwd(gates_tm, w_hh, h0, c0):
    """(plain?, K2's outputs): K2 on a CUDA tensor, its plain version on a
    CPU tensor or inside plain_recurrence()."""
    plain = _use_plain(gates_tm)
    fwd = lstm_recurrence_train_plain if plain else _lstm_train_fwd_cuda
    return plain, fwd(gates_tm, w_hh, h0, c0)


def _train_bwd(plain, acts, cseq, out, h0, c0, w_hh, dout, dhf, dcf):
    """K3 (or its plain version) in the residuals' dtype -> (dgx, dW_hh,
    dh0, dc0)."""
    bwd = lstm_recurrence_bwd_plain if plain else _lstm_train_bwd_cuda
    dt = acts.dtype
    return bwd(acts, cseq, out, h0.to(dt), c0.to(dt), w_hh.to(dt),
               dout.to(dt), dhf.to(dt), dcf.to(dt))


class LSTMRecurrenceTrain(torch.autograd.Function):
    """Training recurrence: K2 forward, K3 backward.

    Twin of ml_audio_restoration_tpu/ops/lstm.py::lstm_recurrence_train.
    Takes time-major gates [T, B, 4H], w_hh [H, 4H], h0/c0 [B, H]; returns
    (out [T, B, H], hf, cf), all f32. The backward returns dgx time-major.
    torch's engine casts a gradient to its input's dtype, so bf16 gates
    get a rounded dgx here; `lstm` trains through `LSTMTrain` instead. On
    a CPU tensor, or inside plain_recurrence(), both halves run their
    plain versions."""

    @staticmethod
    def forward(ctx, gates_tm, w_hh, h0, c0):
        ctx.plain, (out, hf, cf, acts, cseq) = _train_fwd(gates_tm, w_hh,
                                                          h0, c0)
        ctx.save_for_backward(acts, cseq, out, h0, c0, w_hh)
        return out, hf, cf

    @staticmethod
    def backward(ctx, dout, dhf, dcf):
        acts, cseq, out, h0, c0, w_hh = ctx.saved_tensors
        dgx, dw, dh0, dc0 = _train_bwd(ctx.plain, acts, cseq, out, h0, c0,
                                       w_hh, dout, dhf, dcf)
        return dgx, dw.to(w_hh.dtype), dh0, dc0


class LSTMTrain(torch.autograd.Function):
    """An LSTM under grad, the projection included: JAX's
    `lstm(x, params, impl="pallas_train")` and its VJP, in x's dtype.

    Forward: the weights are rounded to x's dtype, the gates are
    `x @ W_ih` rounded to x's dtype plus the bias `b_hh + b_ih` in that
    dtype (JAX's einsum with `preferred_element_type` x's dtype, then its
    add), and K2 runs on them with W_hh upcast from that copy; out, hf, cf
    are f32. In f32 every rounding is the f32 arithmetic's own, and the
    result that of the fused-bias `addmm` and `LSTMRecurrenceTrain`.

    Backward, pinned in bf16 from `jax.grad` through JAX's `lstm`: K3 gives an
    f32 dgx, which JAX's VJP hands on unrounded. The jaxpr's projection
    transposes are `dot_general(dgx_f32, <bf16 operand>,
    preferred_element_type=bfloat16)`, which lower to a bf16 product: dgx is
    rounded to bf16 first, and dx = dgx @ W_ih^T and dW_ih = x^T @ dgx sum in
    f32 and round once to bf16. The bias cotangent is the f32 sum of the
    unrounded dgx over (T, B), for b_ih and b_hh alike, never rounded; dW_hh is
    K3's f32 sum rounded to bf16 (JAX's `dwhh.astype(w_hh.dtype)`). Each
    gradient comes back in its input's dtype: pass the f32 weights (the
    trainer's cast leaves the LSTM's to it) and the biases' f32 sums reach them
    whole. x: [B, T, C]; returns time-major out [T, B, H] and hf, cf [B, H]."""

    @staticmethod
    def forward(ctx, x, w_ih, b_ih, b_hh, w_hh, h0, c0):
        dt = x.dtype
        b, t_len, c_in = x.shape
        x_tm = x.transpose(0, 1).reshape(t_len * b, c_in)
        w_ih_c, w_hh_c = w_ih.to(dt), w_hh.to(dt)
        gates_tm = ((x_tm @ w_ih_c) + (b_hh.to(dt) + b_ih.to(dt))).view(
            t_len, b, -1)
        ctx.plain, (out, hf, cf, acts, cseq) = _train_fwd(gates_tm, w_hh_c,
                                                          h0, c0)
        ctx.dtypes = (w_ih.dtype, b_ih.dtype, b_hh.dtype, w_hh.dtype)
        ctx.save_for_backward(x_tm, w_ih_c, w_hh_c, acts, cseq, out, h0, c0)
        return out, hf, cf

    @staticmethod
    def backward(ctx, dout, dhf, dcf):
        x_tm, w_ih_c, w_hh_c, acts, cseq, out, h0, c0 = ctx.saved_tensors
        dgx, dw_hh, dh0, dc0 = _train_bwd(ctx.plain, acts, cseq, out, h0,
                                          c0, w_hh_c, dout, dhf, dcf)
        dt = x_tm.dtype
        t_len, b, g4 = dgx.shape
        g = dgx.view(t_len * b, g4)
        g_dt = g.to(dt)
        dx = g_dt @ w_ih_c.T
        dw_ih = x_tm.T @ g_dt
        db = g.sum(dim=0)
        w_ih_t, b_ih_t, b_hh_t, w_hh_t = ctx.dtypes
        return (dx.view(t_len, b, -1).transpose(0, 1), dw_ih.to(w_ih_t),
                db.to(b_ih_t), db.to(b_hh_t), dw_hh.to(dt).to(w_hh_t), dh0,
                dc0)


def lstm(x, params, *, carry=None, return_carry: bool = False):
    """Single-layer LSTM over batch-major x [B, T, C] -> [B, T, H].

    The projection emits TIME-MAJOR gates [T, B, 4H] in x's dtype, the
    layout the recurrence streams. The state starts at zero unless `carry`
    = (h, c); it enters the recurrence in f32 and the output and the
    returned carry come back in x's dtype (the JAX `impl="pallas"`
    contract: bf16 x runs K1 on bf16 gates with f32 state). The weights
    are cast to x's dtype here; under grad it trains through `LSTMTrain`
    (JAX's `impl="pallas_train"`)."""
    b, t_len, c_in = x.shape
    hid = params["w_hh"].shape[0]
    if carry is None:
        h0 = torch.zeros((b, hid), dtype=torch.float32, device=x.device)
        c0 = torch.zeros_like(h0)
    else:
        h0, c0 = carry
    h0, c0 = h0.float(), c0.float()
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x, h0, c0, *params.values())):
        out_tm, hf, cf = LSTMTrain.apply(
            x, params["w_ih"], params["b_ih"], params["b_hh"],
            params["w_hh"], h0, c0)
        out = out_tm.transpose(0, 1)
    else:
        # the weights in x's dtype (a no-op when they already are)
        w_ih, b_ih, b_hh, w_hh = (params[k].to(x.dtype)
                                  for k in ("w_ih", "b_ih", "b_hh", "w_hh"))
        # one GEMM with the bias fused; its [T*B, 4H] result is already
        # the contiguous time-major layout the kernel reads
        gates_tm = torch.addmm(b_ih + b_hh,
                               x.transpose(0, 1).reshape(t_len * b, c_in),
                               w_ih).view(t_len, b, -1)
        out, hf, cf = lstm_recurrence(gates_tm, w_hh, h0, c0)
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
