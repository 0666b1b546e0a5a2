"""Operations, bytes and roofline bounds of the port's hand kernels.

Frozen copies of the counts the program's smoke test used
(`chip_smoke.py`: K1 in `k1_shapes`, K2 and K3 in the training kernels'
timing), against the data-sheet peaks in `peaks.json`. Each input byte is
counted as read once and each output byte as written once.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peak_flops(dtype: str) -> float:
    """The dense peak for operands of `dtype` ("float32" outside the
    tensor cores, "bfloat16" on them)."""
    return PEAKS["flops"][dtype]


def bound_ms(n_bytes: float, flops: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak of `dtype`, in ms."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"],
               flops / peak_flops(dtype)) * 1e3


def k1(t: int, b: int, h: int, dtype: str = "float32") -> dict:
    """K1, the inference recurrence (csrc/lstm_recurrence.cu), over gates
    [T, B, 4H] in `dtype` with f32 state: gates and W_hh in, out [T, B, H]
    in the gates' dtype, h0/c0/hf/cf in f32; the h @ W_hh products."""
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = item * (t * b * 4 * h + h * 4 * h + t * b * h) + 4 * 4 * b * h
    flops = 2.0 * t * b * h * 4 * h
    return {"bytes": n_bytes, "flops": flops,
            "bound_ms": bound_ms(n_bytes, flops, dtype)}


def k2(t: int, b: int, h: int, dtype: str = "float32") -> dict:
    """K2, the training forward (csrc/lstm_train.cu): gates in `dtype`,
    W_hh, h0/c0 in; out, acts (4H), cseq and hf/cf written in f32."""
    g4 = 4 * h
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = item * t * b * g4 + 4 * (h * g4 + 2 * b * h
                                       + t * b * (h + g4 + h) + 2 * b * h)
    flops = 2.0 * t * b * h * g4
    return {"bytes": n_bytes, "flops": flops,
            "bound_ms": bound_ms(n_bytes, flops)}


def k3(t: int, b: int, h: int) -> dict:
    """K3, the training backward (the reverse walk and the dW_hh pass):
    acts, cseq, out, dout, W_hh and the carries in; dgx, dW_hh and
    dh0/dc0 out, all f32; d_lin @ W_hh^T and the dW_hh products."""
    g4 = 4 * h
    n_bytes = 4 * (t * b * (g4 + 3 * h) + h * g4 + 4 * b * h
                   + t * b * g4 + h * g4 + 2 * b * h)
    flops = 4.0 * t * b * h * g4
    return {"bytes": n_bytes, "flops": flops,
            "bound_ms": bound_ms(n_bytes, flops)}
