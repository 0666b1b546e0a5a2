"""int8 serving quantization of the conv stacks.

Counterpart of ml_audio_restoration_tpu/ops/quant.py, with its arithmetic
kept literally so the port quantizes as the JAX package does:

- weights per packed output channel: s = max(max|w|, 1e-12) / 127,
  w_q = clip(round(w / s), -127, 127) (a division; round half to even;
  -127, never -128), on the packed kernel after the input's per-channel
  scales are folded into its rows;
- activations with static per-point, per-channel scales from a calibration
  pass (amax / 127 over the batch and time axes): inv = 1/scale, then
  clip(round(y * inv), -127, 127);
- each conv runs s8 x s8 -> s32 with a fused epilogue (dequantize per
  output channel, + bias, + residual, activation, requantize):
  ops/int8_conv.py, csrc/int8_conv.cu on the card.

`QuantCtx()` calibrates (the forward runs in float and records each
point's amax); `QuantCtx(scales)` serves int8. Its `scope` "packed" keeps
the plain-layout C>=128 stages float, "full" quantizes them as r=1 packed
convs. The folded, packed and quantized kernels are built once per context
(one per scales version in the pipelines), not per call.

Left out: the grouped (tuple-name) points of the JAX package's grouped
dual decoder, which no production route takes.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from .int8_conv import Int8Weight, int8_conv
from .packed import packed_conv


class QT(NamedTuple):
    """A quantized activation: s8 values + its per-channel dequant scale
    ([C] f32 over the trailing axis)."""
    q: torch.Tensor
    scale: torch.Tensor


def quantize_weight(wp):
    """f32/bf16 [k, ci, co] -> (s8 [k, ci, co], f32 [co] per-channel
    scales), on the packed kernel: one scale per packed output channel."""
    wp = wp.float()
    s = torch.clamp(wp.abs().amax(dim=(0, 1)), min=1e-12) / 127.0
    wq = torch.clamp(torch.round(wp / s), -127, 127).to(torch.int8)
    return wq, s


def _inv(scale):
    return 1.0 / torch.as_tensor(scale, dtype=torch.float32)


def requantize(y, scale):
    """f32/bf16 [..., C] -> s8 with a per-channel [C] (or scalar) scale."""
    inv = _inv(scale).to(y.device)
    return torch.clamp(torch.round(y.float() * inv), -127, 127).to(
        torch.int8)


def dequantize(x):
    if isinstance(x, QT):
        return x.q.float() * x.scale
    return x


def lrelu(y):
    """Leaky-ReLU 0.2 as the JAX package writes it (y >= 0 ? y : 0.2*y)."""
    return torch.where(y >= 0, y, y * 0.2)


def int8_exec(x_scale, cache: dict | None = None, key=None):
    """Executor for ops/packed.py's `_exec` hook: the int8 conv of an s8
    input whose per-channel dequant scales are `x_scale`. They are folded
    into the packed kernel's input rows before weight quantization; the
    quantized kernel is kept in `cache[(device, key)]` when a cache is
    given, the device being the input's.
    Epilogue keywords: add, add_scale, act, out_inv, out_dtype."""

    def _exec(xq, kernel, *, window_strides, padding, lhs_dilation=None,
              **epilogue):
        slot = (xq.device, key)
        weight = cache.get(slot) if cache is not None else None
        if weight is None:
            wp, bias = kernel()
            xs = torch.as_tensor(x_scale, dtype=torch.float32,
                                 device=wp.device).reshape(-1)
            wq, ws = quantize_weight(wp * xs[None, :, None])
            weight = Int8Weight(wq, ws, bias)
            if cache is not None:
                cache[slot] = weight
        return int8_conv(
            xq, weight, stride=window_strides[0], padding=padding[0],
            lhs_dilation=1 if lhs_dilation is None else lhs_dilation[0],
            **epilogue)

    return _exec


class QuantCtx:
    """Threads int8 serving (or its calibration pass) through a forward.

    QuantCtx(): calibrate. The forward runs in float and `record` keeps
    each point's running per-channel amax in `.amax` (every point, whatever
    the scope, so one scales file serves both scopes).
    QuantCtx(scales): int8. Activations travel between convs as `QT`s; a
    point in `skip` keeps its output float (a conv whose input is a QT
    still runs int8)."""

    active = True

    def __init__(self, scales: dict | None = None, scope: str = "full",
                 skip=frozenset()):
        assert scope in ("full", "packed"), scope
        self.scales = scales
        self.scope = scope
        self.skip = frozenset(skip)
        self.amax: dict = {}
        # (device, point) -> Int8Weight; (device, layer) -> folded float
        # (w, b): a context reached from two devices keeps each one's own
        self._weights: dict = {}
        self._folded: dict = {}
        self._scale_cache: dict = {}

    @property
    def full(self) -> bool:
        """True when the plain-layout stages also quantize. Calibration is
        always full: it records every point."""
        return self.scales is None or self.scope == "full"

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    def folded(self, key, make):
        """`make()` -> the layer's float (w, b), built once per context in
        int8 mode (the quantized kernels are built from them once too)."""
        if not self.quantized:
            return make()
        if key not in self._folded:
            self._folded[key] = make()
        return self._folded[key]

    def record(self, name, y):
        m = y.float().abs().amax(dim=tuple(range(y.ndim - 1)))
        self.amax[name] = (torch.maximum(self.amax[name], m)
                           if name in self.amax else m)

    def scale_of(self, name, tx=None, device=None):
        if name not in self.scales:
            raise KeyError(
                f"int8 scales have no entry for quantization point {name!r}"
                f" — they were calibrated for a different pipeline/stage "
                f"configuration. Recalibrate (PipelineConfig.quantize_int8 "
                f"auto-calibrates when no scales file is loaded).")
        key = (name, tx is not None, str(device))
        if key not in self._scale_cache:
            s = torch.as_tensor(self.scales[name], dtype=torch.float32,
                                device=device).reshape(-1)
            self._scale_cache[key] = tx(s) if tx is not None else s
        return self._scale_cache[key]

    def quantize_in(self, name: str, x):
        """Entry point: bring a float tensor into the quantized domain."""
        if not self.quantized:
            self.record(name, x)
            return x
        if name in self.skip:
            return x
        s = self.scale_of(name, device=x.device)
        return QT(requantize(x, s), s)

    def out(self, name: str, y, act=None, requant: bool = True,
            scale_tx=None):
        """Close a conv layer that ran in float: activation, then
        requantize (or record amax when calibrating). requant=False marks
        an exit back to float."""
        if act is not None:
            y = act(y)
        if not self.quantized:
            if requant:
                self.record(name, y)
            return y
        if not requant or name in self.skip:
            return y
        s = self.scale_of(name, scale_tx, device=y.device)
        return QT(requantize(y, s), s)

    def deq(self, x):
        return dequantize(x)


class _NullCtx:
    """Inactive context: the float packed forward."""

    active = False
    quantized = False
    full = False

    def folded(self, key, make):
        return make()

    def quantize_in(self, name, x):
        return x

    def out(self, name, y, act=None, requant=True, scale_tx=None):
        return act(y) if act is not None else y

    def deq(self, x):
        return x


NULL_CTX = _NullCtx()


def ctx_or_null(q):
    return NULL_CTX if q is None else q


def _fused(q, name, op, hr, w, bias, x_scale, key, *, act, requant, add,
           scale_tx, out_dtype, kw):
    """One int8 layer through the kernel, whose epilogue takes the residual,
    leaky-ReLU and the requantization, or stores the float exit in
    `out_dtype`. Another activation (the sigmoid exit) runs after, on the
    f32 output, through QuantCtx.out as on the float path."""
    ex = int8_exec(x_scale, q._weights, key)
    epi = {}
    if add is not None:
        epi = ({"add": add.q, "add_scale": add.scale} if isinstance(add, QT)
               else {"add": add.float()})
    if act is not None and act is not lrelu:
        y = op(hr, w, bias, _exec=ex, out_dtype=torch.float32, **epi, **kw)
        out = q.out(name, y, act=act, requant=requant, scale_tx=scale_tx)
        return out if isinstance(out, QT) else out.to(out_dtype)
    epi["act"] = None if act is None else "lrelu"
    if requant and name not in q.skip:
        s = q.scale_of(name, scale_tx, device=hr.device)
        return QT(op(hr, w, bias, _exec=ex, out_inv=_inv(s).to(hr.device),
                     **epi, **kw), s)
    return op(hr, w, bias, _exec=ex, out_dtype=out_dtype, **epi, **kw)


def make_qops(q):
    """(qconv, qconv2) layer helpers bound to a context.

    qconv: one conv layer, act(op(h, w, bias) + add), then requantize or
    record. With the null context it is exactly that float expression.
    qconv2: the sum of two convs over differently scaled inputs (in place
    of a conv over their concatenation; the bias rides the first); both
    inputs are int8 when quantized."""

    def qconv(name, h, w, bias, *, op, act=None, requant=True, add=None,
              scale_tx=None, **kw):
        if q.quantized and isinstance(h, QT):
            return _fused(q, name, op, h.q, w, bias, h.scale, name,
                          act=act, requant=requant, add=add,
                          scale_tx=scale_tx, out_dtype=w.dtype, kw=kw)
        hr = h.to(w.dtype) if q.quantized else h
        y = op(hr, w, bias, **kw)
        if add is not None:
            y = y + q.deq(add)
        out = q.out(name, y, act=act, requant=requant, scale_tx=scale_tx)
        if q.quantized and not isinstance(out, QT):
            out = out.to(w.dtype)  # float exits land in the compute dtype
        return out

    def qconv2(name, h1, w1, h2, w2, bias, *, act=None, **kw):
        if q.quantized:
            # both halves int8 in every int8 forward: y1 + y2 as the second
            # conv's epilogue add (f32 addition commutes, so the same sum)
            y1 = packed_conv(h1.q, w1, bias,
                             _exec=int8_exec(h1.scale, q._weights,
                                             f"{name}#0"),
                             out_dtype=torch.float32, **kw)
            return _fused(q, name, packed_conv, h2.q, w2, None, h2.scale,
                          f"{name}#1", act=act, requant=True, add=y1,
                          scale_tx=None, out_dtype=w1.dtype, kw=kw)
        y = packed_conv(h1, w1, bias, **kw) + packed_conv(h2, w2, None, **kw)
        return q.out(name, y, act=act)

    return qconv, qconv2


def tie_pool_pairs(c: int):
    """scale_tx for a point feeding packed_max_pool2: each (2i, 2i+1)
    packing-phase channel pair shares one scale (their max), so the int8
    pool compares like with like."""

    def tx(s):
        m = s.reshape(-1, 2, c).amax(dim=1, keepdim=True)
        return m.expand(s.numel() // (2 * c), 2, c).reshape(-1)

    return tx


def pooled_scale(s, c: int):
    """Scale vector of packed_max_pool2's output given the tied input
    scale vector: one entry per surviving pair."""
    return s.reshape(-1, 2, c)[:, 0, :].reshape(-1)


def scales_from_amax(amax: dict) -> dict:
    """Accumulated per-point per-channel amaxes -> static scales as plain
    Python lists (JSON-serializable), in float32 as the JAX package makes
    them."""
    return {k: (np.maximum(np.asarray(v, np.float32).reshape(-1), 1e-8)
                / 127.0).tolist()
            for k, v in amax.items()}


def amax_to_host(amax: dict) -> dict:
    """{point: amax tensor} -> {point: float32 numpy}."""
    return {k: v.detach().float().cpu().numpy() for k, v in amax.items()}


def save_scales_file(path, scales: dict):
    """The scales-file format (stage -> point -> per-channel scales) shared
    by RestorationPipeline and StreamingRestorer and with the JAX package:
    JSON, indent 1, sorted keys, written to a temporary file and renamed
    over the target, so a crash mid-write never leaves truncated JSON."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(scales, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_scales_file(path) -> dict:
    with open(path) as fh:
        return json.load(fh)
