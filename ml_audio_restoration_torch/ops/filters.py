"""IIR filtering: Butterworth design on the host, the filters on the
device.

Counterpart of ml_audio_restoration_tpu/ops/filters.py. The design stays
on the host (scipy, cached as numpy); the filtering runs as the scans of
ops/iir.py, a hand kernel on the card (csrc/iir_scan.cu) and a plain loop
on the CPU:
- `sosfilt` / `lfilter`: the biquad cascade / direct form II transposed
  along the last axis of [..., T], with optional initial conditions;
- `sosfiltfilt` / `filtfilt`: zero phase, as scipy's defaults and the JAX
  package compose them: the odd extension by padlen, the steady-state
  initial conditions scaled by each row's first extended sample, forward,
  reverse, forward, reverse, then the crop;
- `butter_bank` / `bank_select` / `bank_index`: a grid of cutoffs and the
  nearest entry for each item's drawn cutoff, so one launch filters a
  batch whose items have different filters.

The coefficients may be one filter, [S, 6] (or b, a), shared by every row,
or one a row, [..., S, 6] broadcast against x's leading axes (the
simulator's per-item roll-off). Everything is differentiable in x and the
initial state.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .iir import df2t_scan, sos_scan


@functools.lru_cache(maxsize=64)
def butter_coeffs(order: int, cutoff_hz: float, sample_rate: float,
                  btype: str):
    """Digital Butterworth (b, a, zi) as float32 numpy arrays."""
    from scipy import signal as _sig

    wn = cutoff_hz / (sample_rate / 2.0)
    b, a = _sig.butter(order, wn, btype=btype)
    zi = _sig.lfilter_zi(b, a)
    return (np.asarray(b, np.float32), np.asarray(a, np.float32),
            np.asarray(zi, np.float32))


@functools.lru_cache(maxsize=64)
def butter_sos(order: int, cutoff_hz: float, sample_rate: float, btype: str):
    """Butterworth as cascaded biquads (SOS) and per-section sosfilt_zi:
    (sos [S, 6], zi [S, 2]) float32 numpy arrays."""
    from scipy import signal as _sig

    wn = cutoff_hz / (sample_rate / 2.0)
    sos = _sig.butter(order, wn, btype=btype, output="sos")
    zi = _sig.sosfilt_zi(sos)
    return np.asarray(sos, np.float32), np.asarray(zi, np.float32)


@functools.lru_cache(maxsize=8)
def butter_bank(order: int, f_lo: float, f_hi: float, sample_rate: float,
                btype: str, num: int = 49):
    """butter_sos over a `num`-point linspace of cutoffs in [f_lo, f_hi]:
    (sos [num, S, 6], zi [num, S, 2]) numpy."""
    soss, zis = zip(*(butter_sos(order, float(f), sample_rate, btype)
                      for f in np.linspace(f_lo, f_hi, num)))
    return np.stack(soss), np.stack(zis)


def bank_index(num: int, freq, f_lo: float, f_hi: float):
    """Nearest index of a `num`-point linspace over [f_lo, f_hi] for each
    cutoff in `freq` (a float32 tensor): round half to even, clipped."""
    idx = torch.round((freq - f_lo) / (f_hi - f_lo) * (num - 1))
    return torch.clamp(idx.to(torch.int32), 0, num - 1)


def bank_select(bank, freq, f_lo: float, f_hi: float):
    """The bank entries (sos, zi) nearest each cutoff in `freq`, as tensors
    on freq's device: [*freq.shape, S, 6] and [*freq.shape, S, 2]."""
    soss, zis = (torch.as_tensor(a, device=freq.device) for a in bank)
    idx = bank_index(soss.shape[0], freq, f_lo, f_hi).long()
    return soss[idx], zis[idx]


def _rows(coef, lead, tail, x):
    """Coefficients or state broadcast to x's leading axes and flattened to
    rows: [prod(lead), *tail] in x's dtype on x's device."""
    coef = torch.as_tensor(coef, device=x.device).to(x.dtype)
    return coef.broadcast_to(lead + tail).reshape((-1,) + tail)


def sosfilt(sos, x, zi=None):
    """Cascaded-biquad IIR along the last axis of x [..., T].

    sos: [S, 6] second-order sections, or [..., S, 6] broadcast against
    x's leading axes; zi: optional initial conditions [S, 2] or
    [..., S, 2] (scipy's sosfilt convention)."""
    sos = torch.as_tensor(sos)
    n = sos.shape[-2]
    lead = tuple(x.shape[:-1])
    zi = (torch.zeros((n, 2), dtype=x.dtype, device=x.device)
          if zi is None else zi)
    rows = x.reshape(-1, x.shape[-1])
    y = sos_scan(rows, _rows(sos, lead, (n, 6), x),
                 _rows(zi, lead, (n, 2), x))
    return y.reshape(x.shape)


def _odd_extend(x, padlen: int):
    left = 2 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -padlen - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def _check_padlen(x, padlen: int):
    if x.shape[-1] <= padlen:
        # scipy raises here too: the odd extension would be short
        raise ValueError(
            f"input length {x.shape[-1]} must exceed padlen {padlen}")


def sosfiltfilt(sos, x, zi=None, padlen: int | None = None):
    """Zero-phase forward-backward SOS filtering with scipy.signal.
    sosfiltfilt's defaults (padlen 3 (2 S + 1)). `zi` is sosfilt_zi's
    steady state ([S, 2], or one a row like sos)."""
    sos = torch.as_tensor(sos)
    n = sos.shape[-2]
    if padlen is None:
        padlen = 3 * (2 * n + 1)
    if zi is None:
        raise ValueError("pass zi from butter_sos / scipy.signal.sosfilt_zi")
    _check_padlen(x, padlen)
    zi = torch.as_tensor(zi, device=x.device).to(x.dtype)
    ext = _odd_extend(x, padlen)
    y = sosfilt(sos, ext, zi=zi * ext[..., 0][..., None, None])
    y = y.flip(-1)
    y = sosfilt(sos, y, zi=zi * y[..., 0][..., None, None])
    return y.flip(-1)[..., padlen:-padlen]


def _normalized(b, a, x):
    b = torch.as_tensor(b, device=x.device)
    a = torch.as_tensor(a, device=x.device)
    return b / a[..., :1], a / a[..., :1]


def lfilter(b, a, x, zi=None):
    """Direct-form-II-transposed IIR filter along the last axis of x
    [..., T]. b, a: [order + 1] (normalized by a[0] here), or one pair a
    row broadcast against x's leading axes; zi: optional [order] initial
    conditions (or one a row)."""
    b, a = _normalized(b, a, x)
    order = a.shape[-1] - 1
    lead = tuple(x.shape[:-1])
    zi = (torch.zeros(order, dtype=x.dtype, device=x.device)
          if zi is None else zi)
    ba = torch.cat(torch.broadcast_tensors(b, a), dim=-1)
    rows = x.reshape(-1, x.shape[-1])
    y = df2t_scan(rows, _rows(ba, lead, (2 * (order + 1),), x),
                  _rows(zi, lead, (order,), x))
    return y.reshape(x.shape)


def lfilter_zi(b, a):
    """The steady-state initial conditions of lfilter for a step input
    (scipy.signal.lfilter_zi), solving the companion system with
    torch.linalg.solve as the JAX package does for traced coefficients."""
    b = torch.as_tensor(b)
    a = torch.as_tensor(a)
    b, a = b / a[0], a / a[0]
    n = a.shape[0]
    companion_t = torch.zeros((n - 1, n - 1), dtype=b.dtype)
    companion_t[:, 0] = -a[1:]
    companion_t[:-1, 1:] = torch.eye(n - 2, dtype=b.dtype)
    iminus = torch.eye(n - 1, dtype=b.dtype) - companion_t
    return torch.linalg.solve(iminus, b[1:] - a[1:] * b[0])


def filtfilt(b, a, x, zi=None, padlen: int | None = None):
    """Zero-phase forward-backward filtering with scipy.signal.filtfilt's
    defaults (odd extension, padlen 3 max(len(a), len(b)))."""
    b = torch.as_tensor(b)
    a = torch.as_tensor(a)
    if padlen is None:
        padlen = 3 * max(b.shape[-1], a.shape[-1])
    _check_padlen(x, padlen)
    if zi is None:
        zi = lfilter_zi(b, a)
    zi = torch.as_tensor(zi, device=x.device).to(x.dtype)
    ext = _odd_extend(x, padlen)
    y = lfilter(b, a, ext, zi=zi * ext[..., :1])
    y = y.flip(-1)
    y = lfilter(b, a, y, zi=zi * y[..., :1])
    return y.flip(-1)[..., padlen:-padlen]


def butter_filtfilt(x, order: int, cutoff_hz: float, sample_rate: float,
                    btype: str):
    """A scipy-designed Butterworth applied with zero phase in the SOS form
    (the float32-stable one)."""
    sos, zi = butter_sos(order, cutoff_hz, sample_rate, btype)
    return sosfiltfilt(sos, x, zi=zi)
