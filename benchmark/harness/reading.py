"""Arithmetic shared by the metric readers of `benchmark/metrics/`.

A reader gets the run's record: `units` (the window's units, each with
its host time `t`, `audio_s`, `flops` and its driver's counts),
`window_s`, `setup_s`, `traced_units` and `trace` (the reduced chrome
trace of the traced stretch, None without one) and `dtype`. A reader that
finds nothing to read returns None, and the metric is left out.
"""
from __future__ import annotations

from benchmark.counts.kernels import peak_flops

from . import trace as tr
from .cell import p95


def audio_rate(rec) -> float:
    """Seconds of audio per second of the window."""
    return sum(u["audio_s"] for u in rec["units"]) / rec["window_s"]


def unit_p95_ms(rec) -> float | None:
    times = [u["t"] for u in rec["units"]]
    return p95(times) * 1e3 if len(times) >= 20 else None


def mfu(rec) -> float | None:
    """Model FLOPs of the window's units over its untraced time, as a
    share (%) of the peak of the cell's compute type."""
    if rec["trace"] is None:
        return None
    flops = sum(u["flops"] for u in rec["units"])
    return 100.0 * flops / rec["window_s"] / peak_flops(rec["dtype"])


def steps(units) -> int:
    return sum(u.get("steps", 1) for u in units)


def device_ms_per_step(rec, bucket: str | None = None) -> float | None:
    """Device ms a traced unit (a training step for a training cell) in one
    bucket, or busy in all."""
    if rec["trace"] is None:
        return None
    ms = (rec["trace"]["busy_s"] * 1e3 if bucket is None
          else rec["trace"]["by_bucket_ms"].get(bucket, 0.0))
    return ms / steps(rec["traced_units"])


def roofline(rec, bound_key: str, *kernel_keys: str) -> float | None:
    """The traced units' summed bound (`bound_key` of each unit, ms) over
    the device time of the kernels named by `kernel_keys`, in %."""
    if rec["trace"] is None:
        return None
    ms = tr.kernel_ms(rec["trace"], *kernel_keys)
    if ms <= 0:
        return None
    return 100.0 * sum(u[bound_key] for u in rec["traced_units"]) / ms


def idle_share(rec) -> float | None:
    return None if rec["trace"] is None else tr.idle_share(rec["trace"])
