"""Reduction of a torch.profiler chrome trace to the benchmark's numbers.

The bucket rules are a frozen copy of the program's
(`ml_audio_restoration_torch/utils/profiling.py`, `_RULES` and `bucket`),
kept here so that a change to the program cannot move the yardstick.

A trace is reduced to:
- `kernels`: [(start us, end us, name)] of every device kernel, copy and
  memset on the device the run uses;
- `busy_s` and `window_s`: the union of those intervals, and the traced
  stretch from the first host op to the last device event;
- `by_bucket_ms` and `by_kernel_ms`: device time by bucket and by name;
- `idle_gaps`: the TOP longest stretches with nothing on the device,
  longest first, each named by the innermost host op (or CUDA runtime
  call) running when it began.
"""
from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10  # entries of each breakdown list

_RULES = (
    ("recurrence", ("lstm_recurrence", "lstm_train", "dw_partial",
                    "dw_sum", "sos_forward", "sos_adjoint", "df2t_")),
    ("convolution", ("int8_conv", "conv", "fprop", "dgrad", "wgrad",
                     "implicit", "winograd", "scudnn")),
    ("data-movement", ("copy", "memcpy", "memset", "cat", "index",
                       "gather", "scatter", "transpose", "fill")),
    ("matmul", ("gemm", "gemv", "matmul", "cublas", "cutlass")),
    ("fusion(elementwise)", ("elementwise", "reduce", "at::native",
                             "softmax", "norm")),
)


def bucket(name: str) -> str:
    """recurrence, convolution, data-movement, matmul, fusion(elementwise)
    or other, by the first rule whose key the kernel's name holds."""
    n = name.lower().replace("convert", "")
    for label, keys in _RULES:
        if any(k in n for k in keys):
            return label
    return "other"


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def reduce(trace: dict) -> dict | None:
    """The numbers of one chrome trace, or None when it holds no device
    event (a trace taken without a card): an empty reading is never taken
    for a measurement."""
    device_events = defaultdict(list)
    host = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        start = float(ev["ts"])
        end = start + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev = (ev.get("args") or {}).get("device", ev.get("pid"))
            device_events[dev].append((start, end, ev.get("name", "")))
        elif cat in HOST_CATS:
            host.append((start, end, ev.get("name", "")))
    if not device_events:
        return None
    # the busiest device: a one-chip run has one
    kernels = max(device_events.values(),
                  key=lambda evs: sum(e - s for s, e, _ in evs))
    kernels.sort()
    merged = _union(kernels)
    busy_us = sum(e - s for s, e in merged)
    first = min([s for s, _, _ in host] + [kernels[0][0]])
    last = max(e for _, e, _ in kernels)
    gaps = []
    cursor = first
    for s, e in merged:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    by_bucket = defaultdict(float)
    by_kernel = defaultdict(float)
    for s, e, name in kernels:
        by_bucket[bucket(name)] += (e - s) / 1e3
        by_kernel[name] += (e - s) / 1e3
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"kernels": kernels, "busy_s": busy_us / 1e6,
            "window_s": (last - first) / 1e6,
            "by_bucket_ms": dict(by_bucket), "by_kernel_ms": dict(by_kernel),
            "idle_gaps": [(_host_op(host, g0), (g1 - g0) / 1e6)
                          for g0, g1 in gaps[:TOP]]}


def _union(intervals):
    """Merge sorted (start, end, ...) intervals -> [(start, end)]."""
    out = []
    for s, e, *_ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _host_op(host, t: float) -> str:
    """The innermost host event running at time t."""
    covering = [(e - s, name) for s, e, name in host if s <= t < e]
    return min(covering)[1] if covering else "host (no op traced)"


def kernel_ms(reduced: dict, *keys: str) -> float:
    """Device ms of the kernels whose name holds any of `keys`."""
    return sum(ms for name, ms in reduced["by_kernel_ms"].items()
               if any(k in name for k in keys))


def idle_share(reduced: dict) -> float:
    return 100.0 * (1.0 - reduced["busy_s"] / reduced["window_s"])


def breakdown(reduced: dict, n: int = TOP) -> dict:
    """The top device operations by time and the longest idle gaps, each a
    [name, seconds] list of at most n entries."""
    ops = sorted(reduced["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[name, ms / 1e3] for name, ms in ops],
            "idle_gaps": [[name, s] for name, s in reduced["idle_gaps"][:n]]}
