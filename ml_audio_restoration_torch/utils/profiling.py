"""Tracing and profiling on torch.profiler.

Counterpart of ml_audio_restoration_tpu/utils/profiling.py, whose xplane
readers become readers of the profiler's chrome trace:
- trace(): records CPU and CUDA activity for the block and writes the
  chrome trace (viewable in Perfetto or chrome://tracing) under log_dir;
- annotate(): a named region (record_function), which also shows on the
  card's timeline as a span around its kernels;
- sync(): waits for the tensor's device and returns the tensor;
- StepTimer: rolling wall-time statistics;
- trace_device_times() / trace_top_ops(): the device time of the newest
  trace by bucket, and its top kernels.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict, deque
from pathlib import Path


@contextlib.contextmanager
def trace(log_dir: str = "profiles"):
    """Record CPU (and, where there is a card, CUDA) activity for the block
    and write it as `trace_<ns>.json` under log_dir. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region for the profiler's timelines."""
    from torch.profiler import record_function

    return record_function(name)


def sync(x):
    """Wait for the device that holds tensor x; return x."""
    import torch

    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return x


# ------------------------------------------------------ chrome trace reading
KERNEL, MEMCPY, MEMSET, GPU_SPAN = ("kernel", "gpu_memcpy", "gpu_memset",
                                    "gpu_user_annotation")
_RULES = (
    # the hand recurrences: K1, K2, K3 (walk and dW_hh pass), the IIR scans
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
    """The bucket of a kernel name: recurrence (the port's hand recurrences
    and IIR scans), convolution (cuDNN and the int8 conv), data-movement
    (copies, cat, index), matmul (GEMMs), fusion(elementwise) (ATen's
    elementwise and reduction kernels) or other."""
    n = name.lower().replace("convert", "")
    for label, keys in _RULES:
        if any(k in n for k in keys):
            return label
    return "other"


def _newest_device_events(logdir) -> dict:
    """_device_events of the newest trace_*.json under logdir (what trace()
    writes). Raises RuntimeError when there is none, or when it holds no
    GPU event (a trace taken without a card), so that an empty reading is
    never taken for a measurement."""
    files = sorted(Path(logdir).rglob("trace_*.json"),
                   key=lambda p: p.stat().st_mtime)
    if not files:
        raise RuntimeError(f"no trace (trace_*.json) under {logdir}")
    events = _device_events(json.loads(files[-1].read_text()))
    if not events:
        raise RuntimeError(f"the trace {files[-1]} holds no GPU events")
    return events


def _device_events(trace: dict) -> dict:
    """{device: {category: [(start us, end us, stream, name)]}} of the
    trace's complete GPU events."""
    out: dict = defaultdict(lambda: defaultdict(list))
    for ev in trace.get("traceEvents", []):
        cat = ev.get("cat")
        if ev.get("ph") != "X" or cat not in (KERNEL, MEMCPY, MEMSET,
                                                GPU_SPAN):
            continue
        dev = (ev.get("args") or {}).get("device", ev.get("pid"))
        start = float(ev["ts"])
        out[dev][cat].append((start, start + float(ev.get("dur", 0.0)),
                              ev.get("tid"), ev.get("name", "")))
    return out


def _overlaps(span, others) -> bool:
    start, end, stream, _ = span
    return any(s < end and start < e and t != stream for s, e, t, _ in others)


def _plane(events: dict):
    """(total ms, {bucket: ms}, copy overlap ms, [annotated span ms]) of
    one device. Kernels count toward the total; a copy or memset counts
    only where no kernel on another stream runs beside it, else as
    overlap."""
    totals: dict = defaultdict(float)
    overlap = 0.0
    for start, end, stream, name in events[KERNEL]:
        totals[bucket(name)] += (end - start) / 1e3
    for span in events[MEMCPY] + events[MEMSET]:
        ms = (span[1] - span[0]) / 1e3
        if _overlaps(span, events[KERNEL]):
            overlap += ms
        else:
            totals["data-movement"] += ms
    spans = [(e - s) / 1e3 for s, e, _, _ in events[GPU_SPAN]]
    return sum(totals.values()), totals, overlap, spans


def trace_device_times(logdir: str, combine: str = "busiest") -> dict:
    """Device time (ms) of the newest chrome trace under logdir, by bucket.

    Kernel events count toward the total; memcpy and memset events that
    overlap a kernel on another stream count as `async_copy_overlap_ms`
    only; annotated GPU spans longer than 1 ms are listed as
    `module_step_ms`. `combine` picks the policy over several devices:
    "busiest" reports the busiest device (devices that run the same work
    at once), "sum" adds them (devices that run one after another)."""
    planes = [_plane(ev) for ev in _newest_device_events(logdir).values()]
    if combine == "sum":
        total = sum(p[0] for p in planes)
        overlap = sum(p[2] for p in planes)
        totals: dict = defaultdict(float)
        spans = []
        for _, t, _, s in planes:
            for k, v in t.items():
                totals[k] += v
            spans.extend(s)
    elif combine == "busiest":
        total, totals, overlap, spans = max(
            planes, key=lambda p: (p[0], sum(p[3])))
    else:
        raise ValueError(f"combine must be 'busiest' or 'sum', got "
                         f"{combine!r}")
    return {"total_device_ms": total,
            "module_step_ms": [s for s in spans if s > 1.0],
            "async_copy_overlap_ms": overlap,
            "device_planes": len(planes),
            **dict(sorted(totals.items(), key=lambda kv: -kv[1]))}


def trace_top_ops(logdir: str, n: int = 20) -> list:
    """The top n kernels by total time on the busiest device of the newest
    chrome trace: [(name, total ms, count), ...]."""
    per_device = []
    for events in _newest_device_events(logdir).values():
        totals: dict = defaultdict(float)
        counts: dict = defaultdict(int)
        for start, end, _, name in events[KERNEL]:
            totals[name] += (end - start) / 1e3
            counts[name] += 1
        per_device.append((sum(totals.values()), totals, counts))
    _, totals, counts = max(per_device, key=lambda p: p[0])
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [(name, ms, counts[name]) for name, ms in ranked]


class StepTimer:
    """Rolling step-time statistics (window of `keep` steps)."""

    def __init__(self, keep: int = 100):
        self.times = deque(maxlen=keep)
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._start)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def last(self) -> float:
        return self.times[-1] if self.times else 0.0

    def summary(self) -> dict:
        if not self.times:
            return {"mean_s": 0.0, "min_s": 0.0, "max_s": 0.0, "steps": 0}
        return {"mean_s": self.mean, "min_s": min(self.times),
                "max_s": max(self.times), "steps": len(self.times)}
