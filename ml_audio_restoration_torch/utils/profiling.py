"""Tracing and profiling on torch.profiler.

Counterpart of ml_audio_restoration_tpu/utils/profiling.py, whose xplane
readers become readers of the profiler's chrome trace:
- trace(): records CPU and CUDA activity for the block and writes the
  chrome trace (viewable in Perfetto or chrome://tracing) under log_dir;
- annotate(name, device_ms=False, **counts): the program's span. While no
  torch profiler records on the calling thread it returns one shared
  no-op context (a single flag check). While one records, it enters
  `record_function(name)`, so the span lies in the chrome trace as a
  `user_annotation` on the timeline of every kernel and copy, and keeps a
  record: name, parent (the thread's innermost open span), host start and
  end, `counts`, and, for a `device_ms` span once CUDA is initialised, a
  CUDA event on the current stream at entry and one at exit. It never
  synchronises;
- spans() / clear_spans(): the records (a bounded buffer of the last
  MAX_SPANS), each span's device ms resolved from its events;
- sync(): waits for the tensor's device and returns the tensor;
- trace_device_times() / trace_top_ops(): the device time of the newest
  trace by bucket, and its top kernels.

The program's spans (README, `utils.profiling`; those that time the
device marked *): `restore` (rows_real, rows_run), `restore.denoise`*,
`restore.super_resolution`*, `restore.stereo`*, `restore.enhance`*
(tokens) and inside it `enhance.spec`*, `enhance.bands`*,
`enhance.time`*, `enhance.band`*; `stream.feed`, `stream.buffer`,
`stream.upload`*, `stream.download`*; `train.step`, `train.update`*,
`loader.wait`.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict, deque
from pathlib import Path

import torch

MAX_SPANS = 10_000  # records kept; the oldest go first
# the off check: torch's own "is a profiler recording on this thread"
_profiler_enabled = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(log_dir: str = "profiles"):
    """Record CPU (and, where there is a card, CUDA) activity for the block
    and write it as `trace_<ns>.json` under log_dir. Yields the profiler."""
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


class _NoSpan:
    """annotate() while no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts):
        pass


NO_SPAN = _NoSpan()


class _Recorder:
    """The spans' bounded buffer, the per-thread stacks of open spans and,
    per CUDA device, the event that device ms are counted from."""

    def __init__(self, keep: int):
        self.records: deque = deque(maxlen=keep)
        self.ids = itertools.count()
        self.local = threading.local()
        self.bases: dict = {}  # device index -> first start event
        self.lock = threading.Lock()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORDER = _Recorder(MAX_SPANS)


class _Span:
    """One recorded span (annotate() while a profiler records)."""
    __slots__ = ("rec", "_fn", "_end", "_timed")

    def __init__(self, name: str, timed: bool, counts: dict):
        self.rec = {"name": name, "counts": counts}
        self._timed = timed

    def __enter__(self):
        rec = self.rec
        stack = _RECORDER.stack()
        self._fn = torch.autograd.profiler.record_function(rec["name"])
        self._fn.__enter__()
        rec.update(id=next(_RECORDER.ids),
                   parent=stack[-1] if stack else None, end_ns=None,
                   device=None, events=None)
        self._end = None
        if self._timed and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._end = torch.cuda.Event(enable_timing=True)
            rec.update(device=torch.cuda.current_device(),
                       events=(start, self._end))
        rec["start_ns"] = time.perf_counter_ns()
        stack.append(rec["id"])
        _RECORDER.records.append(rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["end_ns"] = time.perf_counter_ns()
        if self._end is not None:
            self._end.record()
        _RECORDER.stack().pop()
        self._fn.__exit__(*exc)
        return False

    def count(self, **counts):
        """Add counts known only inside the span."""
        self.rec["counts"].update(counts)


def annotate(name: str, device_ms: bool = False, **counts):
    """The program's span around a block, with `counts` (numbers of the
    work it covers) as its arguments: a no-op while no torch profiler
    records on this thread, else a `record_function(name)` region and a
    record for spans(). `device_ms` spans also record a CUDA event at
    entry and at exit (for readers of device time; events cost host time,
    so spans read on the host's clock take none). `with annotate(...) as
    span: span.count(k=v)` adds counts known only inside the block."""
    if not _profiler_enabled():
        return NO_SPAN
    return _Span(name, device_ms, counts)


def spans() -> list:
    """The recorded spans, oldest first (at most MAX_SPANS), as dicts:
    `name`, `id`, `parent` (the id of the span it ran in on its thread, or
    None), `start_ns` / `end_ns` (perf_counter_ns; `end_ns` None
    while open), `host_ms`, `counts`, and `device_start_ms` /
    `device_end_ms` (on its device's clock, counted from the first timed
    span's entry event there) and `device_ms` (between its own entry and
    exit events), each None without CUDA or for a span opened without
    `device_ms`. Resolving the events waits once for
    each device that has unresolved spans."""
    with _RECORDER.lock:
        recs = list(_RECORDER.records)
        done = [r for r in recs
                if r["events"] is not None and r["end_ns"] is not None]
        for dev in {r["device"] for r in done}:
            torch.cuda.synchronize(dev)
        for r in done:
            start, end = r["events"]
            base = _RECORDER.bases.setdefault(r["device"], start)
            r.update(device_start_ms=base.elapsed_time(start),
                     device_end_ms=base.elapsed_time(end),
                     device_ms=start.elapsed_time(end), events=None)
        out = []
        for r in recs:
            s = {"device_start_ms": None, "device_end_ms": None,
                 "device_ms": None}
            s.update((k, v) for k, v in r.items()
                     if k not in ("events", "device"))
            s["counts"] = dict(r["counts"])
            s["host_ms"] = (None if r["end_ns"] is None
                            else (r["end_ns"] - r["start_ns"]) / 1e6)
            out.append(s)
        return out


def clear_spans():
    """Empty the span buffer."""
    with _RECORDER.lock:
        _RECORDER.records.clear()
        _RECORDER.bases.clear()


def sync(x):
    """Wait for the device that holds tensor x; return x."""
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
