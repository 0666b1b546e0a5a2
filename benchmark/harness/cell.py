"""One run of one cell: set-up, the measured window, the traced stretch,
the correctness check and the result line.

A traffic driver (`benchmark/traffic/<driver>.py`) exposes `Session(ctx)`,
whose constructor builds and warms the system under test, and whose
methods are:

- `unit()`: one unit of the cell's work (a restore, a training epoch, a
  feed), ending when its result is on the host; returns a record with at
  least `audio_s` and `flops` (model FLOPs of the unit), and `t`, its
  time, where the driver times the system's call itself (else the
  harness times the whole unit);
- `check(control)`: after the window, frees the program's state, runs the
  plain reference over a sample of what the window produced and returns
  {number: value}; with `control` also {number + ".control": value} from
  the reference run in the precision below the configuration's (and any
  planted fault's readings), for the limits' upper readings;
- `info()`: {name: value} for the run's info lines on standard error;
- `dtype`: the compute type whose peak the cell's MFU is taken against.

The harness times each unit on the host clock, runs units until
`seconds` have passed, and with `trace` runs `traced_units` more under
torch.profiler. Readers in `benchmark/metrics/` turn the record into the
metrics the manifest names.
"""
from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

from . import trace as tr
from .manifest import Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "ml_audio_restoration_tpu")


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclass
class Ctx:
    root: Path
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: object  # torch.device
    chips: int


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(root, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device=None, control: bool = False,
        log=print) -> dict:
    """The result of one run (the dict the result line prints). `device`
    None looks for the cards the cell asks for and raises NoDevice when
    they are missing; a test passes a device to skip that look. `log`
    takes the lines meant for standard error."""
    import torch

    man = Manifest(root)
    cell = man.cell(workload)
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            raise NoDevice(f"{workload} needs {cell['chips']} CUDA card(s); "
                           f"this machine has "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    traffic = man.traffic(cell)
    ctx = Ctx(Path(root), cell, man.config(cell), traffic, seed, seconds,
              device, cell["chips"])
    log(f"info set-up s before the driver (the imports): "
        f"{time.perf_counter() - t_start:.3f}")
    session = man.driver(traffic).Session(ctx)
    _sync(torch, device)
    setup_s = time.perf_counter() - t_start

    units = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        u0 = time.perf_counter()
        rec = session.unit()
        rec.setdefault("t", time.perf_counter() - u0)
        units.append(rec)
    window_s = time.perf_counter() - t0

    reduced, traced = None, []
    if trace:
        traced, reduced = _traced(torch, session, traffic["traced_units"],
                                  device)
        per = lambda us: sum(u["t"] for u in us) / max(  # noqa: E731
            sum(u.get("steps", 1) for u in us), 1)
        log(f"tracer cost: {per(units) * 1e3:.3f} ms untraced, "
            f"{per(traced) * 1e3:.3f} ms traced a "
            f"{traffic.get('unit_name', 'unit')}")
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    for key, value in session.info().items():
        log(f"info {key}: {value}")
    fifth = max(1, len(units) // 5)
    log("info unit ms by fifth of the window: " + ", ".join(
        f"{statistics.median(u['t'] for u in units[i:i + fifth]) * 1e3:.2f}"
        for i in range(0, fifth * 5, fifth) if units[i:i + fifth]))

    checks = session.check(control)
    limits = man.limits(cell)
    lines = {}
    correct = True
    for name, limit in limits.items():
        value = checks.get(name)
        ok = value is not None and value == value and value <= limit
        correct &= ok
        lines[name] = {"value": value, "limit": limit}
    extra = {k: v for k, v in checks.items() if k not in limits}

    rec = {"cell": cell, "config": ctx.config, "traffic": traffic,
           "units": units, "window_s": window_s, "setup_s": setup_s,
           "traced_units": traced, "trace": reduced, "dtype": session.dtype}
    metrics = {}
    for m in man.metrics(cell, trace):
        value = man.reader(m).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": ctx.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": sum(u.get("steps", 1)
                                                   for u in units),
              "failed": 0, "metrics": metrics, "device": dev}
    if reduced is not None:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        result["breakdown"] = tr.breakdown(reduced)
    if extra:
        result["readings"] = extra
    result["checks"] = lines
    return result


def _traced(torch, session, n: int, device):
    """n units under torch.profiler -> (their records, the reduced
    trace). The chrome trace is written to a temporary file, read and
    removed."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    traced = []
    with profile(activities=acts) as prof:
        for _ in range(n):
            u0 = time.perf_counter()
            rec = session.unit()
            rec.setdefault("t", time.perf_counter() - u0)
            traced.append(rec)
        _sync(torch, device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        reduced = tr.reduce(tr.load(path))
    finally:
        os.unlink(path)
    return traced, reduced


def p95(values) -> float:
    """The 95th percentile (inclusive method, linear between ranks)."""
    return statistics.quantiles(values, n=100, method="inclusive")[94]
