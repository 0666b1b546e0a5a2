#!/usr/bin/env python3
"""Ablation of the port's IIR scan (csrc/iir_scan.cu) on one NVIDIA GPU.

    python3 scripts/torch_iir_ablation.py [--parent DIR]

Builds variants of ml_audio_restoration_torch/csrc/iir_scan.cu into
build/ablation/, each the shipped source with one design choice taken back
(or one part cut out, to see what it costs) by a text patch, and times
their forward and adjoint walks in turns (shipped first and last) through
ops/iir.py at the simulator's shape: 16 rows of 44,130 f32 steps, the
crackle high-pass (two biquad sections), seeded inputs. A variant that
still computes the function must equal the shipped kernel bit for bit.
The `stamps` variant also reads clock64() at the walk's phase boundaries
(thread 0 of each CTA): cycles of the local pass, the unit-state walk,
the combine and the replay. `--parent DIR` names an earlier checkout (for
example a `git archive` of the parent commit) whose own package times its
own kernel on the same inputs, in a subprocess before and after this
one's. Each time is the median device time of a launch, the launches
queued behind a spin of the card (a walk is shorter than the host's work
for a call). Prints one JSON line per variant and, last,
{"iir_ablation": {...}}. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "ablation"
ROWS, STEPS, RATE = 16, 44_130, 22050


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"patch target not found: {old[:60]!r}")
    return text.replace(old, new)


def cta_barriers(src: str) -> str:
    """The walk's tile synced by the whole CTA, not by each warp."""
    return _sub(src, "__syncwarp();", "__syncthreads();")


def no_prefetch(src: str) -> str:
    """Each chunk's inputs loaded when the chunk starts, not during the
    previous chunk's walk."""
    src = _sub(src, "  fetch(0);\n  for (int c0 = 0; c0 < block; "
               "c0 += kChunk) {\n", "  for (int c0 = 0; c0 < block; "
               "c0 += kChunk) {\n    fetch(c0);\n")
    return _sub(src, "    if (c0 + kChunk < block) fetch(c0 + kChunk);\n",
                "")


def data_only(src: str) -> str:
    """The walks' steps cut to one add: what moving the data costs."""
    return _sub(src, "const double out = w.step(z, static_cast<double>"
                "(mine[i]));", "const double out = z[0] + static_cast"
                "<double>(mine[i]);\n        z[0] = out;")


def stamps(src: str) -> str:
    """The shipped kernel with clock64() read at its phase boundaries."""
    src = _sub(src, "namespace {\n", "namespace {\n__device__ long long "
               "g_stamps[64][4];\n")
    for mark, name in (("  // 1. local pass", "s0"),
                       ("  // Phi's column c:", "s1"),
                       ("  // 2. combine:", "s2"),
                       ("  // the last block's end state", "s3")):
        src = _sub(src, mark, f"  const long long {name} = clock64();\n"
                   + mark)
    src = _sub(src, "  walk_blocks<true>(w, e, xr, yr, tile, block, blocks, "
               "pad, len);\n}", "  walk_blocks<true>(w, e, xr, yr, tile, "
               "block, blocks, pad, len);\n  const long long s4 = clock64();"
               "\n  if (tid == 0 && blockIdx.x < 64) {\n"
               "    long long* out = g_stamps[blockIdx.x];\n"
               "    out[0] = s1 - s0;\n    out[1] = s2 - s1;\n"
               "    out[2] = s3 - s2;\n    out[3] = s4 - s3;\n  }\n}")
    return src + ('\nextern "C" int iir_stamps(long long* out) {\n'
                  "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                  "      out, g_stamps, sizeof(g_stamps)));\n}\n")


# name -> (patch, computes the function)
VARIANTS = {"shipped": (None, True), "cta_barriers": (cta_barriers, True),
            "no_prefetch": (no_prefetch, True),
            "data_only": (data_only, False), "stamps": (stamps, True)}
PHASES = ("local", "unit_states", "combine", "replay")


def sources(csrc: Path) -> dict[str, str]:
    text = (csrc / "iir_scan.cu").read_text()
    return {name: patch(text) if patch else text
            for name, (patch, _) in VARIANTS.items()}


def _build_all(texts: dict[str, str]) -> dict[str, Path]:
    from ml_audio_restoration_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        cu, lib = OUT / f"iir_{name}.cu", OUT / f"libiir_{name}.so"
        cu.write_text(text)
        proc = subprocess.run([_build._nvcc(), *_build._flags("iir_scan"),
                               "-o", str(lib), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        return name, lib

    with ThreadPoolExecutor(len(texts)) as pool:
        return dict(pool.map(one, texts.items()))


def _inputs(torch):
    """x [16, 44,130], its cotangent, the crackle high-pass a row and its
    steady state scaled by each row's first sample, on the card."""
    from ml_audio_restoration_torch.ops import filters as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn((ROWS, STEPS), generator=g, device=dev) * 0.1
    gy = torch.randn((ROWS, STEPS), generator=g, device=dev)
    sos, zi = F.butter_sos(4, 2500.0, RATE, "high")
    coef = torch.from_numpy(sos).to(dev).expand(ROWS, -1, -1).contiguous()
    z0 = (torch.from_numpy(zi).to(dev) * x[:, :1, None]).contiguous()
    return x, gy, coef, z0


def _ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for event in events[1:]:
        fn()
        event.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def _digest(y) -> str:
    return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]


def time_package() -> dict:
    """This process's package, its own build of its kernel: forward and
    adjoint ms and the forward output's digest. Run with an earlier
    checkout first on sys.path."""
    import torch
    from ml_audio_restoration_torch.ops import iir

    x, gy, coef, z0 = _inputs(torch)
    return {"forward_ms": _ms(torch, lambda: iir._sos_forward(x, coef, z0)),
            "adjoint_ms": _ms(torch, lambda: iir._sos_adjoint(gy, coef)),
            "digest": _digest(iir._sos_forward(x, coef, z0))}


def _parent_run(parent: Path) -> dict:
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "sys.path.insert(1, sys.argv[2]); import torch_iir_ablation as "
            "a; print(json.dumps(a.time_package()))")
    proc = subprocess.run([sys.executable, "-c", code, str(parent),
                           str(ROOT / "scripts")], capture_output=True,
                          text=True, cwd=parent)
    if proc.returncode:
        raise RuntimeError(f"parent run failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _phase_cycles(lib) -> dict:
    import numpy as np

    out = np.zeros((64, len(PHASES)), dtype=np.int64)
    fn = lib.iir_stamps
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    if fn(out.ctypes.data) != 0:
        raise RuntimeError("reading the phase stamps failed")
    return dict(zip(PHASES, out[:ROWS].mean(axis=0).tolist()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_iir_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ml_audio_restoration_torch.ops import _build, iir

    parent = [_parent_run(args.parent)] if args.parent else []
    libs = {name: ctypes.CDLL(str(lib)) for name, lib in
            _build_all(sources(ROOT / "ml_audio_restoration_torch" /
                               "csrc")).items()}
    x, gy, coef, z0 = _inputs(torch)
    times, outs = {}, {}
    for name in list(libs) + list(reversed(libs)):
        _build._loaded[iir.LIBRARY] = libs[name]
        outs.setdefault(name, iir._sos_forward(x, coef, z0))
        times.setdefault(name, []).append(
            (_ms(torch, lambda: iir._sos_forward(x, coef, z0)),
             _ms(torch, lambda: iir._sos_adjoint(gy, coef))))
    phases = {}
    for walk, run in (("forward", lambda: iir._sos_forward(x, coef, z0)),
                      ("adjoint", lambda: iir._sos_adjoint(gy, coef))):
        _build._loaded[iir.LIBRARY] = libs["stamps"]
        run()
        torch.cuda.synchronize()
        phases[walk] = _phase_cycles(libs["stamps"])
    _build._loaded.pop(iir.LIBRARY)
    equal = all(torch.equal(outs[name], outs["shipped"])
                for name, (_, computes) in VARIANTS.items() if computes)
    rows = {}
    for name in libs:
        rows[name] = {"forward_ms": min(t[0] for t in times[name]),
                      "adjoint_ms": min(t[1] for t in times[name])}
        print(json.dumps({"variant": name, **rows[name]}), flush=True)
    if parent:
        parent.append(_parent_run(args.parent))
        rows["parent"] = {k: min(p[k] for p in parent)
                          for k in ("forward_ms", "adjoint_ms")}
        print(json.dumps({"variant": "parent", **rows["parent"]}),
              flush=True)
    print(json.dumps({"iir_ablation": {
        "device": torch.cuda.get_device_name(0), "rows": ROWS,
        "steps": STEPS, "partition": iir.partition(STEPS), "ms": rows,
        "phase_cycles": phases, "equal": equal}}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
