#!/usr/bin/env python3
"""Ablation of the port's int8 conv (csrc/int8_conv.cu) on one NVIDIA GPU.

    python3 scripts/torch_int8_ablation.py [--parent DIR]

Builds variants of ml_audio_restoration_torch/csrc/int8_conv.cu into
build/ablation/, each the shipped source with one design choice taken back
(or one part cut out, to see what it costs) by a text patch, and times
them in turns (shipped first and last) on the 20 distinct int8 layers of
the default 64-chunk program, at their shapes, on seeded random s8 inputs.
A variant that still computes the function must equal the shipped kernel
bit for bit. `--parent DIR` names an earlier checkout (for example a `git
archive` of the parent commit) whose own package times its own kernel on
the same inputs, in a subprocess before and after this one's; its outputs
must equal the shipped kernel's too. Prints one JSON line per layer and,
last, {"int8_ablation": {...}} with each variant's program total (ms, each
layer times its count in the program). Needs a CUDA card; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "ablation"

# (layer, count in the program, x [N, T_in, Cin], kernel [kp, Cin, Cout],
# stride, lhs dilation, padding, add, activation, output): the default
# int8 program at 64 chunks of 2 s (chip_smoke.py's int8_layer rows)
LAYERS = [
    ("denoiser:enc0.c1", 1, (64, 44100, 1), (6, 1, 128), 4, 1, (1, 1),
     None, "lrelu", "s8"),
    ("denoiser:enc0.c2", 6, (64, 11025, 128), (3, 128, 128), 1, 1, (1, 1),
     None, "lrelu", "s8"),
    ("denoiser:enc1.c1", 1, (64, 11025, 64), (3, 64, 128), 1, 1, (1, 1),
     None, "lrelu", "s8"),
    ("denoiser:dec1.c1#0", 2, (64, 11025, 128), (3, 128, 128), 1, 1, (1, 1),
     None, None, "f32"),
    ("denoiser:dec1.c1#1", 2, (64, 11025, 128), (3, 128, 128), 1, 1, (1, 1),
     "f32", "lrelu", "f32"),
    ("denoiser:td1", 1, (64, 11025, 64), (3, 64, 32), 1, 1, (1, 1), None,
     "lrelu", "s8"),
    ("denoiser:td2", 1, (64, 11025, 32), (6, 32, 1), 1, 4, (4, 4), None,
     None, "f32"),
    ("super_resolution:stem", 1, (64, 44100, 1), (10, 1, 128), 4, 1, (3, 3),
     None, "lrelu", "s8"),
    ("super_resolution:blk0.c2", 5, (64, 11025, 128), (3, 128, 128), 1, 1,
     (1, 1), "s8", None, "s8"),
    ("super_resolution:up0", 1, (64, 11025, 128), (3, 128, 256), 1, 1,
     (1, 1), None, "lrelu", "s8"),
    ("super_resolution:hf", 1, (64, 11025, 256), (3, 256, 256), 1, 1, (1, 1),
     None, "lrelu", "s8"),
    ("super_resolution:recon", 1, (64, 11025, 256), (14, 256, 1), 1, 8,
     (10, 10), None, None, "f32"),
    ("stereo:stem", 1, (64, 88200, 1), (10, 1, 128), 4, 1, (3, 3), None,
     "lrelu", "s8"),
    ("stereo:b0.d", 1, (64, 22050, 128), (3, 128, 256), 1, 1, (1, 1), None,
     "lrelu", "s8"),
    ("stereo:b0.p", 1, (64, 22050, 256), (1, 256, 256), 1, 1, (0, 0), None,
     "lrelu", "s8"),
    ("stereo:b1.d", 1, (64, 22050, 256), (8, 256, 128), 1, 4, (5, 5), None,
     "lrelu", "f32"),
    ("stereo:left.l1", 2, (64, 88200, 64), (8, 64, 256), 2, 1, (3, 3), None,
     "lrelu", "s8"),
    ("stereo:left.l2", 2, (64, 44100, 256), (5, 256, 128), 1, 1, (2, 2),
     None, "lrelu", "s8"),
    ("stereo:left.l3", 2, (64, 44100, 128), (5, 128, 64), 1, 1, (2, 2), None,
     "lrelu", "s8"),
    ("stereo:left.final", 2, (64, 44100, 64), (8, 64, 1), 1, 2, (4, 4),
     None, None, "f32"),
]


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"patch target found {text.count(old)} times: {old!r}")
    return text.replace(old, new)


# ------------------------------------------------------------ the patches
def no_epilogue(src: str) -> str:
    """The wgmma path without its epilogue (nothing written): what the
    loads, the wgmma and the staging cost alone."""
    return _sub(src, "  tile_epilogue<N>(a, st, n, c, j0, col0, tid);\n}\n\n"
                "// Path 2", "}\n\n// Path 2")


def no_mma(src: str) -> str:
    """The wgmma path without its wgmma: the loads and the epilogue."""
    return _sub(src, "      wgmma<N>(acc, make_desc(as + kk, lbo_a, sbo, "
                "layout),\n               make_desc(bs + kk, lbo_b, sbo, "
                "layout));", "      ;")


def rint_convert(src: str) -> str:
    """Requantization through rintf and a float-to-int conversion, as the
    first design did (conversions issue at an eighth of the f32 rate)."""
    return _sub(src, "  const float q = fminf(fmaxf(__fmul_rn(y, inv), "
                "-127.0f), 127.0f);\n  return static_cast<int8_t>("
                "__float_as_int(__fadd_rn(q, 12582912.0f)));",
                "  const float q = rintf(__fmul_rn(y, inv));\n  return "
                "static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));")


def batch_every_n(src: str) -> str:
    """The epilogue's eight-row batch of residual loads for every N tile
    (its registers cut the CTAs an SM of the narrow exits)."""
    return _sub(src, "  constexpr int kBatch = N > 32 ? 8 : 1;",
                "  constexpr int kBatch = 8;")


# variant -> (patch or None, computes the function)
VARIANTS = {"shipped": (None, True), "no_epilogue": (no_epilogue, False),
            "no_mma": (no_mma, False), "rint_convert": (rint_convert, True),
            "batch_every_n": (batch_every_n, True)}


def sources(csrc: Path) -> dict[str, str]:
    text = (csrc / "int8_conv.cu").read_text()
    return {name: patch(text) if patch else text
            for name, (patch, _) in VARIANTS.items()}


def _build_all(texts: dict[str, str]) -> dict[str, Path]:
    from ml_audio_restoration_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        cu, lib = OUT / f"int8_{name}.cu", OUT / f"libint8_{name}.so"
        cu.write_text(text)
        proc = subprocess.run([_build._nvcc(), *_build._flags("int8_conv"),
                               "-o", str(lib), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        return name, lib

    with ThreadPoolExecutor(len(texts)) as pool:
        return dict(pool.map(one, texts.items()))


def _case(torch, ic, layer, seed):
    _, _, xs, ks, s, d, pad, add, act, out = layer
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    ints = lambda *shape: torch.randint(  # noqa: E731
        -127, 128, shape, generator=g, device=dev).to(torch.int8)
    cout = ks[2]
    weight = ic.Int8Weight(ints(*ks), torch.rand(cout, generator=g,
                                                 device=dev) * 1e-4,
                           torch.randn(cout, generator=g, device=dev))
    t_out = ic.out_length(xs[1], ks[0], s, d, pad)
    kw = dict(stride=s, lhs_dilation=d, padding=pad, act=act)
    if add == "f32":
        kw["add"] = torch.randn((xs[0], t_out, cout), generator=g, device=dev)
    elif add == "s8":
        kw["add"] = ints(xs[0], t_out, cout)
        kw["add_scale"] = torch.rand(cout, generator=g, device=dev) * 1e-2
    if out == "s8":
        kw["out_inv"] = 1.0 / (torch.rand(cout, generator=g, device=dev)
                               * 3e-2 + 1e-3)
    return ints(*xs), weight, kw


def _ms(torch, fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _digest(y) -> str:
    import torch

    return hashlib.sha256(y.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def time_package() -> dict:
    """This process's package, its own build of its kernel: {layer: (ms,
    output digest)}. Run with an earlier checkout first on sys.path."""
    import torch
    from ml_audio_restoration_torch.ops import int8_conv as ic

    rows = {}
    for i, layer in enumerate(LAYERS):
        x, weight, kw = _case(torch, ic, layer, seed=i)
        y = ic.int8_conv(x, weight, **kw)
        rows[layer[0]] = (min(_ms(torch, lambda: ic.int8_conv(
            x, weight, **kw)) for _ in range(2)), _digest(y))
        del x, weight, kw, y
        torch.cuda.empty_cache()
    return rows


def _parent_run(parent: Path) -> dict:
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "sys.path.insert(1, sys.argv[2]); import torch_int8_ablation as "
            "a; print(json.dumps(a.time_package()))")
    proc = subprocess.run([sys.executable, "-c", code, str(parent),
                           str(ROOT / "scripts")], capture_output=True,
                          text=True, cwd=parent)
    if proc.returncode:
        raise RuntimeError(f"parent run failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_int8_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ml_audio_restoration_torch.ops import _build
    from ml_audio_restoration_torch.ops import int8_conv as ic

    parent = [_parent_run(args.parent)] if args.parent else []
    libs = {name: ctypes.CDLL(str(lib)) for name, lib in
            _build_all(sources(ROOT / "ml_audio_restoration_torch" /
                               "csrc")).items()}
    order = list(libs) + list(reversed(libs))
    totals = dict.fromkeys(libs, 0.0)
    equal = True
    rows = []
    for i, layer in enumerate(LAYERS):
        x, weight, kw = _case(torch, ic, layer, seed=i)
        times, outs = {}, {}
        for name in order:
            _build._loaded["int8_conv"] = libs[name]
            run = lambda: ic.int8_conv(x, weight, **kw)  # noqa: E731
            outs.setdefault(name, run())
            times.setdefault(name, []).append(_ms(torch, run))
        _build._loaded.pop("int8_conv")
        same = {name: bool(torch.equal(outs[name].view(torch.uint8),
                                       outs["shipped"].view(torch.uint8)))
                for name, (_, computes) in VARIANTS.items() if computes}
        equal &= all(same.values())
        row = {"layer": layer[0], "count": layer[1],
               "path": ic.plan(layer[2], layer[3], layer[4], layer[5],
                               layer[6]).path,
               "ms": {name: min(v) for name, v in times.items()},
               "equal_to_shipped": same}
        if parent:
            row["digest_equal_parent"] = (
                parent[0][layer[0]][1] == _digest(outs["shipped"]))
            equal &= row["digest_equal_parent"]
        for name in libs:
            totals[name] += layer[1] * row["ms"][name]
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, weight, kw, outs
        torch.cuda.empty_cache()
    if parent:
        parent.append(_parent_run(args.parent))
        for row in rows:
            row["ms"]["parent"] = min(p[row["layer"]][0] for p in parent)
        totals["parent"] = sum(r["count"] * r["ms"]["parent"] for r in rows)
    print(json.dumps({"int8_ablation": {
        "device": torch.cuda.get_device_name(0), "program_ms": totals,
        "equal": equal}}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
