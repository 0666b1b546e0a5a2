#!/usr/bin/env python3
"""Ablation of the port's recurrence kernels K1, K2 and K3 on one NVIDIA GPU.

    python3 scripts/torch_lstm_ablation.py [--parent DIR]

Builds variants of ml_audio_restoration_torch/csrc/lstm_recurrence.cu (K1)
and lstm_train.cu (K2, and K3's walk) into build/ablation/, each the
shipped source with one or more design choices taken back by a text patch,
checks every variant that still computes the function against the plain
version, and times them in turns at the main-path shapes: K1 at T=88,200
B=64 H=64 f32 (a 120 s restore), K2 and K3 at T=44,100 B=16 H=64 (a train
step). `--parent` names a directory holding an earlier checkout's
ml_audio_restoration_torch/csrc/ (for example a `git archive` of the
parent commit) whose C entry points take the arguments today's do; its
kernels are timed beside the others. Also runs the latency probe of
ml_audio_restoration_torch/ops/_latency.py and counts each design's
latency floor. Prints one JSON line per variant and, last,
{"ablation": {...}}.
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "ablation"
F32_TOL = 1e-5
K3_TOL = 2e-5


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"patch target found {text.count(old)} times: {old!r}")
    return text.replace(old, new)


# ------------------------------------------------------------ the patches
def precise(header: str) -> str:
    """expf and an IEEE division in the gate activations."""
    return _sub(header,
                "return fmaf(k, __fdividef(1.0f, 1.0f + __expf(-k * x)), "
                "1.0f - k);",
                "return fmaf(k, 1.0f / (1.0f + expf(-k * x)), 1.0f - k);")


def k1_two_barriers(src: str) -> str:
    """One h buffer: a second barrier before h is overwritten."""
    src = _sub(src, "reinterpret_cast<const float4*>(h_s[p & 1]);",
               "reinterpret_cast<const float4*>(h_s[0]);")
    return _sub(src, "      if (r == 0) {\n        h_s[(p + 1) & 1][u] =",
                "      __syncthreads();\n      if (r == 0) {\n"
                "        h_s[0][u] =")


K1_FETCH = ("      if (p == 0) fetch(t0 + BLOCK);  // into the half the last "
            "block read\n")
K3_FETCH = ("      if (p == 0) fetch(s0 + BWD_BLOCK);  // into the half the "
            "last block read\n")
K2_COPY = ("      if (p == 0) copy_gates(t0 + FWD_BLOCK);  // into the half "
           "last read\n")
K2_STORES = """      // the residuals, off the step chain
#pragma unroll
      for (int q = 0; q < NG; ++q) a_ptr[t * g_stride + q * H] = act[q];
      s_ptr[t * h_stride] = r == 0 ? h : c;
"""


def k1_direct_loads(src: str) -> str:
    """Gates loaded from device memory in the step, no block copies."""
    src = _sub(src, "  fetch(0);\n  cp_async_wait<0>();\n", "")
    src = _sub(src, K1_FETCH, "")
    src = _sub(src, "      if (p == BLOCK - 1) cp_async_wait<0>();  // the "
               "next block landed\n", "")
    return _sub(src, "const T* g_in = g_blk[p] + NG * r * H + u;",
                "const T* g_in = gx + (static_cast<size_t>(t) * batch + b) * G"
                " + NG * r * H + u;")


def k2_direct_loads(src: str) -> str:
    """Gates loaded from device memory in the step, no block copies."""
    src = _sub(src, "  copy_gates(0);\n  cp_async_wait<0>();\n", "")
    src = _sub(src, K2_COPY, "")
    src = _sub(src, "      if (p == FWD_BLOCK - 1) cp_async_wait<0>();  // the "
               "next block landed\n", "")
    return _sub(src, "const T* g_in = g_blk[p] + NG * r * H + u;",
                "const T* g_in = gx + (static_cast<size_t>(t) * batch + b) * G"
                " + NG * r * H + u;")


def k2_no_copies(src: str) -> str:
    """Timing only: the first block of gate rows is used over and over."""
    return _sub(src, K2_COPY, "")


def k2_no_stores(src: str) -> str:
    """Timing only: no acts, out or cseq stores (hf and cf stay)."""
    return _sub(src, K2_STORES, "")


def k1_no_copies(src: str) -> str:
    """Timing only: the first block of gate rows is used over and over."""
    return _sub(src, K1_FETCH, "")


def k1_lanes4(src: str) -> str:
    return _sub(src, "constexpr int LANES = 2;", "constexpr int LANES = 4;")


def k3_lanes4(src: str) -> str:
    return _sub(src, "constexpr int BWD_LANES = 2;",
                "constexpr int BWD_LANES = 4;")


def k3_direct_loads(src: str) -> str:
    """Residuals loaded from device memory in the step, no block copies."""
    src = _sub(src, "  fetch(0);\n  cp_async_wait<0>();\n", "")
    src = _sub(src, K3_FETCH, "")
    src = _sub(src, "      if (p == BWD_BLOCK - 1) cp_async_wait<0>();  // the"
               " next block landed\n", "")
    return _sub(src, """      const float* res = res_blk[p];
      const float ig = res[k], fg = res[H + k];
      const float gg = res[2 * H + k], og = res[3 * H + k];
      const float d_out = res[G + k], c_p = res[G + H + k];
""", """      const float* ar = acts + t * g_stride + b * G;
      const float ig = ar[k], fg = ar[H + k];
      const float gg = ar[2 * H + k], og = ar[3 * H + k];
      const float d_out = dout[t * h_stride + h_row];
      const float c_p = t > 0 ? cseq[(t - 1) * h_stride + h_row] : c0[h_row];
""")


def k3_no_copies(src: str) -> str:
    """Timing only: the first block of residual rows is used over and
    over."""
    return _sub(src, K3_FETCH, "")


def k3_dw_on_chain(src: str) -> str:
    """Timing only (4 lanes a unit): each lane also accumulates its gate's
    dW_hh column, 64 FMAs a step after the barrier, against a shared-memory
    vector of H values standing in for h_{t-1}; the partial is kept live
    but not written out."""
    src = _sub(src, "  for (int s0 = 0; s0 < steps; s0 += BWD_BLOCK) {\n",
               "  float dw_acc[H] = {};\n"
               "  for (int s0 = 0; s0 < steps; s0 += BWD_BLOCK) {\n")
    src = _sub(src, "      __syncthreads();  // d_lin of step t is visible\n",
               "      __syncthreads();  // d_lin of step t is visible\n"
               "      {\n        const float own = pick(dl, NG * r);\n"
               "#pragma unroll\n        for (int m = 0; m < H; ++m)\n"
               "          dw_acc[m] = fmaf(dlin_s[p & 1][m], own, dw_acc[m]);"
               "\n      }\n")
    return _sub(src, "  if (r == 0) {\n    dh0[b * H + k] = dh;",
                "  float keep = 0.0f;\n#pragma unroll\n"
                "  for (int m = 0; m < H; ++m) keep += dw_acc[m];\n"
                "  if (keep == 1.2345e-30f) dgx[0] = keep;\n"
                "  if (r == 0) {\n    dh0[b * H + k] = dh;")


# --------------------------------------------------------------- building
def _variants(csrc: Path, parent: Path | None):
    """name -> (kernel, {file name: text}, computes the function?)"""
    k1 = (csrc / "lstm_recurrence.cu").read_text()
    k23 = (csrc / "lstm_train.cu").read_text()
    hdr = (csrc / "lstm_common.cuh").read_text()
    pre = precise(hdr)
    v = {
        "k1_shipped": ("k1", k1, hdr, True),
        "k1_direct_loads": ("k1", k1_direct_loads(k1), hdr, True),
        "k1_no_copies": ("k1", k1_no_copies(k1), hdr, False),
        "k1_two_barriers": ("k1", k1_two_barriers(k1), hdr, True),
        "k1_precise": ("k1", k1, pre, True),
        "k1_layout_only": ("k1", k1_two_barriers(k1_direct_loads(k1)), pre,
                           True),
        "k1_layout_copies": ("k1", k1_two_barriers(k1), pre, True),
        "k1_layout_copies_1bar": ("k1", k1, pre, True),
        "k1_lanes4": ("k1", k1_lanes4(k1), hdr, True),
        "k2_shipped": ("k2", k23, hdr, True),
        "k2_precise": ("k2", k23, pre, True),
        "k2_direct_loads": ("k2", k2_direct_loads(k23), hdr, True),
        "k2_no_copies": ("k2", k2_no_copies(k23), hdr, False),
        "k2_no_stores": ("k2", k2_no_stores(k23), hdr, False),
        "k3_shipped": ("k3", k23, hdr, True),
        "k3_direct_loads": ("k3", k3_direct_loads(k23), hdr, True),
        "k3_no_copies": ("k3", k3_no_copies(k23), hdr, False),
        "k3_precise": ("k3", k23, pre, True),
        "k3_lanes4": ("k3", k3_lanes4(k23), hdr, True),
        "k3_lanes4_dw_on_chain": ("k3", k3_dw_on_chain(k3_lanes4(k23)), hdr,
                                  False),
    }
    out = {}
    for name, (kern, src, header, exact) in v.items():
        file = "lstm_recurrence.cu" if kern == "k1" else "lstm_train.cu"
        out[name] = (kern, {file: src, "lstm_common.cuh": header}, exact)
    if parent is not None:
        pc = parent / "ml_audio_restoration_torch" / "csrc"
        common = ({"lstm_common.cuh": (pc / "lstm_common.cuh").read_text()}
                  if (pc / "lstm_common.cuh").exists() else {})
        train = (pc / "lstm_train.cu").read_text()
        out["k1_parent"] = ("k1", {"lstm_recurrence.cu": (
            pc / "lstm_recurrence.cu").read_text(), **common}, True)
        out["k2_parent"] = ("k2", {"lstm_train.cu": train, **common}, True)
        out["k3_parent"] = ("k3", {"lstm_train.cu": train, **common}, True)
    return out


def _build_one(d: Path, name: str, files: dict):
    """Write `files` into directory d and build the .cu among them into
    lib<name>.so -> (the library, the registers its kernels use, bytes
    spilled)."""
    from ml_audio_restoration_torch.ops import _build

    d.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (d / f).write_text(text)
    main = next(f for f in files if f.endswith(".cu"))
    lib = d / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(lib), str(d / main)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", proc.stderr)]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", proc.stderr))
    return ctypes.CDLL(str(lib)), sorted(set(regs)), spills


def _build_all(variants) -> dict:
    """Builds every variant into OUT and, beside them, the latency probe."""
    from ml_audio_restoration_torch.ops import _build, _latency

    shutil.rmtree(OUT, ignore_errors=True)

    def one(item):
        name, (_, files, _) = item
        return name, _build_one(OUT / name, name, files)

    with ThreadPoolExecutor(8) as pool:
        probe = pool.submit(_build.build, _latency.PROBE)
        libs = dict(pool.map(one, variants.items()))
        probe.result()
    return libs


# ---------------------------------------------------------------- running
def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from ml_audio_restoration_torch.ops import _build, _latency
    from ml_audio_restoration_torch.ops import lstm as L

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    variants = _variants(_build.CSRC, args.parent)
    libs = _build_all(variants)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def k1_call(lib, g, w, h0, c0):
        t, b, g4 = g.shape
        out = torch.empty((b, t, g4 // 4), device=dev)
        hf, cf = torch.empty_like(h0), torch.empty_like(c0)
        L._launch("k1", lib.lstm_recurrence, 7, 4,
                  [g.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                   out.data_ptr(), hf.data_ptr(), cf.data_ptr(), t, b,
                   g4 // 4, 0], dev)
        return out, hf, cf

    def k2_call(lib, g, w, h0, c0):
        t, b, g4 = g.shape
        out = torch.empty((t, b, g4 // 4), device=dev)
        cseq, acts = torch.empty_like(out), torch.empty_like(g)
        hf, cf = torch.empty_like(h0), torch.empty_like(c0)
        L._launch("k2", lib.lstm_train_fwd, 9, 4,
                  [g.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                   out.data_ptr(), hf.data_ptr(), cf.data_ptr(),
                   acts.data_ptr(), cseq.data_ptr(), t, b, g4 // 4, 0], dev)
        return out, hf, cf, acts, cseq

    def k3_call(lib, res, w, h0, c0, dout, dhf, dcf):
        out, acts, cseq = res
        t, b, g4 = acts.shape
        dgx = torch.empty_like(acts)
        dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
        L._launch("k3", lib.lstm_train_bwd, 10, 3,
                  [acts.data_ptr(), cseq.data_ptr(), dout.data_ptr(),
                   w.data_ptr(), c0.data_ptr(), dhf.data_ptr(),
                   dcf.data_ptr(), dgx.data_ptr(), dh0.data_ptr(),
                   dc0.data_ptr(), t, b, g4 // 4], dev)
        return dgx, None, dh0, dc0

    def dev_max(a, b):
        return float((a - b).abs().max())

    def timed(fn, reps=2):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    # checks at a small shape: odd T, B not a multiple of 8, a carry in
    t, b, h = 301, 5, 64
    g, w = randn(t, b, 4 * h, scale=0.5), randn(h, 4 * h, scale=0.15)
    h0, c0 = randn(b, h, scale=0.3), randn(b, h, scale=0.3)
    dout, dhf, dcf = (randn(t, b, h, scale=0.1), randn(b, h, scale=0.1),
                      randn(b, h, scale=0.1))
    want1 = L.lstm_recurrence_plain(g, w, h0, c0)
    want2 = L.lstm_recurrence_train_plain(g, w, h0, c0)
    out, _, _, acts, cseq = want2
    want3 = L.lstm_recurrence_bwd_plain(acts, cseq, out, h0, c0, w, dout,
                                        dhf, dcf)
    checks = {}
    for name, (kind, _, exact) in variants.items():
        lib = libs[name][0]
        if kind == "k1":
            got = k1_call(lib, g, w, h0, c0)
            checks[name] = max(dev_max(x, y) for x, y in zip(got, want1))
        elif kind == "k2":
            got = k2_call(lib, g, w, h0, c0)
            checks[name] = max(dev_max(x, y) for x, y in zip(got, want2))
        else:
            got = k3_call(lib, (out, acts, cseq), w, h0, c0, dout, dhf, dcf)
            checks[name] = max(dev_max(got[i], want3[i]) for i in (0, 2, 3))
        bar = K3_TOL if kind == "k3" else F32_TOL
        if exact and not checks[name] <= bar:
            raise AssertionError(f"{name} disagrees with plain: "
                                 f"{checks[name]}")
    del g, out, acts, cseq, dout, want2

    # K1 at the restore shape
    t1, b1 = 88200, 64
    g1, w1 = randn(t1, b1, 4 * h, scale=0.5), randn(h, 4 * h, scale=0.15)
    z1 = torch.zeros(b1, h, device=dev)
    # K2 and K3 at the training shape, K3's residuals from K2
    t3, b3 = 44100, 16
    g3 = randn(t3, b3, 4 * h, scale=0.5)
    h03, c03 = randn(b3, h, scale=0.3), randn(b3, h, scale=0.3)
    out3, _, _, acts3, cseq3 = L._lstm_train_fwd_cuda(g3, w1, h03, c03)
    dout3, dhf3, dcf3 = (randn(t3, b3, h, scale=0.1),
                         randn(b3, h, scale=0.1), randn(b3, h, scale=0.1))
    res3 = (out3, acts3, cseq3)
    calls = {"k1": lambda lib: k1_call(lib, g1, w1, z1, z1),
             "k2": lambda lib: k2_call(lib, g3, w1, h03, c03),
             "k3": lambda lib: k3_call(lib, res3, w1, h03, c03, dout3, dhf3,
                                       dcf3)}
    times = {name: [] for name in variants}
    for _ in range(args.rounds):
        for name, (kind, _, _) in variants.items():
            lib = libs[name][0]
            times[name].append(timed(lambda: calls[kind](lib)))
    dgx3 = k3_call(libs["k3_shipped"][0], res3, w1, h03, c03, dout3, dhf3,
                   dcf3)[0]
    dw_ms = [timed(lambda: L._dw_pass(out3, h03, dgx3), 5)
             for _ in range(args.rounds)]
    steps = {"k1": t1, "k2": t3, "k3": t3}
    probe = _latency.step_floor(h, steps, dev)
    print(json.dumps(probe), flush=True)
    rows = {}
    for name, (kind, _, exact) in variants.items():
        ms = min(times[name])
        rows[name] = {"ms": times[name], "ns_per_step": ms * 1e6 / steps[kind],
                      "max_abs_err_small": checks[name],
                      "computes_the_function": exact,
                      "registers": libs[name][1], "spills": libs[name][2]}
        print(json.dumps({"variant": name, **rows[name]}), flush=True)
    print(json.dumps({"dw_pass_ms": dw_ms,
                      "splits": L._dw_splits(t3 * b3)}), flush=True)
    print(json.dumps({"ablation": {"device": smi, "k1_shape": [t1, b1, h],
                                   "k2_k3_shape": [t3, b3, h],
                                   "variants": rows, "dw_pass_ms": dw_ms,
                                   **probe}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
