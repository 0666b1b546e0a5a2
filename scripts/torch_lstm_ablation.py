#!/usr/bin/env python3
"""Ablation of the port's recurrence kernels K1 and K3 on one NVIDIA GPU.

    python3 scripts/torch_lstm_ablation.py [--parent DIR]

Builds variants of ml_audio_restoration_torch/csrc/lstm_recurrence.cu (K1)
and lstm_train.cu (K3's walk) into build/ablation/, each the shipped source
with one or more design choices taken back by a text patch, checks every
variant that still computes the function against the plain version, and
times them in turns at the main-path shapes: K1 at T=88,200 B=64 H=64 f32
(a 120 s restore), K3 at T=44,100 B=16 H=64 (a train step). `--parent`
names a directory holding an earlier checkout's
ml_audio_restoration_torch/csrc/ (for example a `git archive` of the
parent commit); its kernels are timed beside the others. Prints one JSON
line per variant and, last, {"ablation": {...}}. Needs a CUDA card; imports
nothing of JAX.
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


def k1_direct_loads(src: str) -> str:
    """Gates loaded from device memory in the step, no block copies."""
    src = _sub(src, "  fetch(0);\n  cp_async_wait<0>();\n", "")
    src = _sub(src, K1_FETCH, "")
    src = _sub(src, "      if (p == BLOCK - 1) cp_async_wait<0>();  // the "
               "next block landed\n", "")
    return _sub(src, "const T* g_in = g_blk[p] + NG * r * H + u;",
                "const T* g_in = gx + (static_cast<size_t>(t) * batch + b) * G"
                " + NG * r * H + u;")


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


# -------------------------------------------------- the step's latencies
# Cycles of the building blocks of a recurrence step, each a dependent chain
# of n links timed with clock64 in a block of 128 threads (K1's and K3's
# block at H = 64): an FFMA, an FADD, one gate activation (gate_act), a
# shuffle plus an FADD, and one shared-memory round trip through the step's
# barrier (STS, __syncthreads, LDS of another thread's value, FADD).
LATENCY_CU = r"""
#include "lstm_common.cuh"

#define CHAIN(slot, body)                                   \
  x = x + 0.0f * static_cast<float>(clock64() & 1);         \
  t0 = clock64();                                           \
  for (int i = 0; i < n; ++i) { body; }                     \
  asm volatile("" ::"f"(x));                                \
  t1 = clock64();                                           \
  if (tid == 0) out[slot] = t1 - t0;

__global__ void latency_kernel(long long* out, float* sink, int n) {
  __shared__ float s[2][128];
  const int tid = threadIdx.x;
  float x = 0.5f + tid * 1e-6f;
  long long t0, t1;
  s[0][tid] = x;
  __syncthreads();
  CHAIN(0, x = fmaf(x, 0.9999f, 1e-4f))
  CHAIN(1, x = x + 1e-7f)
  CHAIN(2, x = gate_act(x, 1.0f))
  CHAIN(3, x = __shfl_xor_sync(FULL_MASK, x, 1) + 1e-7f)
  CHAIN(4, s[i & 1][tid] = x; __syncthreads();
           x = s[i & 1][(tid + 1) & 127] + 1e-7f)
  sink[tid] = x;
}

extern "C" int latency(long long* out, float* sink, int n, void* stream) {
  latency_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, sink,
                                                                    n);
  return static_cast<int>(cudaGetLastError());
}
"""
CHAINS = ("ffma", "fadd", "gate_act", "shfl_fadd", "sts_bar_lds_fadd")


def floor_cycles(lat: dict, hidden: int) -> dict:
    """Cycles a step of each redesigned kernel needs if every instruction
    on its critical path issued the moment its operands were ready: the
    chain of dependent operations counted from the sources, at the measured
    latencies, with the h @ W_hh (K1) or d_lin @ W_hh^T (K3) products at
    the larger of their FMA issue time (H * 4H FMAs on the SM's 128 f32
    lanes) and their dependent depth (16 FMAs an accumulator at H = 64)."""
    fma = max(hidden * 4 * hidden / 128, (hidden // 4) * lat["ffma"])
    shfl = lat["shfl_fadd"] - lat["fadd"]
    k1 = (lat["sts_bar_lds_fadd"] + fma + lat["fadd"]    # h in, product
          + lat["shfl_fadd"]                            # reduce_gates
          + lat["fadd"] + lat["gate_act"]               # + gx, activate
          + shfl                                        # gather i, f, g, o
          + 2 * lat["ffma"] + lat["gate_act"]           # c, tanh(c)
          + lat["ffma"])                                # h
    k3 = (lat["sts_bar_lds_fadd"] + fma                 # d_lin in, product
          + 3 * lat["fadd"] + lat["shfl_fadd"]          # tree, butterfly
          + lat["fadd"] + 2 * lat["ffma"]               # dh_tot, dct
          + 2 * lat["ffma"])                            # d_lin
    return {"k1": k1, "k3": k3}


# --------------------------------------------------------------- building
def _variants(csrc: Path, parent: Path | None):
    """name -> (kernel, {file name: text}, computes the function?)"""
    k1 = (csrc / "lstm_recurrence.cu").read_text()
    k3 = (csrc / "lstm_train.cu").read_text()
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
        "k3_shipped": ("k3", k3, hdr, True),
        "k3_direct_loads": ("k3", k3_direct_loads(k3), hdr, True),
        "k3_no_copies": ("k3", k3_no_copies(k3), hdr, False),
        "k3_precise": ("k3", k3, pre, True),
        "k3_lanes4": ("k3", k3_lanes4(k3), hdr, True),
        "k3_lanes4_dw_on_chain": ("k3", k3_dw_on_chain(k3_lanes4(k3)), hdr,
                                  False),
    }
    out = {}
    for name, (kern, src, header, exact) in v.items():
        file = "lstm_recurrence.cu" if kern == "k1" else "lstm_train.cu"
        out[name] = (kern, {file: src, "lstm_common.cuh": header}, exact)
    if parent is not None:
        pc = parent / "ml_audio_restoration_torch" / "csrc"
        out["k1_parent"] = ("k1", {"lstm_recurrence.cu": (
            pc / "lstm_recurrence.cu").read_text()}, True)
        out["k3_parent"] = ("k3_parent", {"lstm_train.cu": (
            pc / "lstm_train.cu").read_text()}, True)
    return out


def _build_all(variants) -> dict:
    from ml_audio_restoration_torch.ops import _build

    shutil.rmtree(OUT, ignore_errors=True)
    variants = {**variants, "latency": (
        "latency", {"latency.cu": LATENCY_CU, "lstm_common.cuh": (
            _build.CSRC / "lstm_common.cuh").read_text()}, False)}

    def one(item):
        name, (_, files, _) = item
        d = OUT / name
        d.mkdir(parents=True)
        for f, text in files.items():
            (d / f).write_text(text)
        main = next(f for f in files if f.endswith(".cu"))
        lib = d / f"lib{name}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                               "-v", "-o", str(lib), str(d / main)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        regs = [int(n) for n in re.findall(r"Used (\d+) registers",
                                           proc.stderr)]
        spills = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            proc.stderr))
        return name, (ctypes.CDLL(str(lib)), sorted(set(regs)), spills)

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(one, variants.items()))


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
    from ml_audio_restoration_torch.ops import _build
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

    def k3_call(kind, lib, res, w, h0, c0, dout, dhf, dcf):
        out, acts, cseq = res
        t, b, g4 = acts.shape
        h = g4 // 4
        dgx = torch.empty_like(acts)
        dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
        if kind == "k3_parent":
            dw = torch.empty((h, g4), device=dev)
            part = torch.empty((b, h, g4), device=dev)
            L._launch("k3", lib.lstm_train_bwd, 14, 3,
                      [acts.data_ptr(), cseq.data_ptr(), out.data_ptr(),
                       dout.data_ptr(), w.data_ptr(), h0.data_ptr(),
                       c0.data_ptr(), dhf.data_ptr(), dcf.data_ptr(),
                       dgx.data_ptr(), dw.data_ptr(), dh0.data_ptr(),
                       dc0.data_ptr(), part.data_ptr(), t, b, h], dev)
            return dgx, dw, dh0, dc0
        L._launch("k3", lib.lstm_train_bwd, 10, 3,
                  [acts.data_ptr(), cseq.data_ptr(), dout.data_ptr(),
                   w.data_ptr(), c0.data_ptr(), dhf.data_ptr(),
                   dcf.data_ptr(), dgx.data_ptr(), dh0.data_ptr(),
                   dc0.data_ptr(), t, b, h], dev)
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
    out, _, _, acts, cseq = L.lstm_recurrence_train_plain(g, w, h0, c0)
    want3 = L.lstm_recurrence_bwd_plain(acts, cseq, out, h0, c0, w, dout,
                                        dhf, dcf)
    checks = {}
    for name, (kind, _, exact) in variants.items():
        lib = libs[name][0]
        if kind == "k1":
            got = k1_call(lib, g, w, h0, c0)
            checks[name] = max(dev_max(x, y) for x, y in zip(got, want1))
        else:
            got = k3_call(kind, lib, (out, acts, cseq), w, h0, c0, dout, dhf,
                          dcf)
            checks[name] = max(dev_max(got[i], want3[i]) for i in (0, 2, 3))
        bar = F32_TOL if kind == "k1" else K3_TOL
        if exact and not checks[name] <= bar:
            raise AssertionError(f"{name} disagrees with plain: "
                                 f"{checks[name]}")
    del g, out, acts, cseq, dout

    # K1 at the restore shape
    t1, b1 = 88200, 64
    g1, w1 = randn(t1, b1, 4 * h, scale=0.5), randn(h, 4 * h, scale=0.15)
    z1 = torch.zeros(b1, h, device=dev)
    # K3 at the training shape, residuals from K2
    t3, b3 = 44100, 16
    g3 = randn(t3, b3, 4 * h, scale=0.5)
    h03, c03 = randn(b3, h, scale=0.3), randn(b3, h, scale=0.3)
    out3, _, _, acts3, cseq3 = L._lstm_train_fwd_cuda(g3, w1, h03, c03)
    del g3
    dout3, dhf3, dcf3 = (randn(t3, b3, h, scale=0.1),
                         randn(b3, h, scale=0.1), randn(b3, h, scale=0.1))
    res3 = (out3, acts3, cseq3)
    times = {name: [] for name in variants}
    for _ in range(args.rounds):
        for name, (kind, _, _) in variants.items():
            lib = libs[name][0]
            if kind == "k1":
                ms = timed(lambda: k1_call(lib, g1, w1, z1, z1))
            else:
                ms = timed(lambda: k3_call(kind, lib, res3, w1, h03, c03,
                                           dout3, dhf3, dcf3))
            times[name].append(ms)
    dgx3 = k3_call("k3", libs["k3_shipped"][0], res3, w1, h03, c03, dout3,
                   dhf3, dcf3)[0]
    dw_ms = [timed(lambda: L._dw_pass(out3, h03, dgx3), 5)
             for _ in range(args.rounds)]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    n = 4096
    cycles = torch.zeros(len(CHAINS), dtype=torch.int64, device=dev)
    sink = torch.empty(128, device=dev)
    L._launch("latency", libs["latency"][0].latency, 2, 1,
              [cycles.data_ptr(), sink.data_ptr(), n], dev)
    lat = dict(zip(CHAINS, (cycles.cpu().double() / n).tolist()))
    ghz = float(clock.split(",")[0].split()[0]) / 1e3
    floor = {k: {"cycles_per_step": c, "ns_per_step": c / ghz,
                 "ms": c / ghz * (t1 if k == "k1" else t3) * 1e-6}
             for k, c in floor_cycles(lat, h).items()}
    print(json.dumps({"latency_cycles": lat, "sm_ghz": ghz, "floor": floor}),
          flush=True)
    rows = {}
    for name, (kind, _, exact) in variants.items():
        steps = t1 if kind == "k1" else t3
        ms = min(times[name])
        rows[name] = {"ms": times[name], "ns_per_step": ms * 1e6 / steps,
                      "max_abs_err_small": checks[name],
                      "computes_the_function": exact,
                      "registers": libs[name][1], "spills": libs[name][2]}
        print(json.dumps({"variant": name, **rows[name]}), flush=True)
    print(json.dumps({"dw_pass_ms": dw_ms,
                      "splits": L._dw_splits(t3 * b3)}), flush=True)
    print(json.dumps({"ablation": {"device": smi, "sm_clock": clock,
                                   "k1_shape": [t1, b1, h],
                                   "k3_shape": [t3, b3, h],
                                   "variants": rows, "dw_pass_ms": dw_ms,
                                   "latency_cycles": lat, "floor": floor}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
