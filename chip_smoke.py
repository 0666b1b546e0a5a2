#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds every CUDA kernel of the main path from csrc/;
  3. kernels - each kernel against its plain PyTorch version on the card,
               with stated tolerances, then timed at the main-path shape
               beside its bound, the plain version and a library yardstick;
  4. main    - the offline restore chain at full published widths with
               seeded random weights: kernel vs plain recurrence on a 4 s
               clip, card vs CPU on the same clip, a 120 s clip (64 bucketed
               chunks) with xRT, per-stage ms and kernel launch counts, and
               a WAV file round trip.
Then one line {"kernels": [...]} and, last, the device line
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM data sheet

F32_TOL = 1e-5      # same arithmetic, different f32 summation order
BF16_TOL = 1e-2     # a summation-order change can flip one bf16 rounding of
#                     h, and the recurrence carries that change forward
PIPE_TOL = 1e-4     # whole chain, kernel vs plain recurrence on the card
CPU_TOL = 1e-3      # whole chain, card vs CPU: the chain's parity bar


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        "nvidia-smi unavailable")
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return line


def phase_build():
    from ml_audio_restoration_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("lstm_recurrence")
    emit({"phase": "build", "kernel": "lstm_recurrence",
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds.get("lstm_recurrence")})


def _cuda_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_dev(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _lstm_segments(torch, ref, gates, seg: int):
    """cuDNN's nn.LSTM over `gates` in time segments of `seg` steps, the
    state threaded from one segment to the next -> [T, B, H]."""
    outs, state = [], None
    for s in range(0, gates.shape[0], seg):
        out, state = ref(gates[s:s + seg], state)
        outs.append(out)
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def phase_kernels(torch):
    from ml_audio_restoration_torch.ops import lstm as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # f32 with a random carry in
    t, b, h = 1001, 13, 64
    gates = randn(t, b, 4 * h, scale=0.5)
    w_hh = randn(h, 4 * h, scale=0.15)
    h0, c0 = randn(b, h, scale=0.3), randn(b, h, scale=0.3)
    k = L._lstm_recurrence_cuda(gates, w_hh, h0, c0)
    p = L.lstm_recurrence_plain(gates, w_hh, h0, c0)
    torch.cuda.synchronize()
    f32_err = max(_max_dev(x, y) for x, y in zip(k, p))
    # two halves with the carry threaded through == one run
    a = L._lstm_recurrence_cuda(gates[:500], w_hh, h0, c0)
    z = L._lstm_recurrence_cuda(gates[500:], w_hh, a[1], a[2])
    halves_err = max(_max_dev(torch.cat([a[0], z[0]], dim=1), k[0]),
                     _max_dev(z[1], k[1]), _max_dev(z[2], k[2]))
    # bf16 gates and W_hh: bf16 output, f32 carry
    gb, wb = gates.bfloat16(), w_hh.bfloat16()
    kb = L._lstm_recurrence_cuda(gb, wb, h0, c0)
    pb = L.lstm_recurrence_plain(gb, wb, h0, c0)
    torch.cuda.synchronize()
    bf16_err = max(_max_dev(x, y) for x, y in zip(kb, pb))
    check = {"phase": "kernel_check", "kernel": "lstm_recurrence",
             "shape": [t, b, h], "f32_max_abs_err": f32_err,
             "f32_tol": F32_TOL, "halves_max_abs_err": halves_err,
             "halves_tol": F32_TOL, "bf16_out_dtype": str(kb[0].dtype),
             "bf16_max_abs_err": bf16_err, "bf16_tol": BF16_TOL}
    emit(check)
    if not (f32_err <= F32_TOL and halves_err <= F32_TOL
            and bf16_err <= BF16_TOL and kb[0].dtype == torch.bfloat16):
        raise AssertionError(f"lstm_recurrence disagrees with plain: {check}")

    # the main-path shape: 120 s restore, 64 chunks of 88,200 steps after SR
    t, b, h = 88200, 64, 64
    gates = randn(t, b, 4 * h, scale=0.5)
    w_hh = randn(h, 4 * h, scale=0.15)
    h0 = torch.zeros(b, h, device=dev)
    c0 = torch.zeros(b, h, device=dev)
    run_k = lambda: L._lstm_recurrence_cuda(gates, w_hh, h0, c0)  # noqa: E731
    out_k = run_k()
    ms = _cuda_ms(torch, run_k, 3)
    plain_ms = _cuda_ms(
        torch, lambda: L.lstm_recurrence_plain(gates, w_hh, h0, c0), 1)
    # yardstick only, never called by the port: cuDNN's LSTM with an
    # identity input projection computes the same recurrence on the gates
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.nn.LSTM(4 * h, h).to(dev).eval()
    with torch.no_grad():
        ref.weight_ih_l0.copy_(torch.eye(4 * h, device=dev))
        ref.weight_hh_l0.copy_(w_hh.T)
        ref.bias_ih_l0.zero_()
        ref.bias_hh_l0.zero_()
    # cuDNN refuses the whole 88,200-step sequence in one call
    # (CUDNN_STATUS_NOT_SUPPORTED, H100, torch 2.11) and takes 44,100: run
    # it in two halves with (h, c) threaded through, the same function
    seg = 44100
    run_lib = lambda: _lstm_segments(torch, ref, gates, seg)  # noqa: E731
    with torch.inference_mode():
        out_lib = run_lib()
        library_ms = _cuda_ms(torch, run_lib, 2)
    lib_dev = _max_dev(out_lib.transpose(0, 1), out_k[0])
    del out_lib, ref
    n_bytes = 4 * (t * b * 5 * h + h * 4 * h + 4 * b * h)
    flops = 2.0 * t * b * h * 4 * h  # the h @ W_hh products
    bound_bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    bound_ops_ms = flops / H100_F32_FLOPS * 1e3
    timing = {"phase": "kernel_time", "kernel": "lstm_recurrence",
              "shape": [t, b, h], "dtype": "float32", "ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library_segment_steps": seg,
              "library_vs_kernel_max_abs": lib_dev,
              "bytes": n_bytes, "flops": flops,
              "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_ops_ms,
              "ns_per_step": ms * 1e6 / t}
    emit(timing)
    del gates, out_k
    torch.cuda.empty_cache()
    return {"name": "lstm_recurrence", "route": "cuda",
            "source": "ml_audio_restoration_torch/csrc/lstm_recurrence.cu",
            "replaces": "ml_audio_restoration_tpu/ops/pallas/lstm.py:59",
            "max_abs_err": f32_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
            "library_ms": library_ms}


def _models(torch, dev):
    from ml_audio_restoration_torch.models import (
        AudioDenoiser, AudioSuperResolution, StereoSeparator, init_params)

    gen = torch.Generator(device=dev).manual_seed(0)
    models = []
    for m in (AudioDenoiser(), AudioSuperResolution(), StereoSeparator()):
        m = init_params(m.to(dev), gen)
        with torch.no_grad():  # random BN statistics, not the 0/1 init
            for bn in m.modules():
                if isinstance(bn, torch.nn.BatchNorm1d):
                    shape = bn.running_mean.shape
                    u = lambda: torch.rand(shape, generator=gen,  # noqa: E731
                                           device=dev)
                    bn.running_mean.copy_((u() - 0.5) * 0.2)
                    bn.running_var.copy_(u() + 0.5)
                    bn.weight.copy_(u() + 0.5)
                    bn.bias.copy_((u() - 0.5) * 0.2)
        models.append(m.eval())
    return models


def _clip(seconds: float, rate: int, seed: int) -> np.ndarray:
    """A mono test signal: two tones, hiss and sparse clicks, RMS ~0.1."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 0.1 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.sin(2 * np.pi * 1330 * t)
    x = x + 0.02 * rng.standard_normal(n)
    clicks = rng.integers(0, n, size=max(1, n // 5000))
    x[clicks] += rng.uniform(-0.5, 0.5, size=clicks.size)
    return x.astype(np.float32)[None]


def phase_main(torch, kernel_row):
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.ops import frame_structured, overlap_add
    from ml_audio_restoration_torch.ops.chunking import num_chunks
    from ml_audio_restoration_torch.pipeline import RestorationPipeline
    from ml_audio_restoration_torch.pipeline.restore import _bucket
    from ml_audio_restoration_torch.audio import save_audio, wav_info

    dev = torch.device("cuda")
    dn, sr, st = _models(torch, dev)
    pipe = RestorationPipeline(dn, sr, st)  # default device: the card
    rate = pipe.config.sample_rate

    # 4 s clip: kernel vs plain recurrence on the card, and card vs CPU
    clip = _clip(4.0, rate, seed=2)
    y_k, out_rate = pipe.restore(clip, rate)
    with L.plain_recurrence():
        y_p, _ = pipe.restore(clip, rate)
    cpu = RestorationPipeline(*(m.to("cpu") for m in _models(torch, dev)),
                              device="cpu")
    y_c, _ = cpu.restore(clip, rate)
    torch.cuda.synchronize()
    want_shape = (2, clip.shape[1] * 2)
    small = {"phase": "main_small", "seconds": 4.0,
             "shape": list(y_k.shape), "out_rate": out_rate,
             "finite": bool(torch.isfinite(y_k).all()),
             "kernel_vs_plain_max_abs": _max_dev(y_k, y_p),
             "kernel_vs_plain_tol": PIPE_TOL,
             "card_vs_cpu_max_abs": _max_dev(y_k.cpu(), y_c),
             "card_vs_cpu_tol": CPU_TOL}
    emit(small)
    if not (tuple(y_k.shape) == want_shape and out_rate == 2 * rate
            and small["finite"]
            and small["kernel_vs_plain_max_abs"] <= PIPE_TOL
            and small["card_vs_cpu_max_abs"] <= CPU_TOL):
        raise AssertionError(f"4 s restore check failed: {small}")
    del cpu, y_c

    # 120 s clip: one program of 64 bucketed chunks
    seconds = 120.0
    clip = _clip(seconds, rate, seed=3)
    pipe.restore(clip, rate)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L.reset_launch_count()
    t0 = time.perf_counter()
    y, _ = pipe.restore(clip, rate)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = L.launch_count
    peak = torch.cuda.max_memory_allocated()
    ok = (tuple(y.shape) == (2, clip.shape[1] * 2)
          and bool(torch.isfinite(y).all()))

    # per-stage device time on the same chunk batch
    chunk = int(round(pipe.config.chunk_seconds * rate))
    overlap = int(round(pipe.config.overlap_seconds * rate))
    hop = chunk - overlap
    n_real = num_chunks(clip.shape[1], chunk, hop)
    n = _bucket(n_real)
    total = (n - 1) * hop + chunk
    audio = torch.nn.functional.pad(torch.from_numpy(clip).to(dev),
                                    (0, total - clip.shape[1]))
    stage_ms = {}
    with torch.inference_mode():
        x = frame_structured(audio, n, chunk, hop).permute(0, 2, 1)
        for name, fn in (("denoiser", dn), ("super_resolution", sr),
                         ("stereo", st)):
            x_in = x
            stage_ms[name] = _cuda_ms(torch, lambda: fn(x_in), 1)
            x = fn(x_in)
        stage_ms["overlap_add"] = _cuda_ms(
            torch, lambda: overlap_add(x, hop * 2, total * 2,
                                       overlap=overlap * 2, valid=n_real), 1)
    del x, x_in, audio
    big = {"phase": "main_120s", "seconds": seconds, "chunks": n,
           "real_chunks": n_real, "wall_s": wall, "xrt": seconds / wall,
           "stage_ms": stage_ms, "peak_mem_bytes": peak,
           "lstm_recurrence_launches": launches, "ok": ok}
    emit(big)
    if not ok or launches < 1:
        raise AssertionError(f"120 s restore failed: {big}")
    kernel_row["launches"] = launches

    # WAV round trip through restore_file
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        clip = _clip(3.0, rate, seed=4)
        save_audio(src, clip, rate)
        _, out_rate = pipe.restore_file(src, dst)
        info = wav_info(dst)
    io_row = {"phase": "restore_file", "out_rate": out_rate,
              "channels": info.channels, "sample_rate": info.sample_rate,
              "frames": info.frames}
    emit(io_row)
    if not (info.channels == 2 and info.sample_rate == 2 * rate == out_rate
            and info.frames == 2 * clip.shape[1]):
        raise AssertionError(f"restore_file round trip failed: {io_row}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import ml_audio_restoration_torch  # noqa: F401  (fail before any output)

    phase_device(torch)
    phase_build()
    row = phase_kernels(torch)
    phase_main(torch, row)
    emit({"kernels": [{key: row[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
