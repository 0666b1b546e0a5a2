#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds every CUDA source of the package, one nvcc per
               source, all started together (the kernels and the latency
               probe of ops/_latency.py);
  3. kernels - each kernel (K1 inference recurrence, K2 train forward, K3
               train backward: its walk and its dW_hh pass) against its
               plain PyTorch version on the card, with stated tolerances
               (each at every H it takes, 16, 32 and 64: one step of one
               row, an odd T with a random carry in, and gates of
               magnitude ~60 that saturate every activation; K2 and K3 also
               repeat bit for bit), then at its main-path shape held
               against its plain version again and timed beside its bound,
               the plain version and a library yardstick (the dW_hh pass
               also alone; K2 beside its latency floor, counted from step
               latencies the probe measures);
  4. main    - the offline restore chain at full published widths with
               seeded random weights: kernel vs plain recurrence on a 4 s
               clip, card vs CPU on the same clip, a 120 s clip (64 bucketed
               chunks) with xRT, per-stage ms and K1 launch counts, and a
               WAV file round trip;
  5. grad    - gradients through the eval stereo forward on the card are
               non-zero and match the plain recurrence's;
  6. train   - stereo-separator training at full width: one optimizer step
               (kernel vs plain on the card, card vs CPU), 10-step loss
               trajectories (kernel vs plain; two kernel runs held equal),
               then train_from_config over seeded stereo WAVs
               (2 s chunks, batch 16) with K2/K3 launch counts, 10 timed
               steps (audio-s/s, the step split, peak memory) and a
               checkpoint resumed in a fresh trainer;
  7. train_convnets - denoiser and super-resolution training at full
               width (batch 16 of 2 s; the denoiser's 78rpm degradation
               runs inside the step): the degradation on the card against
               the CPU on the same draws, one step card vs CPU, two seeded
               10-step runs held equal bit for bit, then train_from_config
               over seeded mono WAVs with 10 timed steps (audio-s/s, the
               step split, peak memory) and a checkpoint resumed in a fresh
               trainer whose next step equals the uninterrupted one's; one
               line a family. No kernel of the package runs on this path;
  8. k1_shapes - K1 at the serving paths' shapes (sub-chunked stereo
               T=11,024 B=640 in bf16 and f32, source-rate T=44,100 B=64,
               a streaming feed's committed T=22,048 and lookahead T=1,040
               runs at B=16 with a carry in): against its plain version,
               timed beside its bound, its latency floor (waves x steps),
               its registers, CTAs an SM and waves, and cuDNN's nn.LSTM;
  9. serve_fast - a 120 s clip through config/fast_serve.yaml (bf16, 0.25 s
               stereo windows): kernel vs plain recurrence, bf16 vs f32,
               xRT, the stage split, K1 launches, peak memory, and
               `warmup`;
 10. serve_options - the clip in f32 with 0.25 s stereo windows, mid-exact
               (the mean of L and R is the SR output) and source-rate, each
               against its plain-recurrence run, timed;
 11. serve_many - eight 10 s recordings and one of 150 s: restore_many vs
               single restores, then restore_directory (coalesce 4) vs
               restore_file over WAVs in profiles/;
 12. stream  - 16 lockstep streams of 30 s in 0.5 s blocks: each against
               the single-shot whole_file restore, the batch against 16
               single streams, one feed against the plain recurrence, bf16
               against f32; per-feed ms, the slowest call (a feed or the
               flush) with any window length warmup did not run (none
               may), and K1 launches a feed.
Then one line {"kernels": [...]} and, last, the device line
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12     # bf16 operands, dense, on the tensor cores (same)

F32_TOL = 1e-5      # same arithmetic, different f32 summation order
BF16_TOL = 1e-2     # a summation-order change can flip one bf16 rounding of
#                     h, and the recurrence carries that change forward
PIPE_TOL = 1e-4     # whole chain, kernel vs plain recurrence on the card
CPU_TOL = 1e-3      # whole chain, card vs CPU: the chain's parity bar
K2_TOL = 1e-5       # train forward: f32 throughout, another summation order
K3_TOL = 2e-5       # dgx, dh0, dc0: the bar JAX holds its Pallas backward to
DW_TOL = 1e-4       # dW_hh, relative to its largest entry: a sum over T*B
#                     outer products, in split-K partials added in order
SATURATED = 60.0    # gate scale of the saturation cases: exp(-2x) overflows
HIDDEN = (16, 32, 64)  # every H the recurrence kernels take
STEP_TOL = 1e-4     # one train step, kernel vs plain: loss (relative),
#                     smooth-term gradients (of the largest entry), BN stats
MANY_TOL = 1e-5     # restore_many vs restore: cuDNN may pick another
#                     algorithm at another batch size
MID_TOL = 1e-5      # mid-exact: mean of L and R vs the SR output
STREAM_TOL = 1e-3   # a stream vs the whole-file restore over [8000:-1200]
#                     (JAX tests/test_streaming.py): conv edges decay
BF16_REL = 0.05     # bf16 vs f32, of the f32 output's peak (JAX
#                     tests/test_streaming.py:380)
BF16_CHAIN_TOL = 1e-2  # a bf16 chain, K1 vs plain: one flipped bf16
#                     rounding of h, carried through bf16 decoders


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
    """Builds every CUDA source of the package in parallel, one nvcc each:
    the kernels and the latency probe."""
    from concurrent.futures import ThreadPoolExecutor

    from ml_audio_restoration_torch.ops import _build, _latency

    sources = ("lstm_recurrence", "lstm_train", _latency.PROBE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    for name in sources:
        _build.load(name)
    emit({"phase": "build", "sources": list(sources),
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {k: _build.build_seconds.get(k) for k in sources}})


def _cuda_ms(torch, fn, reps: int) -> float:
    """The median device time of one call of fn over `reps` calls, each
    between its own pair of CUDA events: a host stall or a clock still
    ramping up spoils one call, not the reading."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for event in events[1:]:
        fn()
        event.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def _max_dev(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _timed_once(torch, fn):
    """(device ms, result) of one call of fn, between a pair of CUDA
    events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _lstm_segments(torch, ref, gates, seg: int):
    """cuDNN's nn.LSTM over `gates` in time segments of `seg` steps, the
    state threaded from one segment to the next -> [T, B, H]."""
    outs, state = [], None
    for s in range(0, gates.shape[0], seg):
        out, state = ref(gates[s:s + seg], state)
        outs.append(out)
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _k1_cases(torch, L, randn):
    """K1 against its plain version at every H it takes: one step of one
    row and an odd T with a random carry in, f32 and bf16 gates; then gates
    of magnitude ~SATURATED in f32, whose outputs must be finite. Returns
    the largest deviation of each kind and whether all were finite."""
    worst = {"f32": 0.0, "bf16": 0.0, "saturated": 0.0}
    finite = True
    for h in HIDDEN:
        for t, b, scale, kinds in ((1, 1, 0.5, ("f32", "bf16")),
                                   (301, 5, 0.5, ("f32", "bf16")),
                                   (301, 5, SATURATED, ("saturated",))):
            gates, w_hh = randn(t, b, 4 * h, scale=scale), randn(
                h, 4 * h, scale=0.15)
            h0, c0 = randn(b, h, scale=0.3), randn(b, h, scale=0.3)
            for kind in kinds:
                dt = torch.bfloat16 if kind == "bf16" else torch.float32
                args = (gates.to(dt), w_hh.to(dt), h0, c0)
                k = L._lstm_recurrence_cuda(*args)
                p = L.lstm_recurrence_plain(*args)
                finite &= all(bool(torch.isfinite(x.float()).all())
                              for x in k)
                worst[kind] = max(worst[kind],
                                  max(_max_dev(x, y) for x, y in zip(k, p)))
    return worst, finite


def phase_kernels(torch):
    from ml_audio_restoration_torch.ops import lstm as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    cases, finite = _k1_cases(torch, L, randn)
    check = {"phase": "kernel_check", "kernel": "lstm_recurrence",
             "hidden": list(HIDDEN), "shapes": [[1, 1], [301, 5]],
             "f32_max_abs_err": cases["f32"], "f32_tol": F32_TOL,
             "bf16_max_abs_err": cases["bf16"], "bf16_tol": BF16_TOL,
             "saturated_gate_scale": SATURATED,
             "saturated_max_abs_err": cases["saturated"],
             "saturated_finite": finite}
    emit(check)
    if not (cases["f32"] <= F32_TOL and cases["bf16"] <= BF16_TOL
            and cases["saturated"] <= F32_TOL and finite):
        raise AssertionError(f"lstm_recurrence disagrees with plain: {check}")

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
    ms = _cuda_ms(torch, run_k, 5)
    plain_ms, out_p = _timed_once(
        torch, lambda: L.lstm_recurrence_plain(gates, w_hh, h0, c0))
    main_err = max(_max_dev(x, y) for x, y in zip(out_k, out_p))
    check = {"phase": "kernel_check", "kernel": "lstm_recurrence",
             "shape": [t, b, h], "f32_max_abs_err": main_err,
             "f32_tol": F32_TOL}
    emit(check)
    if not main_err <= F32_TOL:
        raise AssertionError(f"lstm_recurrence disagrees with plain at the "
                             f"main-path shape: {check}")
    del out_p
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
    bound_ms, bound_by = _bound(n_bytes, flops)
    timing = {"phase": "kernel_time", "kernel": "lstm_recurrence",
              "shape": [t, b, h], "dtype": "float32", "ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library_segment_steps": seg,
              "library_vs_kernel_max_abs": lib_dev,
              "bytes": n_bytes, "flops": flops, "bound_ms": bound_ms,
              "ns_per_step": ms * 1e6 / t}
    emit(timing)
    del gates, out_k
    torch.cuda.empty_cache()
    return {"name": "lstm_recurrence", "route": "cuda",
            "source": "ml_audio_restoration_torch/csrc/lstm_recurrence.cu",
            "replaces": "ml_audio_restoration_tpu/ops/pallas/lstm.py:59",
            "max_abs_err": max(f32_err, cases["f32"], cases["saturated"],
                               main_err),
            "max_abs_err_bf16": max(bf16_err, cases["bf16"]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _bound(n_bytes: float, flops: float, peak_flops: float = H100_F32_FLOPS):
    """(bound ms, what bounds it) on the card's data-sheet peaks; the
    operations at the peak rate of their operands' type."""
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / peak_flops * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _k2_cases(torch, L, randn):
    """K2 against its plain version at every H it takes: one step of one
    row and an odd T with a random carry in, gates of magnitude 0.5 and
    ~SATURATED, f32. Returns the largest deviation of each kind over all
    five outputs and whether all were finite."""
    worst = {"f32": 0.0, "saturated": 0.0}
    finite = True
    for h in HIDDEN:
        for t, b, kind in ((1, 1, "f32"), (301, 5, "f32"),
                           (301, 5, "saturated")):
            scale = SATURATED if kind == "saturated" else 0.5
            args = (randn(t, b, 4 * h, scale=scale),
                    randn(h, 4 * h, scale=0.15), randn(b, h, scale=0.3),
                    randn(b, h, scale=0.3))
            k = L._lstm_train_fwd_cuda(*args)
            p = L.lstm_recurrence_train_plain(*args)
            finite &= all(bool(torch.isfinite(x).all()) for x in k)
            worst[kind] = max(worst[kind],
                              max(_max_dev(x, y) for x, y in zip(k, p)))
    return worst, finite


def _k3_cases(torch, L, randn):
    """K3 (walk and dW_hh pass) against its plain version at every H it
    takes, on residuals from K2's plain version: one step of one row and
    an odd T with a random carry in and random cotangents, gates of
    magnitude 0.5 and ~SATURATED. Returns the largest deviation on dgx,
    dh0 and dc0, the largest on dW_hh relative to its largest entry, and
    whether all were finite."""
    bwd_err = dw_rel = 0.0
    finite = True
    for h in HIDDEN:
        for t, b, scale in ((1, 1, 0.5), (301, 5, 0.5), (301, 5, SATURATED)):
            gates, w_hh = randn(t, b, 4 * h, scale=scale), randn(
                h, 4 * h, scale=0.15)
            h0, c0 = randn(b, h, scale=0.3), randn(b, h, scale=0.3)
            dout, dhf, dcf = (randn(t, b, h, scale=0.1),
                              randn(b, h, scale=0.1), randn(b, h, scale=0.1))
            out, _, _, acts, cseq = L.lstm_recurrence_train_plain(
                gates, w_hh, h0, c0)
            args = (acts, cseq, out, h0, c0, w_hh, dout, dhf, dcf)
            k = L._lstm_train_bwd_cuda(*args)
            p = L.lstm_recurrence_bwd_plain(*args)
            finite &= all(bool(torch.isfinite(x).all()) for x in k)
            bwd_err = max(bwd_err, max(_max_dev(k[i], p[i]) for i in (0, 2, 3)))
            dw_rel = max(dw_rel, _max_dev(k[1], p[1])
                         / max(float(p[1].abs().max()), 1e-30))
    return bwd_err, dw_rel, finite


def phase_train_kernels(torch):
    """K2 and K3 against their plain versions, then at the stereo training
    shape (2 s chunks at 22.05 kHz, batch 16) held against them again and
    timed; K2 beside its latency floor, counted from the step latencies the
    probe of ops/_latency.py measures."""
    from ml_audio_restoration_torch.ops import _latency
    from ml_audio_restoration_torch.ops import lstm as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def train_inputs(t, b, h):
        return (randn(t, b, 4 * h, scale=0.5), randn(h, 4 * h, scale=0.15),
                randn(b, h, scale=0.3), randn(b, h, scale=0.3))

    cases, finite = _k2_cases(torch, L, randn)
    check = {"phase": "kernel_check", "kernel": "lstm_train_fwd",
             "hidden": list(HIDDEN), "shapes": [[1, 1], [301, 5]],
             "f32_max_abs_err": cases["f32"], "tol": K2_TOL,
             "saturated_gate_scale": SATURATED,
             "saturated_max_abs_err": cases["saturated"],
             "saturated_finite": finite}
    emit(check)
    if not (cases["f32"] <= K2_TOL and cases["saturated"] <= K2_TOL
            and finite):
        raise AssertionError(f"lstm_train_fwd disagrees with plain: {check}")

    t, b, h = 1001, 13, 64
    gates, w_hh, h0, c0 = train_inputs(t, b, h)
    dout, dhf, dcf = (randn(t, b, h, scale=0.1), randn(b, h, scale=0.1),
                      randn(b, h, scale=0.1))
    k = L._lstm_train_fwd_cuda(gates, w_hh, h0, c0)
    p = L.lstm_recurrence_train_plain(gates, w_hh, h0, c0)
    f32_err = max(_max_dev(x, y) for x, y in zip(k, p))
    # a fixed summation order: a second run is equal bit for bit
    fwd_repeats = all(torch.equal(x, y) for x, y in zip(
        k, L._lstm_train_fwd_cuda(gates, w_hh, h0, c0)))
    # bf16 gates: upcast on load, h not rounded, every output f32
    gb = gates.bfloat16()
    kb = L._lstm_train_fwd_cuda(gb, w_hh, h0, c0)
    pb = L.lstm_recurrence_train_plain(gb, w_hh, h0, c0)
    bf16_err = max(_max_dev(x, y) for x, y in zip(kb, pb))
    # two halves with the carry threaded through == one run
    a = L._lstm_train_fwd_cuda(gates[:500], w_hh, h0, c0)
    z = L._lstm_train_fwd_cuda(gates[500:], w_hh, a[1], a[2])
    halves_err = max(
        max(_max_dev(torch.cat([a[i], z[i]]), k[i]) for i in (0, 3, 4)),
        _max_dev(z[1], k[1]), _max_dev(z[2], k[2]))
    kg = L._lstm_train_bwd_cuda(p[3], p[4], p[0], h0, c0, w_hh, dout, dhf,
                                dcf)
    pg = L.lstm_recurrence_bwd_plain(p[3], p[4], p[0], h0, c0, w_hh, dout,
                                     dhf, dcf)
    torch.cuda.synchronize()
    bwd_err = max(_max_dev(kg[i], pg[i]) for i in (0, 2, 3))
    dw_rel = _max_dev(kg[1], pg[1]) / float(pg[1].abs().max())
    check = {"phase": "kernel_check", "kernel": "lstm_train_fwd+bwd",
             "shape": [t, b, h], "fwd_f32_max_abs_err": f32_err,
             "fwd_bf16_max_abs_err": bf16_err,
             "fwd_bf16_out_dtype": str(kb[0].dtype),
             "fwd_halves_max_abs_err": halves_err, "fwd_tol": K2_TOL,
             "fwd_repeats_bit_for_bit": fwd_repeats,
             "bwd_max_abs_err": bwd_err, "bwd_tol": K3_TOL,
             "dw_rel_err": dw_rel, "dw_tol": DW_TOL}
    emit(check)
    if not (f32_err <= K2_TOL and bf16_err <= K2_TOL
            and halves_err <= K2_TOL and kb[0].dtype == torch.float32
            and fwd_repeats and bwd_err <= K3_TOL and dw_rel <= DW_TOL):
        raise AssertionError(f"lstm_train disagrees with plain: {check}")
    del k, p, kb, pb, a, z, kg, pg
    case_err, case_dw, finite = _k3_cases(torch, L, randn)
    check = {"phase": "kernel_check", "kernel": "lstm_train_bwd",
             "hidden": list(HIDDEN), "shapes": [[1, 1], [301, 5]],
             "saturated_gate_scale": SATURATED,
             "bwd_max_abs_err": case_err, "bwd_tol": K3_TOL,
             "dw_rel_err": case_dw, "dw_tol": DW_TOL, "finite": finite}
    emit(check)
    if not (case_err <= K3_TOL and case_dw <= DW_TOL and finite):
        raise AssertionError(f"lstm_train_bwd disagrees with plain: {check}")
    bwd_err = max(bwd_err, case_err)

    # the training shape: 2 s chunks at 22.05 kHz, batch 16
    t, b, h = 44100, 16, 64
    gates, w_hh, h0, c0 = train_inputs(t, b, h)
    dout, dhf, dcf = (randn(t, b, h, scale=0.1), randn(b, h, scale=0.1),
                      randn(b, h, scale=0.1))
    fwd = lambda: L._lstm_train_fwd_cuda(gates, w_hh, h0, c0)  # noqa: E731
    res = fwd()
    fwd_ms = _cuda_ms(torch, fwd, 5)
    # K2's latency floor: its counted step chain at the step latencies the
    # probe measures now, at the SM clock nvidia-smi reads right after
    # (each kernel's floor at its main-path T: K1's is the restore's)
    floor = _latency.step_floor(h, {"k1": 88200, "k2": t, "k3": t}, dev)
    emit({"phase": "latency_probe", **floor})
    fwd_floor = floor["floor"]["k2"]
    fwd_plain_ms, res_p = _timed_once(
        torch, lambda: L.lstm_recurrence_train_plain(gates, w_hh, h0, c0))
    main_fwd_err = max(_max_dev(x, y) for x, y in zip(res, res_p))
    del res_p
    out, _, _, acts, cseq = res
    bwd = lambda: L._lstm_train_bwd_cuda(  # noqa: E731
        acts, cseq, out, h0, c0, w_hh, dout, dhf, dcf)
    grads = bwd()
    bwd_ms = _cuda_ms(torch, bwd, 5)  # both launches: the walk, the dW pass
    # the dW_hh pass alone, on the walk's dgx (not counted: a timing launch)
    dw_ms = _cuda_ms(torch, lambda: L._dw_pass(out, h0, grads[0]), 5)
    dw_bytes = 4 * (t * b * (h + 4 * h) + h * 4 * h)  # out, dgx in; dW out
    dw_flops = 2.0 * t * b * h * 4 * h
    dw_bound, dw_by = _bound(dw_bytes, dw_flops)
    emit({"phase": "kernel_time", "kernel": "lstm_train_bwd dW_hh pass",
          "shape": [t, b, h], "ms": dw_ms, "splits": L._dw_splits(t * b),
          "bytes": dw_bytes, "flops": dw_flops, "bound_ms": dw_bound,
          "bound_by": dw_by, "walk_ms": bwd_ms - dw_ms})
    bwd_plain_ms, grads_p = _timed_once(
        torch, lambda: L.lstm_recurrence_bwd_plain(
            acts, cseq, out, h0, c0, w_hh, dout, dhf, dcf))
    main_bwd_err = max(_max_dev(grads[i], grads_p[i]) for i in (0, 2, 3))
    main_dw_rel = (_max_dev(grads[1], grads_p[1])
                   / float(grads_p[1].abs().max()))
    del grads_p
    check = {"phase": "kernel_check", "kernel": "lstm_train_fwd+bwd",
             "shape": [t, b, h], "fwd_f32_max_abs_err": main_fwd_err,
             "fwd_tol": K2_TOL, "bwd_max_abs_err": main_bwd_err,
             "bwd_tol": K3_TOL, "dw_rel_err": main_dw_rel, "dw_tol": DW_TOL}
    emit(check)
    if not (main_fwd_err <= K2_TOL and main_bwd_err <= K3_TOL
            and main_dw_rel <= DW_TOL):
        raise AssertionError(f"lstm_train disagrees with plain at the "
                             f"main-path shape: {check}")

    # yardstick only, never called by the port: cuDNN's LSTM in train mode
    # with an identity input projection, forward for K2 and forward +
    # backward minus forward for K3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.nn.LSTM(4 * h, h).to(dev).train()
    with torch.no_grad():
        ref.weight_ih_l0.copy_(torch.eye(4 * h, device=dev))
        ref.weight_hh_l0.copy_(w_hh.T)
        ref.bias_ih_l0.zero_()
        ref.bias_hh_l0.zero_()
    x = gates.clone().requires_grad_()
    hc = (h0[None].clone().requires_grad_(), c0[None].clone().requires_grad_())

    def lib_fwd():
        return ref(x, hc)

    def lib_fwd_bwd():
        y, (hn, cn) = ref(x, hc)
        return torch.autograd.grad(
            (y, hn, cn), (x, ref.weight_hh_l0, hc[0], hc[1]),
            (dout, dhf[None], dcf[None]))

    try:  # the yardstick only: cuDNN may refuse a sequence this long
        lib_grads = lib_fwd_bwd()
    except RuntimeError as e:
        lib_fwd_ms = lib_bwd_ms = None
        lib_dev = {"refused": str(e)[:200]}
    else:
        lib_fwd_ms = _cuda_ms(torch, lib_fwd, 3)
        lib_bwd_ms = _cuda_ms(torch, lib_fwd_bwd, 3) - lib_fwd_ms
        lib_dev = {"out": _max_dev(lib_fwd()[0], out),
                   "dgx": _max_dev(lib_grads[0], grads[0]),
                   "dw_hh": _max_dev(lib_grads[1].T, grads[1]),
                   "dw_hh_max": float(grads[1].abs().max()),
                   "dh0": _max_dev(lib_grads[2][0], grads[2]),
                   "dc0": _max_dev(lib_grads[3][0], grads[3])}
        del lib_grads
    del ref, x, hc

    g4 = 4 * h
    fwd_bytes = 4 * (t * b * g4 + h * g4 + 2 * b * h       # gates, W, h0/c0
                     + t * b * (h + g4 + h) + 2 * b * h)   # out, acts, cseq
    fwd_flops = 2.0 * t * b * h * g4                       # h @ W_hh
    bwd_bytes = 4 * (t * b * (g4 + 3 * h) + h * g4 + 4 * b * h  # residuals
                     + t * b * g4 + h * g4 + 2 * b * h)    # dgx, dW, dh0/dc0
    bwd_flops = 4.0 * t * b * h * g4   # d_lin @ W_hh^T and the dW products
    fwd_bound, fwd_by = _bound(fwd_bytes, fwd_flops)
    bwd_bound, bwd_by = _bound(bwd_bytes, bwd_flops)
    timing = {"phase": "kernel_time", "kernel": "lstm_train_fwd+bwd",
              "shape": [t, b, h], "dtype": "float32",
              "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
              "fwd_library_ms": lib_fwd_ms, "fwd_bytes": fwd_bytes,
              "fwd_flops": fwd_flops, "fwd_bound_ms": fwd_bound,
              "bwd_ms": bwd_ms, "bwd_dw_pass_ms": dw_ms,
              "bwd_plain_ms": bwd_plain_ms,
              "bwd_library_ms": lib_bwd_ms, "bwd_bytes": bwd_bytes,
              "bwd_flops": bwd_flops, "bwd_bound_ms": bwd_bound,
              "library_vs_kernel_max_abs": lib_dev,
              "fwd_ns_per_step": fwd_ms * 1e6 / t,
              "fwd_floor_ms": fwd_floor["ms"],
              "fwd_floor_ns_per_step": fwd_floor["ns_per_step"],
              "fwd_floor_cycles_per_step": fwd_floor["cycles_per_step"],
              "bwd_ns_per_step": bwd_ms * 1e6 / t}
    emit(timing)
    del gates, res, out, acts, cseq, grads, dout
    torch.cuda.empty_cache()
    src = "ml_audio_restoration_torch/csrc/lstm_train.cu"
    return [
        {"name": "lstm_train_fwd", "route": "cuda", "source": src,
         "replaces": "ml_audio_restoration_tpu/ops/pallas/lstm.py:223",
         "max_abs_err": max(f32_err, bf16_err, halves_err, cases["f32"],
                            cases["saturated"], main_fwd_err), "ms": fwd_ms,
         "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound,
         "bound_by": fwd_by, "library_ms": lib_fwd_ms},
        {"name": "lstm_train_bwd", "route": "cuda", "source": src,
         "replaces": "ml_audio_restoration_tpu/ops/pallas/lstm.py:260",
         "max_abs_err": max(bwd_err, main_bwd_err), "ms": bwd_ms,
         "plain_ms": bwd_plain_ms,
         "bound_ms": bwd_bound, "bound_by": bwd_by,
         "library_ms": lib_bwd_ms}]


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


def _grad_devs(a, b):
    """max |a - b| over a list of gradients, relative to b's largest."""
    return (max(_max_dev(x, y) for x, y in zip(a, b))
            / max(float(y.abs().max()) for y in b))


def phase_grad(torch):
    """Gradients through the eval stereo forward on the card: the LSTM
    under grad takes K2/K3, reaches the encoder and W_ih/W_hh, and agrees
    with the plain recurrence's gradients."""
    from ml_audio_restoration_torch.ops import lstm as L

    dev = torch.device("cuda")
    st = _models(torch, dev)[2]
    x = torch.from_numpy(_clip(0.25, 22050, seed=5)[None]).to(dev)
    params = [p for _, p in st.named_parameters()]

    def grads():
        return torch.autograd.grad(st(x).square().mean(), params)

    L.reset_launch_count()
    g_k = grads()
    launches = (L.train_fwd_launch_count, L.train_bwd_launch_count)
    with L.plain_recurrence():
        g_p = grads()
    torch.cuda.synchronize()
    names = [n for n, _ in st.named_parameters()]
    reach = {n: float(g.abs().max()) for n, g in zip(names, g_k)
             if n.startswith(("encoder.0.0", "lstm."))}
    row = {"phase": "grad_eval_forward", "train_launches": list(launches),
           "grad_max_abs": reach,
           "kernel_vs_plain_rel": _grad_devs(g_k, g_p),
           "tol": STEP_TOL}
    emit(row)
    if not (launches == (1, 1) and all(v > 0 for v in reach.values())
            and row["kernel_vs_plain_rel"] <= STEP_TOL):
        raise AssertionError(f"gradient through the eval forward: {row}")


def _stereo_batch(batch: int, frames: int, seed: int) -> dict:
    """A broadband stereo batch [B, 2, T]: tones under noise, L and R
    correlated, RMS ~0.1."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / 22050
    out = np.empty((batch, 2, frames), np.float32)
    for i in range(batch):
        tone = 0.1 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
        left = tone + 0.05 * rng.standard_normal(frames)
        right = 0.6 * tone + 0.05 * rng.standard_normal(frames)
        out[i] = np.stack([left, right])
    return {"stereo": out}


def _train_trainer(torch, model, device, **cfg):
    from ml_audio_restoration_torch.config import TrainConfig
    from ml_audio_restoration_torch.train.trainer import Trainer

    config = TrainConfig(model="stereo_separator", **cfg)
    return Trainer("stereo_separator", model, [], pairing="mono_target_stereo",
                   config=config, device=device)


# The reference loss's log-magnitude spectral and clustering terms weigh
# each STFT bin by 1/(|S| + 1e-5), so their gradient moves with the f32
# rounding of the smallest bins of the model's output: a 1e-7 change of the
# LSTM output (K2 against its plain version) moves it by ~1e-2 of its
# largest entry. Its smooth terms (time MSE and temporal consistency) are
# well-conditioned. So the step's gradients are held entry by entry on the
# smooth terms and as a relative L2 norm on the reference loss.
SMOOTH_TERMS = {"spectral_weight": 0.0, "clustering_weight": 0.0}

# Bars of the train step, each set from the readings of a run on the card
# (PERF.md) with room for run-to-run spread. An update is new weights
# minus old over every parameter but the BN-fed conv biases; Adam moves each
# weight by about lr * sign(g), so a gradient entry whose sign the rounding
# flips moves the update by 2 lr, and these are relative L2 norms.
# Readings: reference gradient 1.2e-2 kernel vs plain, 7.1e-2 card vs CPU
# (the plain version vs the CPU: 6.9e-2); updates 4.9e-5 / 2.7e-2 on the
# smooth terms, 0.11 / 0.29 on the reference loss; 1.9e-3 after the 10
# smooth steps. A gradient of the wrong sign in any term, or one lost,
# moves these by O(1).
REF_GRAD_L2 = {"kernel_vs_plain": 5e-2, "card_vs_cpu": 2e-1}
UPDATE_L2 = {("smooth", "kernel_vs_plain"): 1e-3,
             ("smooth", "card_vs_cpu"): 1e-1,
             ("reference", "kernel_vs_plain"): 3e-1,
             ("reference", "card_vs_cpu"): 6e-1}
TRAJ_UPDATE_L2 = 1e-2  # smooth terms, 10 steps at lr 1e-3, kernel vs plain


def _bn_fed_biases(model):
    """Conv biases that feed a train-mode BN: the batch mean cancels them,
    so their true gradient is zero and Adam turns the rounding noise both
    sides hand it into a step of up to lr."""
    from torch import nn

    mods = dict(model.named_modules())
    out = set()
    for name, mod in mods.items():
        if isinstance(mod, nn.Sequential):
            kids = list(mod.children())
            for i, kid in enumerate(kids[:-1]):
                if (isinstance(kid, nn.Conv1d)
                        and isinstance(kids[i + 1], nn.BatchNorm1d)):
                    out.add(f"{name}.{i}.bias")
    return out


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over two lists of tensors, in f64 on the CPU."""
    num = sum(float((x.cpu().double() - y.cpu().double()).square().sum())
              for x, y in zip(a, b))
    return (num / sum(float(y.cpu().double().square().sum())
                      for y in b)) ** 0.5


@contextlib.contextmanager
def _all_deterministic(torch):
    """torch.use_deterministic_algorithms, warning for each op that has no
    deterministic implementation; yields the list of those ops' names."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    names: list = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield names
        names += sorted({str(w.message).split(" does not have")[0]
                         for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)


def phase_train_small(torch):
    """One full optimizer step at full width on a 0.25 s chunk, batch 4,
    TrainConfig defaults with clipping and EMA: kernel vs plain on the
    card, card vs CPU, and the card against itself (the reference loss and
    its smooth terms); then 10 steps at lr 1e-3 on one fixed batch, kernel
    vs plain and kernel vs kernel, the latter also with cuDNN's
    nondeterministic algorithms (the trainer turns them off) and with
    every op's deterministic one."""
    import copy

    from ml_audio_restoration_torch.models import StereoSeparator, init_params
    from ml_audio_restoration_torch.ops import lstm as L

    base = init_params(StereoSeparator(), torch.Generator().manual_seed(0))
    w0 = {n: p.detach().clone() for n, p in base.named_parameters()}
    batch = _stereo_batch(4, 5512, seed=6)
    cfg = {"max_grad_norm": 1.0, "ema_decay": 0.999}
    lr = 1e-4  # TrainConfig's default
    loose = _bn_fed_biases(base)
    moved = [n for n in w0 if n not in loose]

    def run(device, plain=False, steps=1, cudnn_deterministic=True, **kw):
        tr = _train_trainer(torch, copy.deepcopy(base), device,
                            **{**cfg, **kw})
        torch.backends.cudnn.deterministic = cudnn_deterministic
        try:
            with (L.plain_recurrence() if plain
                  else contextlib.nullcontext()):
                losses = [float(tr._train_step(batch)["loss"])
                          for _ in range(steps)]
        finally:
            torch.backends.cudnn.deterministic = True  # the trainer's
        grads = {n: p.grad.detach() for n, p in tr.model.named_parameters()}
        state = {n: v.detach().float()
                 for n, v in tr.model.state_dict().items()}
        state.update({f"ema.{n}": v for n, v in tr.ema_params.items()})
        return losses, grads, state

    def update(state, prefix=""):
        return [state[prefix + n].cpu() - w0[n] for n in moved]

    def compare(a, b):
        (la, ga, sa), (lb, gb, sb) = a, b
        stats = [n for n in sa if n.endswith(("running_mean",
                                              "running_var"))]
        return {"loss_rel": abs(la[0] - lb[0]) / abs(lb[0]),
                "grad_rel": _grad_devs(
                    [ga[n] for n in ga],
                    [gb[n].to(ga[n].device) for n in ga]),
                "grad_rel_l2": _rel_l2(list(ga.values()),
                                       [gb[n] for n in ga]),
                "update_rel_l2": _rel_l2(update(sa), update(sb)),
                "ema_update_rel_l2": _rel_l2(update(sa, "ema."),
                                             update(sb, "ema.")),
                "bn_stats_max_abs": max(
                    _max_dev(sa[n], sb[n].to(sa[n].device)) for n in stats),
                "bn_fed_biases_max_abs": max(
                    _max_dev(sa[n], sb[n].to(sa[n].device)) for n in loose)}

    row = {"phase": "train_small", "batch": 4, "frames": 5512, "lr": lr,
           "tol": {"kernel_vs_plain": STEP_TOL, "card_vs_cpu": CPU_TOL,
                   "reference_grad_rel_l2": REF_GRAD_L2,
                   "update_rel_l2": {"/".join(k): v
                                     for k, v in UPDATE_L2.items()},
                   "trajectory": CPU_TOL,
                   "trajectory_update_rel_l2": TRAJ_UPDATE_L2}}
    ok = True
    for name, kw in (("reference", {}), ("smooth", SMOOTH_TERMS)):
        L.reset_launch_count()
        k = run("cuda", **kw)
        launches = [L.train_fwd_launch_count, L.train_bwd_launch_count]
        k2, p, c = run("cuda", **kw), run("cuda", True, **kw), run("cpu",
                                                                   **kw)
        torch.cuda.synchronize()
        r = {"loss": k[0][0], "launches": launches,
             "kernel_vs_kernel": compare(k, k2),
             "kernel_vs_plain": compare(k, p), "card_vs_cpu": compare(k, c),
             "plain_vs_cpu": compare(p, c)}
        row[name] = r
        kp, kc = r["kernel_vs_plain"], r["card_vs_cpu"]
        ok &= (launches == [1, 1] and kp["loss_rel"] <= STEP_TOL
               and kc["loss_rel"] <= CPU_TOL
               and kp["bn_stats_max_abs"] <= STEP_TOL
               and kc["bn_stats_max_abs"] <= CPU_TOL)
        for side, dev in (("kernel_vs_plain", kp), ("card_vs_cpu", kc)):
            ok &= max(dev["update_rel_l2"],
                      dev["ema_update_rel_l2"]) <= UPDATE_L2[(name, side)]
        if name == "smooth":
            ok &= kp["grad_rel"] <= STEP_TOL and kc["grad_rel"] <= CPU_TOL
        else:
            ok &= (kp["grad_rel_l2"] <= REF_GRAD_L2["kernel_vs_plain"]
                   and kc["grad_rel_l2"] <= REF_GRAD_L2["card_vs_cpu"])

    # 10 steps at lr 1e-3 on the fixed batch: kernel vs plain held on the
    # smooth terms (loss and the 10-step update), reported on the reference
    # loss; kernel vs kernel on the reference loss held equal, and read
    # with cuDNN's nondeterministic algorithms and with every op's
    # deterministic one
    runs = {}
    for name, kw in (("smooth", SMOOTH_TERMS), ("reference", {})):
        for label, plain in (("kernel", False), ("plain", True)):
            runs[f"{name}_{label}"] = run("cuda", plain, 10,
                                          learning_rate=1e-3, **kw)
    runs["reference_kernel_again"] = run("cuda", False, 10,
                                         learning_rate=1e-3)
    for label in ("", "_again"):
        runs[f"reference_kernel_cudnn_nondeterministic{label}"] = run(
            "cuda", False, 10, cudnn_deterministic=False, learning_rate=1e-3)
    with _all_deterministic(torch) as ops:
        runs["reference_kernel_all_deterministic"] = run(
            "cuda", False, 10, learning_rate=1e-3)
    curves = {key: r[0] for key, r in runs.items()}

    def gap(a, b):
        return max(abs(x - y) for x, y in zip(curves[a], curves[b]))

    row["losses"] = curves
    row["trajectory_gap"] = {
        "smooth_kernel_vs_plain": gap("smooth_kernel", "smooth_plain"),
        "reference_kernel_vs_plain": gap("reference_kernel",
                                         "reference_plain"),
        "reference_kernel_vs_kernel": gap("reference_kernel",
                                          "reference_kernel_again"),
        "reference_kernel_vs_kernel_cudnn_nondeterministic": gap(
            "reference_kernel_cudnn_nondeterministic",
            "reference_kernel_cudnn_nondeterministic_again"),
        "reference_kernel_vs_all_deterministic": gap(
            "reference_kernel", "reference_kernel_all_deterministic")}
    row["ops_without_deterministic_version"] = ops
    row["trajectory_update_rel_l2"] = {
        "smooth_kernel_vs_plain": _rel_l2(update(runs["smooth_kernel"][2]),
                                          update(runs["smooth_plain"][2])),
        "reference_kernel_vs_kernel": _rel_l2(
            update(runs["reference_kernel"][2]),
            update(runs["reference_kernel_again"][2]))}
    emit(row)
    ok &= (row["trajectory_gap"]["smooth_kernel_vs_plain"] <= CPU_TOL
           and row["trajectory_update_rel_l2"]["smooth_kernel_vs_plain"]
           <= TRAJ_UPDATE_L2
           and row["trajectory_gap"]["reference_kernel_vs_kernel"] == 0.0
           and row["trajectory_update_rel_l2"]["reference_kernel_vs_kernel"]
           == 0.0)
    for key in curves:
        ok &= bool(np.isfinite(curves[key]).all()
                   and curves[key][-1] < curves[key][0])
    if not ok:
        raise AssertionError(f"train step check failed: {row}")


def _write_corpus(root, files: int, seconds: float, rate: int = 22050):
    from ml_audio_restoration_torch.audio import save_audio

    os.makedirs(root, exist_ok=True)
    frames = int(seconds * rate)
    for i in range(files):
        save_audio(os.path.join(root, f"take_{i:03d}.wav"),
                   _stereo_batch(1, frames, seed=1000 + i)["stereo"][0], rate)


def _train_config(name: str, root, ckpt_dir: str, batch: int,
                  seconds: float):
    """One epoch of `name` over the WAVs in <root>/wavs: Adam at 1e-4, f32,
    a checkpoint every epoch into <root>/<ckpt_dir>."""
    from ml_audio_restoration_torch.config import Config

    cfg = Config()
    cfg.train.model = name
    cfg.train.batch_size = batch
    cfg.train.learning_rate = 1e-4
    cfg.train.num_epochs = 1
    cfg.train.save_every = 1
    cfg.train.checkpoint_dir = os.path.join(root, ckpt_dir)
    cfg.train.log_dir = os.path.join(root, "runs")
    cfg.data.data_dir = os.path.join(root, "wavs")
    cfg.data.chunk_duration = seconds
    return cfg


def phase_train_full(torch):
    """The training path at full width through train_from_config: seeded
    stereo WAVs, 2 s chunks at 22.05 kHz, batch 16, f32, Adam at 1e-4.
    Returns the K2 and K3 launches of the 12-step run, by kernel name."""
    from ml_audio_restoration_torch.models import count_params
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.train.trainer import (
        build_trainer, train_from_config)

    steps, batch, seconds = 12, 16, 2.0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _write_corpus(os.path.join(tmp, "wavs"), files=224, seconds=2.5)
        corpus_s = time.perf_counter() - t0

        def config(ckpt_dir):
            return _train_config("stereo_separator", tmp, ckpt_dir, batch,
                                 seconds)

        # the main path: one epoch of 12 steps plus validation, counted
        torch.cuda.synchronize()
        L.reset_launch_count()
        t0 = time.perf_counter()
        history = train_from_config(config("ck"), steps_per_epoch=steps)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts = {"lstm_train_fwd": L.train_fwd_launch_count,
                  "lstm_train_bwd": L.train_bwd_launch_count,
                  "lstm_recurrence_validation": L.launch_count}
        written = sorted(os.listdir(os.path.join(tmp, "ck",
                                                 "stereo_separator")))

        # 2 warm-up and 10 timed steps from the same loader
        tr = build_trainer(config("ck_timed"), steps_per_epoch=steps)
        it = iter(tr.train_loader)
        for _ in range(2):
            tr._train_step(next(it))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        L.reset_launch_count()
        t0 = time.perf_counter()
        timed = 0
        for b in it:
            tr._train_step(b)
            timed += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        per_step = {"lstm_train_fwd": L.train_fwd_launch_count / timed,
                    "lstm_train_bwd": L.train_bwd_launch_count / timed}

        # the step split by CUDA events on one batch
        b = next(iter(tr.train_loader))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        split = {"forward": 0.0, "loss": 0.0, "backward": 0.0,
                 "optimizer": 0.0}
        reps = 3
        for _ in range(reps):
            inputs, targets = tr._derive(b)
            tr.model.train()
            tr.optimizer.zero_grad(set_to_none=True)
            ev[0].record()
            out = tr._forward(inputs)
            ev[1].record()
            loss, _ = tr._criterion(out, targets)
            ev[2].record()
            loss.backward()
            ev[3].record()
            tr._update()
            ev[4].record()
            torch.cuda.synchronize()
            for i, key in enumerate(split):
                split[key] += ev[i].elapsed_time(ev[i + 1]) / reps
        del out, loss

        # what cuDNN's deterministic algorithms cost a step: the same
        # batch, with and without them, interleaved
        same_batch = {False: [], True: []}
        was = torch.backends.cudnn.deterministic
        for det in (False, True, False, True):
            torch.backends.cudnn.deterministic = det
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                tr._train_step(b)
            torch.cuda.synchronize()
            same_batch[det].append((time.perf_counter() - t0) * 1e3 / 3)
        torch.backends.cudnn.deterministic = was

        # checkpoint, then resume in a fresh trainer
        tr.epoch = 1
        tr.save_checkpoint("checkpoint_epoch_1.pth")
        fresh = build_trainer(config("ck_timed"), steps_per_epoch=steps)
        resumed = (fresh.epoch == tr.epoch
                   and fresh.global_step == tr.global_step
                   and fresh.lr == tr.lr
                   and all(torch.equal(a, b) for a, b in zip(
                       tr.model.state_dict().values(),
                       fresh.model.state_dict().values())))

    row = {"phase": "train_full", "params": count_params(tr.model),
           "batch": batch, "chunk_seconds": seconds, "dtype": "float32",
           "corpus_write_s": corpus_s, "epoch_s": epoch_s,
           "history": history, "checkpoints": written,
           "main_path_launches": counts, "timed_steps": timed,
           "timed_wall_s": wall, "step_ms": wall * 1e3 / timed,
           "audio_s_per_s": timed * batch * seconds / wall,
           "split_ms": split, "split_sum_ms": sum(split.values()),
           "same_batch_step_ms": {
               "cudnn_nondeterministic": same_batch[False],
               "cudnn_deterministic": same_batch[True]},
           "launches_per_step": per_step, "peak_mem_bytes": peak,
           "resumed_exactly": resumed}
    emit(row)
    finite = all(np.isfinite(history["train_loss"] + history["val_loss"]))
    if not (finite and counts["lstm_train_fwd"] == steps
            and counts["lstm_train_bwd"] == steps
            and counts["lstm_recurrence_validation"] >= 1
            and per_step == {"lstm_train_fwd": 1.0, "lstm_train_bwd": 1.0}
            and "best_model.pth" in written and timed == 10 and resumed):
        raise AssertionError(f"training run failed: {row}")
    return {name: counts[name] for name in ("lstm_train_fwd",
                                            "lstm_train_bwd")}


# The conv-net families at their published widths (config/denoiser.yaml,
# config/super_resolution.yaml): the batch key their dataset yields, its
# pairing, the corpus rate and the parameter count.
CONVNETS = {
    "denoiser": {"key": "clean", "pairing": "degrade", "rate": 22050,
                 "params": 676242},
    "super_resolution": {"key": "high", "pairing": "downsample",
                         "rate": 44100, "params": 38273}}
DEGRADE_TOL = 1e-5  # the simulator, card vs CPU on the same draws: FFTs
#                     and convolutions summed in another order


def _mono_batch(batch: int, frames: int, rate: int, seed: int):
    """Tones under noise at -20 dB RMS, [B, 1, T] float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / rate
    out = np.empty((batch, 1, frames), np.float32)
    for i in range(batch):
        x = (np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
             + 0.5 * rng.standard_normal(frames))
        out[i, 0] = 0.1 * x / np.sqrt(np.mean(x ** 2))
    return out


def _convnet_trainer(torch, name, model, device, **cfg):
    from ml_audio_restoration_torch.config import TrainConfig
    from ml_audio_restoration_torch.train.trainer import Trainer

    return Trainer(name, model, [], config=TrainConfig(model=name, **cfg),
                   pairing=CONVNETS[name]["pairing"], device=device)


def _convnet_degradation(torch):
    """The simulator on the card against the CPU, on the same draws (made
    on the CPU, then moved): batch 16 of 2 s at 22.05 kHz; then its pieces
    timed on the card (median of 5 warm calls each)."""
    from ml_audio_restoration_torch.config import ArtifactConfig
    from ml_audio_restoration_torch.data import artifacts as A
    from ml_audio_restoration_torch.ops.filters import bank_index

    rate, cfg = 22050, ArtifactConfig()
    clean = torch.from_numpy(_mono_batch(16, 44100, rate, seed=21))
    draws = A.draw_artifacts(torch.Generator().manual_seed(21), clean.shape,
                             rate)
    want = A.apply_artifacts(clean, draws, rate)
    x = clean.cuda()
    cuda_draws = {k: v.cuda() for k, v in draws.items()}
    got = A.apply_artifacts(x, cuda_draws, rate)
    again = A.apply_artifacts(x, cuda_draws, rate)
    fir = {taps: torch.as_tensor(A.zero_phase_fir(4, cut, rate, band, taps),
                                 device="cuda")
           for cut, band, taps in ((2500.0, "high", 257),
                                   (100.0, "low", 2049))}
    bank = torch.as_tensor(A.zero_phase_fir_bank(
        3, *cfg.rolloff_freq, rate, "low", 129, num=A.ROLLOFF_BANK),
        device="cuda")
    per_item = bank[bank_index(A.ROLLOFF_BANK, cuda_draws["rolloff_freq"],
                               *cfg.rolloff_freq).long()]
    gen = torch.Generator(device="cuda")
    pieces = {
        "draws": lambda: A.draw_artifacts(gen.manual_seed(1), x.shape, rate),
        "pops": lambda: A._make_pops(cuda_draws, x.shape[-1], rate, cfg),
        "crackle_fft_257": lambda: A._fir_same(x, fir[257]),
        "rumble_fft_2049": lambda: A._fir_same(x, fir[2049]),
        "rolloff_conv_129": lambda: A._fir_same(x, per_item),
        "apply_artifacts": lambda: A.apply_artifacts(x, cuda_draws, rate),
        "simulate_batch": lambda: A.simulate_batch(gen.manual_seed(1), x,
                                                   rate)}
    split = {k: _cuda_ms(torch, fn, 5) for k, fn in pieces.items()}
    return {"shape": list(clean.shape), "max_abs": _max_dev(got.cpu(), want),
            "tol": DEGRADE_TOL, "repeats_exactly": bool(torch.equal(got,
                                                                     again)),
            "pops": int(draws["pop_count"].sum()),
            "degraded_minus_clean_max": _max_dev(want, clean),
            "card_ms": split}


def _convnet_step(torch, name, base):
    """One optimizer step, card vs CPU, at batch 2 of the full-width chunk
    on one degradation (a CPU generator gives the same draws on both):
    TrainConfig defaults with clipping and EMA, on the smooth terms
    (entry by entry) and on the reference loss (its gradient as a relative
    L2 norm, SMOOTH_TERMS' comment). The smooth terms' gradients are also
    read against a float64 step on the CPU (the same f32 inputs), which
    says which side's f32 rounding the card-vs-CPU deviation comes from."""
    import copy

    spec = CONVNETS[name]
    frames = 88200 if name == "super_resolution" else 44100
    batch = {spec["key"]: _mono_batch(2, frames, spec["rate"], seed=22)}
    cfg = {"max_grad_norm": 1.0, "ema_decay": 0.999}

    def grads_of(tr):
        return [p.grad.detach().cpu().float() for p in tr.model.parameters()]

    out = {}
    for label, kw in (("smooth", {"spectral_weight": 0.0}),
                      ("reference", {})):
        sides = []
        for device in ("cuda", "cpu"):
            tr = _convnet_trainer(torch, name, copy.deepcopy(base), device,
                                  **cfg, **kw)
            loss = float(tr._train_step(
                batch, torch.Generator().manual_seed(23))["loss"])
            stats = [v.detach().cpu() for k, v in tr.model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))]
            sides.append((loss, grads_of(tr), stats))
        (lc, gc, sc), (lh, gh, sh) = sides
        names = [n for n, _ in base.named_parameters()]
        devs = [_max_dev(a, b) for a, b in zip(gc, gh)]
        out[label] = {"loss": lc, "loss_rel": abs(lc - lh) / abs(lh),
                      "grad_rel": _grad_devs(gc, gh),
                      "grad_worst_param": names[int(np.argmax(devs))],
                      "grad_rel_l2": _rel_l2(gc, gh),
                      "bn_stats_max_abs": max(_max_dev(a, b)
                                              for a, b in zip(sc, sh))}
        if label == "smooth":
            ref = _convnet_trainer(torch, name, copy.deepcopy(base).double(),
                                   "cpu", **cfg, **kw)
            inputs, targets = ref._derive(batch,
                                          torch.Generator().manual_seed(23))
            ref.model.train()
            loss, _ = ref._loss(inputs.double(), targets.double())
            loss.backward()
            ref._update()  # clips the gradients in place, as the f32 steps
            g64 = grads_of(ref)
            out[label].update({"card_vs_f64_grad_rel": _grad_devs(gc, g64),
                               "cpu_vs_f64_grad_rel": _grad_devs(gh, g64)})
    return out


def _convnet_runs(torch, name, base, steps: int = 10):
    """Two `steps`-step runs on the card from one seed, the degradation
    drawn per step from the trainer's (epoch, step) stream: losses and
    final weights, BN statistics and EMA."""
    import copy

    spec = CONVNETS[name]
    frames = 88200 if name == "super_resolution" else 44100
    batch = {spec["key"]: _mono_batch(16, frames, spec["rate"], seed=24)}
    runs = []
    for _ in range(2):
        tr = _convnet_trainer(torch, name, copy.deepcopy(base), "cuda",
                              learning_rate=1e-3, ema_decay=0.999)
        losses = [float(tr._train_step(batch, tr._seeded(2, i))["loss"])
                  for i in range(steps)]
        state = dict(tr.model.state_dict())
        state.update({f"ema.{k}": v for k, v in tr.ema_params.items()})
        runs.append((losses, state))
    (la, sa), (lb, sb) = runs
    return {"losses": la, "equal": la == lb and all(
        torch.equal(v, sb[k]) for k, v in sa.items())}


def _write_mono_corpus(root, files: int, seconds: float, rate: int):
    from ml_audio_restoration_torch.audio import save_audio

    os.makedirs(root, exist_ok=True)
    frames = int(seconds * rate)
    for i in range(files):
        save_audio(os.path.join(root, f"take_{i:03d}.wav"),
                   _mono_batch(1, frames, rate, seed=2000 + i)[0], rate)


def _convnet_from_config(torch, name, root):
    """train_from_config over seeded WAVs at batch 16 of 2 s with
    validation; then 10 timed steps (audio-s/s, the step split by CUDA
    events, peak memory) and a checkpoint resumed in a fresh trainer whose
    next step equals the uninterrupted trainer's."""
    from ml_audio_restoration_torch.train.trainer import (
        build_trainer, train_from_config)

    steps, batch, seconds = 12, 16, 2.0
    spec = CONVNETS[name]
    t0 = time.perf_counter()
    _write_mono_corpus(os.path.join(root, "wavs"), 224, 2.5, spec["rate"])
    corpus_s = time.perf_counter() - t0

    def config(ckpt_dir):
        return _train_config(name, root, ckpt_dir, batch, seconds)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = train_from_config(config("ck"), steps_per_epoch=steps)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    written = sorted(os.listdir(os.path.join(root, "ck", name)))

    # 2 warm-up and 10 timed steps from the same loader, each step's
    # degradation drawn from its (epoch, step) stream as train() does
    tr = build_trainer(config("ck_timed"), steps_per_epoch=steps)
    tr.epoch = 1
    it = enumerate(tr.train_loader)
    for _ in range(2):
        i, b = next(it)
        tr._train_step(b, tr._seeded(2, i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timed = 0
    for i, b in it:
        tr._train_step(b, tr._seeded(2, i))
        timed += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    # the step split by CUDA events on one batch
    b = next(iter(tr.train_loader))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    split = {"derive": 0.0, "forward": 0.0, "loss": 0.0, "backward": 0.0,
             "optimizer": 0.0}
    reps = 3
    for r in range(reps):
        ev[0].record()
        inputs, targets = tr._derive(b, tr._seeded(2, 100 + r))
        ev[1].record()
        tr.model.train()
        tr.optimizer.zero_grad(set_to_none=True)
        out = tr._forward(inputs)
        ev[2].record()
        loss, _ = tr._criterion(out, targets)
        ev[3].record()
        loss.backward()
        ev[4].record()
        tr._update()
        ev[5].record()
        torch.cuda.synchronize()
        for k, key in enumerate(split):
            split[key] += ev[k].elapsed_time(ev[k + 1]) / reps
    del out, loss

    # checkpoint, resume in a fresh trainer, and take the next step on both
    tr.save_checkpoint("checkpoint_epoch_1.pth")
    fresh = build_trainer(config("ck_timed"), steps_per_epoch=steps)
    same_progress = (fresh.epoch, fresh.global_step, fresh.lr) == (
        tr.epoch, tr.global_step, tr.lr)
    losses = [float(t._train_step(b, t._seeded(4, 0))["loss"])
              for t in (tr, fresh)]
    resumed = same_progress and losses[0] == losses[1] and all(
        torch.equal(x, y) for x, y in zip(tr.model.state_dict().values(),
                                          fresh.model.state_dict().values()))

    # the forward's and backward's FLOPs as torch's counter sees them (the
    # convolutions and matrix products, not elementwise work or the FFTs),
    # over the split's times: the rate the step's convolutions reach
    from torch.utils.flop_counter import FlopCounterMode

    inputs, targets = fresh._derive(b, fresh._seeded(2, 200))
    fresh.model.train()
    with FlopCounterMode(display=False) as counted:
        out = fresh._forward(inputs)
    fwd_flops = counted.get_total_flops()
    loss, _ = fresh._criterion(out, targets)
    with FlopCounterMode(display=False) as counted:
        loss.backward()
    bwd_flops = counted.get_total_flops()
    del out, loss
    return {"corpus_write_s": corpus_s, "epoch_s": epoch_s,
            "history": history, "checkpoints": written,
            "timed_steps": timed, "timed_wall_s": wall,
            "step_ms": wall * 1e3 / timed,
            "audio_s_per_s": timed * batch * seconds / wall,
            "split_ms": split, "split_sum_ms": sum(split.values()),
            "counted_flops": {"forward": fwd_flops, "backward": bwd_flops},
            "tflops_per_s": {"forward": fwd_flops / split["forward"] / 1e9,
                             "backward": bwd_flops / split["backward"]
                             / 1e9},
            "peak_mem_bytes": peak, "resumed_next_step_equal": resumed}


def phase_train_convnets(torch):
    """The denoiser and super-resolution training paths at full width
    (config/denoiser.yaml: 32/64/128, batch 16, 2 s at 22.05 kHz;
    config/super_resolution.yaml: base 32, 4 blocks, batch 16, 2 s at
    44.1 kHz), seeded random weights: for each family the degradation
    (denoiser), one step card vs CPU, two seeded 10-step runs equal bit for
    bit, and train_from_config over seeded WAVs written under profiles/
    (removed after), timed. One JSON line a family."""
    import shutil

    from ml_audio_restoration_torch.models import count_params, init_params
    from ml_audio_restoration_torch.train.trainer import MODELS

    for name, spec in CONVNETS.items():
        base = init_params(MODELS[name](), torch.Generator().manual_seed(20))
        row = {"phase": "train_convnets", "family": name,
               "params": count_params(base), "pairing": spec["pairing"],
               "batch": 16, "chunk_seconds": 2.0, "rate": spec["rate"],
               "dtype": "float32", "tol": {"step": STEP_TOL,
                                           "degradation": DEGRADE_TOL,
                                           "smooth_grad_card_vs_cpu": CPU_TOL,
                                           "reference_grad_rel_l2":
                                           REF_GRAD_L2["card_vs_cpu"]}}
        if name == "denoiser":
            row["degradation"] = _convnet_degradation(torch)
        row["step_card_vs_cpu"] = _convnet_step(torch, name, base)
        row["repeat_10_steps"] = _convnet_runs(torch, name, base)
        root = os.path.join(ROOT, "profiles", f"chip_smoke_{name}")
        shutil.rmtree(root, ignore_errors=True)
        try:
            row["from_config"] = _convnet_from_config(torch, name, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        emit(row)
        step, fc = row["step_card_vs_cpu"], row["from_config"]
        ok = (row["params"] == spec["params"]
              and row["repeat_10_steps"]["equal"]
              and fc["resumed_next_step_equal"] and fc["timed_steps"] == 10
              and "best_model.pth" in fc["checkpoints"]
              and all(np.isfinite(fc["history"]["train_loss"]
                                  + fc["history"]["val_loss"]))
              and step["reference"]["grad_rel_l2"]
              <= REF_GRAD_L2["card_vs_cpu"])
        for side in step.values():
            ok &= (side["loss_rel"] <= STEP_TOL
                   and side["bn_stats_max_abs"] <= STEP_TOL)
        # card vs CPU gradients at the chain's card-vs-CPU bar, as the
        # stereo phase holds them: at -20 dB input the first conv's bias
        # dominates its output and the BN-cancelled gradients of the early
        # layers carry each side's f32 summation order (read 1.9e-4 for the
        # denoiser; the f64 readings beside it say which side drifts)
        ok &= step["smooth"]["grad_rel"] <= CPU_TOL
        curve = row["repeat_10_steps"]["losses"]
        ok &= bool(np.isfinite(curve).all() and curve[-1] < curve[0])
        if "degradation" in row:
            deg = row["degradation"]
            ok &= (deg["max_abs"] <= DEGRADE_TOL and deg["repeats_exactly"]
                   and deg["degraded_minus_clean_max"] > 0.1)
        if not ok:
            raise AssertionError(f"conv-net training failed: {row}")


ROOT = os.path.dirname(os.path.abspath(__file__))


def _k1_library(torch, gates, w_hh, h0, c0):
    """cuDNN's nn.LSTM with an identity input projection over the same
    gates and carry (a yardstick, never called by the port): (median ms of
    3 calls, its output [T, B, H]) or (None, why cuDNN refused)."""
    h = w_hh.shape[0]
    dev = gates.device
    ref = torch.nn.LSTM(4 * h, h).to(device=dev, dtype=gates.dtype).eval()
    with torch.no_grad():
        ref.weight_ih_l0.copy_(torch.eye(4 * h, device=dev))
        ref.weight_hh_l0.copy_(w_hh.T)
        ref.bias_ih_l0.zero_()
        ref.bias_hh_l0.zero_()
    state = (h0[None].to(gates.dtype).contiguous(),
             c0[None].to(gates.dtype).contiguous())
    run = lambda: ref(gates, state)[0]  # noqa: E731
    try:
        with torch.inference_mode():
            out = run()
            return _cuda_ms(torch, run, 3), out
    except RuntimeError as e:  # the yardstick only: cuDNN may refuse
        return None, str(e)[:200]


def _k1_at(torch, L, path, t, b, dtype, carry, floor_ns, seed):
    """K1 at one serving shape (H=64): against its plain version on the
    same inputs, timed (median of 5 calls) beside its bound, its latency
    floor over the waves the launch takes, the plain version and cuDNN."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    h = 64
    gates = randn(t, b, 4 * h, scale=0.5).to(dtype)
    w_hh = randn(h, 4 * h, scale=0.15).to(dtype)
    if carry:
        h0, c0 = randn(b, h, scale=0.3), randn(b, h, scale=0.3)
    else:
        h0 = c0 = torch.zeros(b, h, device=dev)
    run = lambda: L._lstm_recurrence_cuda(gates, w_hh, h0, c0)  # noqa: E731
    out_k = run()
    ms = _cuda_ms(torch, run, 5)
    plain_ms, out_p = _timed_once(
        torch, lambda: L.lstm_recurrence_plain(gates, w_hh, h0, c0))
    err = max(_max_dev(x, y) for x, y in zip(out_k, out_p))
    del out_p
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    res = L.recurrence_resources(h, dtype)
    waves = -(-b // (res["ctas_per_sm"] * res["sms"]))
    item = gates.element_size()
    n_bytes = (item * (t * b * 4 * h + h * 4 * h + t * b * h)
               + 4 * 4 * b * h)  # gates, W_hh, out; h0, c0, hf, cf
    flops = 2.0 * t * b * h * 4 * h  # the h @ W_hh products
    # bf16 h and W_hh with an f32 sum are the tensor cores' bf16 rate
    bound_ms, bound_by = _bound(n_bytes, flops, H100_BF16_FLOPS
                                if dtype == torch.bfloat16 else H100_F32_FLOPS)
    library_ms, lib = _k1_library(torch, gates, w_hh, h0, c0)
    lib_dev = (_max_dev(lib.transpose(0, 1), out_k[0])
               if library_ms is not None else lib)
    row = {"path": path, "shape": [t, b, h], "dtype": str(dtype)[6:],
           "carry_in": carry, "ms": ms, "plain_ms": plain_ms,
           "max_abs_err": err, "tol": tol, "bytes": n_bytes,
           "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
           "floor_ms": waves * t * floor_ns * 1e-6,
           "ns_per_step": ms * 1e6 / t,
           "ns_per_step_per_wave": ms * 1e6 / (t * waves),
           "waves": waves, **res, "library_ms": library_ms,
           "library_vs_kernel_max_abs": lib_dev}
    emit({"phase": "kernel_check", "kernel": "lstm_recurrence",
          "path": path, "shape": [t, b, h], "dtype": row["dtype"],
          "max_abs_err": err, "tol": tol})
    emit({"phase": "kernel_time", "kernel": "lstm_recurrence", **row})
    if not err <= tol:
        raise AssertionError(f"lstm_recurrence disagrees with plain at "
                             f"{path}'s shape: {row}")
    del gates, out_k, lib
    torch.cuda.empty_cache()
    return row


def phase_k1_shapes(torch):
    """K1 at the shapes the serving paths give it: the 0.25 s stereo
    windows of a 120 s restore (64 chunks x 10 windows of 11,024 steps)
    in bf16 (fast_serve) and f32, source-rate stereo's 64 chunks of
    44,100 steps, and a streaming feed of 16 streams in
    0.5 s blocks (22,048 committed steps, then 1,040 lookahead steps, both
    from a carry). Returns the rows by path."""
    from ml_audio_restoration_torch.ops import _latency
    from ml_audio_restoration_torch.ops import lstm as L

    floor = _latency.step_floor(64, {"k1": 1, "k2": 1, "k3": 1},
                                torch.device("cuda"))
    floor_ns = floor["floor"]["k1"]["ns_per_step"]
    emit({"phase": "latency_probe", "for": "k1_shapes", **floor})
    rows = {}
    for i, (path, t, b, dtype, carry) in enumerate((
            ("serve_fast", 11024, 640, torch.bfloat16, False),
            ("serve_sub_f32", 11024, 640, torch.float32, False),
            ("serve_source_rate", 44100, 64, torch.float32, False),
            ("stream_committed", 22048, 16, torch.float32, True),
            ("stream_lookahead", 1040, 16, torch.float32, True))):
        rows[path] = _k1_at(torch, L, path, t, b, dtype, carry, floor_ns,
                            seed=10 + i)
    return rows


def _timed_restore(torch, L, pipe, clip, rate):
    """(output, wall s, K1 launches, peak bytes) of one restore, the counts
    set to 0 just before it and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L.reset_launch_count()
    t0 = time.perf_counter()
    y, _ = pipe.restore(clip, rate)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return y, wall, L.launch_count, torch.cuda.max_memory_allocated()


def _serve_stage_ms(torch, pipe, clip, rate):
    """Device ms of each stage of one restore's chunk batch (sub-chunked
    stereo included), median of 3 calls each."""
    from ml_audio_restoration_torch.ops import (
        frame_structured, num_chunks, overlap_add)
    from ml_audio_restoration_torch.pipeline.restore import (
        _bucket, apply_stereo, stereo_sub_cfg)

    cfg = pipe.config
    chunk, hop, overlap = pipe._framing(rate)
    n_real = num_chunks(clip.shape[1], chunk, hop)
    n = _bucket(n_real)
    total = (n - 1) * hop + chunk
    dn, sr, st = pipe._models()
    sub = stereo_sub_cfg(cfg, chunk * 2, 2, sample_rate=rate)
    audio = torch.nn.functional.pad(torch.from_numpy(clip).to(pipe.device),
                                    (0, total - clip.shape[1]))
    stage_ms = {}
    with torch.inference_mode():
        x = frame_structured(audio, n, chunk, hop).permute(0, 2, 1).to(
            getattr(torch, cfg.compute_dtype))
        for name, fn in (("denoiser", dn), ("super_resolution", sr),
                         ("stereo", lambda v: apply_stereo(st, v, sub))):
            x_in = x
            stage_ms[name] = _cuda_ms(torch, lambda: fn(x_in), 3)
            x = fn(x_in)
        y = x.float()
        stage_ms["overlap_add"] = _cuda_ms(
            torch, lambda: overlap_add(y, hop * 2, total * 2,
                                       overlap=overlap * 2, valid=n_real), 3)
    return stage_ms


def phase_serve_fast(torch, k1_rows):
    """The repo's measured serving preset, config/fast_serve.yaml (bf16,
    0.25 s stereo windows), over a 120 s clip: warmup, then one restore
    counted and timed; the same through the plain recurrence and in f32."""
    import dataclasses

    from ml_audio_restoration_torch.config import load_config
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.pipeline import RestorationPipeline

    cfg = load_config(os.path.join(ROOT, "config", "fast_serve.yaml")).pipeline
    dn, sr, st = _models(torch, torch.device("cuda"))
    pipe = RestorationPipeline(dn, sr, st, config=cfg)
    rate, seconds = cfg.sample_rate, 120.0
    clip = _clip(seconds, rate, seed=3)
    warm = pipe.warmup()
    y, wall, launches, peak = _timed_restore(torch, L, pipe, clip, rate)
    with L.plain_recurrence():
        y_p, _ = pipe.restore(clip, rate)
    f32 = RestorationPipeline(dn, sr, st, config=dataclasses.replace(
        cfg, compute_dtype="float32"))
    f32.restore(clip, rate)  # cuDNN picks its f32 algorithms
    y32, wall32, launches32, peak32 = _timed_restore(torch, L, f32, clip,
                                                     rate)
    # what the 0.25 s windows buy in bf16: the same clip on full windows
    full = RestorationPipeline(dn, sr, st, config=dataclasses.replace(
        cfg, stereo_chunk_seconds=None))
    full.restore(clip, rate)
    _, wall_full, _, _ = _timed_restore(torch, L, full, clip, rate)
    ref_peak = float(y32.abs().max())
    row = {"phase": "serve_fast", "config": "config/fast_serve.yaml",
           "compute_dtype": cfg.compute_dtype,
           "stereo_chunk_seconds": cfg.stereo_chunk_seconds,
           "seconds": seconds, "shape": list(y.shape),
           "finite": bool(torch.isfinite(y).all()), "wall_s": wall,
           "xrt": seconds / wall, "lstm_recurrence_launches": launches,
           "peak_mem_bytes": peak, "warmup": warm,
           "stage_ms": _serve_stage_ms(torch, pipe, clip, rate),
           "k1_ms_at_shape": k1_rows["serve_fast"]["ms"],
           "k1_shape": k1_rows["serve_fast"]["shape"],
           "kernel_vs_plain_max_abs": _max_dev(y, y_p),
           "kernel_vs_plain_tol": BF16_CHAIN_TOL,
           "bf16_vs_f32_max_abs": _max_dev(y, y32),
           "bf16_vs_f32_tol": BF16_REL * ref_peak, "f32_peak": ref_peak,
           "f32_wall_s": wall32, "f32_xrt": seconds / wall32,
           "f32_peak_mem_bytes": peak32,
           "bf16_full_window_wall_s": wall_full,
           "bf16_full_window_xrt": seconds / wall_full}
    emit(row)
    if not (row["finite"] and tuple(y.shape) == (2, 2 * clip.shape[1])
            and launches >= 1 and launches32 >= 1
            and row["kernel_vs_plain_max_abs"] <= BF16_CHAIN_TOL
            and row["bf16_vs_f32_max_abs"] <= row["bf16_vs_f32_tol"]):
        raise AssertionError(f"fast_serve restore failed: {row}")
    return launches, row["kernel_vs_plain_max_abs"], BF16_CHAIN_TOL


def phase_serve_options(torch):
    """The 120 s clip in f32 under each stereo option alone: 0.25 s
    windows, mid-exact and source-rate, each counted, timed and held
    against its plain-recurrence run; mid-exact and source-rate also keep
    the SR output as their mid."""
    import dataclasses

    from ml_audio_restoration_torch.config import PipelineConfig
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.pipeline import RestorationPipeline

    dn, sr, st = _models(torch, torch.device("cuda"))
    rate, seconds = 22050, 120.0
    clip = _clip(seconds, rate, seed=3)
    base = PipelineConfig()
    mono, _ = RestorationPipeline(dn, sr, None, config=base).restore(clip,
                                                                     rate)
    out = {}
    for name, extra in (("sub_0.25", {"stereo_chunk_seconds": 0.25}),
                        ("mid_exact", {"stereo_mid_exact": True}),
                        ("source_rate", {"stereo_source_rate": True})):
        pipe = RestorationPipeline(dn, sr, st,
                                   config=dataclasses.replace(base, **extra))
        pipe.restore(clip, rate)  # cuDNN picks its algorithms
        y, wall, launches, peak = _timed_restore(torch, L, pipe, clip, rate)
        with L.plain_recurrence():
            y_p, _ = pipe.restore(clip, rate)
        row = {"phase": "serve_options", "option": name, "seconds": seconds,
               "shape": list(y.shape), "finite": bool(torch.isfinite(y).all()),
               "wall_s": wall, "xrt": seconds / wall,
               "lstm_recurrence_launches": launches, "peak_mem_bytes": peak,
               "kernel_vs_plain_max_abs": _max_dev(y, y_p),
               "kernel_vs_plain_tol": PIPE_TOL}
        ok = (row["finite"] and tuple(y.shape) == (2, 2 * clip.shape[1])
              and launches >= 1 and row["kernel_vs_plain_max_abs"] <= PIPE_TOL)
        if name != "sub_0.25":
            row["mid_vs_sr_output_max_abs"] = _max_dev(y.mean(0), mono[0])
            row["mid_tol"] = MID_TOL
            ok &= row["mid_vs_sr_output_max_abs"] <= MID_TOL
        emit(row)
        if not ok:
            raise AssertionError(f"restore option {name} failed: {row}")
        out[name] = (launches, row["kernel_vs_plain_max_abs"], PIPE_TOL)
        del y, y_p
    return out


def phase_serve_many(torch):
    """Coalesced serving: eight 10 s recordings and one of 150 s (too long
    to coalesce: slabs) through restore_many against single restores, then
    restore_directory (coalesce 4) against restore_file over the same
    recordings as WAVs in profiles/ (listed in .gitignore), removed after."""
    import shutil

    from ml_audio_restoration_torch.audio import load_audio, save_audio
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.pipeline import RestorationPipeline

    dn, sr, st = _models(torch, torch.device("cuda"))
    pipe = RestorationPipeline(dn, sr, st)
    rate = pipe.config.sample_rate
    clips = ([_clip(10.0, rate, seed=100 + i) for i in range(8)]
             + [_clip(150.0, rate, seed=200)])
    audio_s = sum(c.shape[1] for c in clips) / rate
    pipe.restore_many(clips)
    runs, outs = {}, {}
    for name, fn in (("restore_many", lambda: pipe.restore_many(clips)),
                     ("single", lambda: [pipe.restore(c, rate)
                                         for c in clips])):
        torch.cuda.synchronize()
        L.reset_launch_count()
        t0 = time.perf_counter()
        outs[name] = fn()
        torch.cuda.synchronize()
        runs[name] = (None, time.perf_counter() - t0, L.launch_count)
    many, single = outs.pop("restore_many"), outs.pop("single")
    shapes_ok = all(a[0].shape == b[0].shape == (2, 2 * c.shape[1])
                    for a, b, c in zip(many, single, clips))
    dev = max(_max_dev(a[0], b[0]) for a, b in zip(many, single))
    del many, single

    root = os.path.join(ROOT, "profiles", "chip_smoke_serve_many")
    shutil.rmtree(root, ignore_errors=True)
    try:
        os.makedirs(os.path.join(root, "in"))
        for i, c in enumerate(clips):
            save_audio(os.path.join(root, "in", f"rec_{i}.wav"), c, rate)
        torch.cuda.synchronize()
        L.reset_launch_count()
        t0 = time.perf_counter()
        written = pipe.restore_directory(os.path.join(root, "in"),
                                         os.path.join(root, "out"),
                                         coalesce=4)
        dir_wall = time.perf_counter() - t0
        dir_launches = L.launch_count
        same_bytes, file_dev = 0, 0.0
        for i in range(len(clips)):
            got = os.path.join(root, "out", f"rec_{i}_restored.wav")
            want = os.path.join(root, "want.wav")
            pipe.restore_file(os.path.join(root, "in", f"rec_{i}.wav"), want)
            with open(got, "rb") as a, open(want, "rb") as b:
                same_bytes += a.read() == b.read()
            file_dev = max(file_dev, float(np.abs(
                load_audio(got, None, mono=False)[0]
                - load_audio(want, None, mono=False)[0]).max()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row = {"phase": "serve_many", "recordings": len(clips),
           "audio_s": audio_s, "shapes_ok": shapes_ok,
           "many_vs_single_max_abs": dev, "tol": MANY_TOL,
           "restore_many_wall_s": runs["restore_many"][1],
           "single_wall_s": runs["single"][1],
           "restore_many_xrt": audio_s / runs["restore_many"][1],
           "single_xrt": audio_s / runs["single"][1],
           "lstm_recurrence_launches": {
               "restore_many": runs["restore_many"][2],
               "single": runs["single"][2], "directory": dir_launches},
           "directory_files": len(written), "directory_wall_s": dir_wall,
           "directory_files_equal_bytes": same_bytes,
           "directory_vs_restore_file_max_abs": file_dev,
           "directory_tol": 1.0 / 32768}
    emit(row)
    if not (shapes_ok and dev <= MANY_TOL and len(written) == len(clips)
            and file_dev <= 1.0 / 32768 and runs["restore_many"][2] >= 1
            and dir_launches >= 1):
        raise AssertionError(f"coalesced serving failed: {row}")
    return runs["restore_many"][2], None, None


def _feed_all(restorer, blocks):
    """Feed every block, then flush: (output [B, ch, T*f], wall ms of each
    call that emitted, and of every call (ms, the window lengths it ran
    for the first time), the flush last)."""
    outs, calls = [], []
    for blk in blocks + [None]:
        had = set(restorer._shapes)
        t0 = time.perf_counter()
        out = restorer.feed(blk) if blk is not None else restorer.flush()
        calls.append(((time.perf_counter() - t0) * 1e3,
                      sorted(restorer._shapes - had)))
        outs.append(out if out.ndim == 3 else out[None])
    emitted = [c[0] for c, o in zip(calls, outs) if o.shape[-1] > 0]
    return np.concatenate(outs, axis=2), emitted, calls


def _slowest(calls):
    """The slowest call of a _feed_all run, and the calls that ran a window
    length for the first time (none after a warmup)."""
    i = max(range(len(calls)), key=lambda j: calls[j][0])
    return ({"index": i, "of": len(calls), "flush": i == len(calls) - 1,
             "ms": calls[i][0], "new_windows": calls[i][1]},
            [[j, w] for j, (_, w) in enumerate(calls) if w])


def phase_stream(torch, k1_rows):
    """16 lockstep streams of 30 s in 0.5 s blocks, f32, context 1024,
    lookahead 512: each stream against the single-shot whole-file restore
    of its recording, the batch against 16 single-stream restorers, two
    feeds against the plain recurrence, bf16 against f32."""
    from ml_audio_restoration_torch.config import PipelineConfig
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.pipeline import (
        RestorationPipeline, StreamingRestorer)

    dn, sr, st = _models(torch, torch.device("cuda"))
    rate, seconds, b = 22050, 30.0, 16
    block = int(0.5 * rate)
    streams = np.concatenate([_clip(seconds, rate, seed=300 + i)
                              for i in range(b)])
    blocks = [streams[:, o:o + block]
              for o in range(0, streams.shape[1], block)]
    s = StreamingRestorer(dn, sr, st, batch=b)
    warm = s.warmup(block)
    torch.cuda.synchronize()
    L.reset_launch_count()
    t0 = time.perf_counter()
    got, feed_ms, calls = _feed_all(s, blocks)
    wall = time.perf_counter() - t0
    launches = L.launch_count

    whole = RestorationPipeline(dn, sr, st,
                                config=PipelineConfig(whole_file=True))
    vs_whole = 0.0
    for i in range(b):
        want = whole.restore(streams[i:i + 1], rate)[0].cpu().numpy()
        vs_whole = max(vs_whole, float(np.abs(
            got[i][:, 8000:-1200] - want[:, 8000:-1200]).max()))
    vs_single = 0.0
    for i in range(b):
        one = _feed_all(StreamingRestorer(dn, sr, st),
                        [x[i] for x in blocks])[0]
        vs_single = max(vs_single, float(np.abs(got[i] - one[0]).max()))
    # two feeds through the kernel and through the plain recurrence
    k, p = (StreamingRestorer(dn, sr, st, batch=b) for _ in range(2))
    k.feed(blocks[0])
    out_k = k.feed(blocks[1])
    with L.plain_recurrence():
        p.feed(blocks[0])
        out_p = p.feed(blocks[1])
    vs_plain = float(np.abs(out_k - out_p).max())
    bf16 = StreamingRestorer(dn, sr, st, batch=b, compute_dtype="bfloat16")
    bf16.warmup(block)
    got16, feed16_ms, calls16 = _feed_all(bf16, blocks)
    slowest, new_windows = _slowest(calls)
    slowest16, new_windows16 = _slowest(calls16)
    ref_peak = float(np.abs(got).max())
    row = {"phase": "stream", "streams": b, "seconds": seconds,
           "block_s": block / rate, "context": s.context,
           "lookahead": s.lookahead, "shape": list(got.shape),
           "finite": bool(np.isfinite(got).all()), "warmup": warm,
           "feeds_emitting": len(feed_ms),
           "feed_ms_median": statistics.median(feed_ms),
           "feed_ms_max": max(feed_ms), "slowest_call": slowest,
           "new_windows_after_warmup": new_windows, "wall_s": wall,
           "stream_audio_s_per_wall_s": b * seconds / wall,
           "lstm_recurrence_launches": launches,
           "launches_per_feed": launches / len(feed_ms),
           "k1_committed_ms": k1_rows["stream_committed"]["ms"],
           "k1_lookahead_ms": k1_rows["stream_lookahead"]["ms"],
           "vs_whole_file_max_abs": vs_whole, "vs_whole_file_tol": STREAM_TOL,
           "batch_vs_single_max_abs": vs_single, "batch_tol": MANY_TOL,
           "kernel_vs_plain_max_abs": vs_plain,
           "kernel_vs_plain_tol": PIPE_TOL,
           "bf16_vs_f32_max_abs": float(np.abs(got16 - got).max()),
           "bf16_vs_f32_tol": BF16_REL * ref_peak,
           "bf16_feed_ms_median": statistics.median(feed16_ms),
           "bf16_slowest_call": slowest16,
           "bf16_new_windows_after_warmup": new_windows16}
    emit(row)
    if not (row["finite"] and got.shape == (b, 2, 2 * streams.shape[1])
            and launches == 2 * len(feed_ms) and vs_whole <= STREAM_TOL
            and vs_single <= MANY_TOL and vs_plain <= PIPE_TOL
            and not new_windows and not new_windows16
            and row["bf16_vs_f32_max_abs"] <= row["bf16_vs_f32_tol"]):
        raise AssertionError(f"streaming failed: {row}")
    return launches, vs_plain, PIPE_TOL


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import ml_audio_restoration_torch  # noqa: F401  (fail before any output)

    phase_device(torch)
    phase_build()
    rows = [phase_kernels(torch)] + phase_train_kernels(torch)
    phase_main(torch, rows[0])
    phase_grad(torch)
    phase_train_small(torch)
    launches = phase_train_full(torch)
    phase_train_convnets(torch)
    for row in rows[1:]:
        row["launches"] = launches[row["name"]]
    k1 = phase_k1_shapes(torch)
    paths = {"serve_fast": phase_serve_fast(torch, k1)}
    paths.update((f"serve_{k}", v)
                 for k, v in phase_serve_options(torch).items())
    paths.update({
        "serve_many": phase_serve_many(torch),
        "stream": phase_stream(torch, k1)})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K1's new shapes, each with the launches of the run of the path that
    # gives it (a stream feed launches one committed and one lookahead run)
    launches_of = {"serve_fast": paths["serve_fast"][0],
                   "serve_sub_f32": paths["serve_sub_0.25"][0],
                   "serve_source_rate": paths["serve_source_rate"][0],
                   "stream_committed": paths["stream"][0] // 2,
                   "stream_lookahead": paths["stream"][0] // 2}
    rows[0]["shapes"] = [
        {**{key: k1[shape][key] for key in (
            "path", "shape", "dtype", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err", "tol", "floor_ms",
            "ctas_per_sm", "waves", "regs_per_thread")},
         "launches": launches_of[shape]} for shape in k1]
    rows[0]["path_launches"] = {p: v[0] for p, v in paths.items()}
    # K1 against its plain version: at its own shapes, f32 (bar F32_TOL)
    # apart from bf16 (bar BF16_TOL), and through each path's chain
    for r in k1.values():
        key = "max_abs_err_bf16" if r["dtype"] == "bfloat16" else "max_abs_err"
        rows[0][key] = max(rows[0][key], r["max_abs_err"])
    rows[0]["path_max_abs_err"] = {p: {"max_abs_err": v[1], "tol": v[2]}
                                   for p, v in paths.items()
                                   if v[1] is not None}
    extra = ("max_abs_err_bf16", "shapes", "path_launches", "path_max_abs_err")
    emit({"kernels": [{key: row[key] for key in keys + tuple(
        k for k in extra if k in row)} for row in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
