#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - every native source of the package, one compiler per
               library, all started together: nvcc for the kernels (the
               IIR scans' csrc/iir_scan.cu among them) and the
               latency probe of ops/_latency.py, g++ for the audio codec
               (csrc/wavio.cpp + csrc/flacio.cpp);
  3. kernels - each kernel (K1 inference recurrence, K2 train forward, K3
               train backward: its walk and its dW_hh pass) against its
               plain PyTorch version on the card, with stated tolerances
               (each at every H it takes, 16, 32 and 64: one step of one
               row, an odd T with a random carry in, and gates of
               magnitude ~60 that saturate every activation; K2 and K3 also
               repeat bit for bit), then at its main-path shapes held
               against its plain version again and timed beside its bound,
               its latency floor (counted from step latencies the probe
               measures), the plain version and cuDNN's nn.LSTM (the
               dW_hh pass also alone): K2 and K3 at the f32 training shape
               (T=44,100 B=16), at the bf16 fast-train preset's
               (T=11,025 B=64, bf16 gates) and at a data-parallel rank's
               share of the global batch 16 (T=44,100 B=8);
  4. main    - the offline restore chain at full published widths with
               seeded random weights: kernel vs plain recurrence on a 4 s
               clip, card vs CPU on the same clip, a 120 s clip (64 bucketed
               chunks) with xRT, per-stage ms, K1 launch counts and the
               conv epilogue's (one a conv of each stage a program), and a
               WAV file round trip;
  5. grad    - gradients through the eval stereo forward on the card are
               non-zero and match the plain recurrence's;
  6. train   - stereo-separator training at full width: one optimizer step
               (kernel vs plain on the card, card vs CPU), 5-step loss
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
  8. train_bf16 - bf16 AMP training: config/stereo_fast_train.yaml (bf16,
               batch 64 of 0.5 s) through train_from_config over 860
               seeded stereo WAVs (12 steps + validation; K2/K3 on bf16
               gates and K1 on bf16 gates counted), 10 timed steps beside
               the same shape in f32 (audio-s/s, the step split, peak
               memory), one step kernel vs plain recurrence and card vs
               CPU, two seeded runs equal and a resumed trainer's next
               step; then the denoiser and SR over their yamls in bf16,
               one step against their f32 step (at batch 2 card vs CPU
               and bf16 vs f32 within twice the CPU's bf16-vs-f32
               distance), 10 timed steps in each dtype; one line each;
  9. train_semi - the denoiser's semi-supervised training at full width
               (config/denoiser.yaml, batch 16 of 2 s) over seeded clean
               WAVs and "real" ones degraded by the port's simulator:
               `mixed` and `adaptive` through train_from_config (the
               adaptive set's on_epoch_end firing), `mixed` with the
               contrastive term over MixedRestorationDataset(
               use_contrastive=True) in f32 and in bf16; each one step
               card vs CPU (in f32 the gradient of each loss term too; in
               bf16 within twice the CPU's bf16-vs-f32 distance), two
               seeded runs equal, 10 timed steps; no kernel runs there;
 10. train_dp - data-parallel training: the stereo net at full width as
               two processes (fresh interpreters, this file's
               --train-dp-worker mode) sharing cuda:0 through gloo,
               train_from_config over seeded stereo WAVs (global batch 16
               of 2 s, 8 a rank; 6 steps + validation; K2/K3 launches
               counted a rank), each step and each collective timed, then
               a resume of rank 0's checkpoint in a new group; the ranks'
               histories and weights equal bit for bit, rank 0 the only
               writer; one step of each rank against the one-process step
               on the concatenated batch (the stereo net's smooth terms
               in f32, the denoiser's `mixed` pairing with 6 and 3
               synthetic items in f32 and f64): loss 1e-4, gradients 1e-4
               of their largest entry, BN statistics 1e-5, parameters
               2e-3; a one-rank NCCL group's stereo step bit for bit the
               step without a group; the one-process batch-16 step timed
               beside the ranks' ("two ranks time-sharing one H100: not a
               scaling figure");
 11. files   - the files slice at full width with seeded weights, one
               line a part: the 120 s clip through the port's FLAC writer
               and the C++ and numpy decoders (bit for bit, equal to its
               16-bit WAV; host ms of each codec beside the host CPU's
               name), restore_file .flac -> .flac against .wav -> .wav on
               the card (30 s); the three models as JAX-layout .msgpack
               files restoring the 120 s clip bit for bit like their .pth
               twins (xRT, K1 launches) and feeding a StreamingRestorer;
               `export` of the .msgpack files (with and without --ema) and
               of a trainer .pth with --ema, each loading strict and equal
               to its source; the three evaluations of evaluate.py over
               eight 8 s FLACs at 44.1 kHz and two stereo ones, card vs CPU
               per file and metric within the change the chain's 1e-3
               makes in it, the stereo one also against the plain
               recurrence (K1 at T=44,100 B=8); train_from_config for two
               steps of the denoiser and the stereo separator over a FLAC
               corpus and its WAV twin (batches and losses bit for bit,
               K2/K3 counted) and the C++ batch reader's rows/s against
               the numpy route; analyze on a FLAC and the simulator on the
               card against the CPU on the same draws;
 12. k1_shapes - K1 at the serving paths' shapes (sub-chunked stereo
               T=11,024 B=640 in bf16 and f32, source-rate T=44,100 B=64,
               a streaming feed's committed T=22,048 and lookahead T=1,040
               runs at B=16 with a carry in), at the bf16 preset's
               validation (T=11,025 B=64, bf16), at evaluate's stereo
               shape (T=44,100 B=8) and at the shards of a 120 s restore
               under 2- and 3-entry meshes (T=88,200 B=32, B=22): against
               its plain version,
               timed beside its bound, its latency floor (waves x steps),
               its registers, CTAs an SM and waves, and cuDNN's nn.LSTM;
               and at the whole-file walk of sequence-parallel serving
               (T=5,292,000 B=1 f32; the plain version on the first
               22,050 steps; cuDNN in 44,100-step pieces);
 13. serve_fast - a 120 s clip through config/fast_serve.yaml (bf16, 0.25 s
               stereo windows): kernel vs plain recurrence, bf16 vs f32,
               xRT, the stage split, K1 launches, peak memory, and
               `warmup`;
 14. serve_options - the clip in f32 with 0.25 s stereo windows, mid-exact
               (the mean of L and R is the SR output) and source-rate, each
               against its plain-recurrence run, timed;
 15. serve_many - eight 10 s recordings and one of 150 s: restore_many vs
               single restores, then restore_directory (coalesce 4) vs
               restore_file over WAVs in profiles/;
 16. stream  - 16 lockstep streams of 30 s in 0.5 s blocks: each against
               the single-shot whole_file restore, the batch against 16
               single streams, one feed against the plain recurrence, bf16
               against f32; per-feed ms, the slowest call (a feed or the
               flush) with any window length warmup did not run (none
               may), and K1 launches a feed;
 17. int8    - int8 serving (csrc/int8_conv.cu): the kernel against its
               plain version bit for bit on 2 chunk rows of every distinct
               int8 layer of the default program, the full-scope program
               and config/fast_serve_int8.yaml's; each default layer timed
               at the full batch (64 x 2 s) with its path (wgmma, stem or
               generic, ops/int8_conv.py::plan) beside its bound, the
               plain version, torch._int_mm over an im2col plus the
               epilogue (where its shape rules allow) and cuDNN's f32 and
               bf16 conv of the same packed layer; the full-scope and
               preset programs' layers timed too (program_kernel_ms_full,
               program_kernel_ms_fast_serve_int8); the 120 s clip through
               restore with quantize_int8 (calibration s, xRT and stage
               split beside the f32 default's and fast_serve's, K1 once,
               35 int8-conv launches, vs f32, the same restore through the
               plain int8 conv bit for bit), card vs CPU on 4 s with the
               same scales, a scales file saved and reloaded (bit for bit,
               no recalibration), the preset (K1 once at T=11,024 B=640
               bf16, no int8 launch in its stereo stage), one full-scope
               restore, and 16 lockstep int8 streams on one preloaded
               scales dict against float streams and single int8 streams.
               The launches by path are asserted: every layer with
               Cin % 16 == 0 on wgmma, the three Cin-1 stems on stem, none
               generic (35 / 49 / 23 launches: 32 + 3, 46 + 3, 21 + 2);
 18. serve   - the serving daemon (pipeline/server.py) over loopback: one
               30 s request through RestorationServer equal bit for bit to
               restore + normalize_audio with one K1 launch, its round trip
               beside the in-process restore; 8 clients sending 24 requests
               of 5-60 s (coalesced, each within MANY_TOL of its solo
               restore; latency, xRT through the daemon, busy seconds, K1
               launches); a hot reload of seeded .pth files in f32 and in
               bf16, equal to a fresh pipeline on them; 16 TCP streams of
               30 s through StreamServer against a direct restorer (feed ms
               and stream-s/s beside it) and a WebSocket stream equal to its
               TCP twin; an int8 daemon writing its scales file and a
               second one serving from it bit for bit (its 10 s request's
               round trip and launches by path); `serve --warmup` as a
               subprocess (healthz, a restore, a stream, SIGTERM -> 0);
 19. serve_mesh - multi-device serving on meshes that repeat cuda:0 (the
               host has one card: the shards time-share it, so this checks
               the split, the gather and the numbers, not scaling): the
               120 s clip through 1-, 2- and 3-entry meshes against the
               unsharded restore (1 entry bit for bit, 2 and 3 within atol
               2e-5 rtol 1e-4), xRT of each, K1's launches and [T, B] a
               shard (32/32, 22/21/21); restore_many over 2 entries vs
               single restores; int8 over 2 entries on the unsharded
               run's scales file (1/4 of the int8-vs-f32 RMS, the int8
               conv bit for bit its plain version, 70 launches); 16
               streams of 10 s over 2 entries within 1e-6 of unsharded
               ones; StagedRestorationPipeline over [cuda:0] * 3 on the
               120 s and a 4 s clip bit for bit against restore; a reload
               on a 2-entry mesh (f32, bf16: every device's models hold
               the new weights); the CLI: `restore --data-parallel 1`
               byte for byte, `--data-parallel <cards + 1>` exits
               non-zero naming the count, `serve --data-parallel 1`;
 20. serve_seq - sequence-parallel serving (the mesh's 'model' axis) on
               meshes that repeat cuda:0 (not a scaling figure): a 120 s
               whole-file restore unsharded and through 1x1 (bit for bit),
               1x2 and 1x4 (atol 2e-5 rtol 1e-4), the same in bf16
               (BF16_CHAIN_TOL), int8 over 1x2 on the unsharded run's
               scales file (1/4 of the int8-vs-f32 RMS, 64 wgmma + 6 stem
               launches), a chunked 120 s restore on 2x2 (K1 at B=32 once
               a row) and 16 streams over 1x2; each with its xRT, the
               device ms of each stage piece and of the gathers, the peak
               memory, and K1's [T, B]: one walk of T=5,292,000 at B=1 a
               whole-file restore (timed in k1_shapes, held against the
               plain version on its first 22,050 steps);
 21. iir     - the simulator's IIR path (csrc/iir_scan.cu behind
               ops/iir.py) at the denoiser's training shape (B=16, C=1,
               T=44,100 at 22.05 kHz; each walk sees 44,130 samples): the
               crackle, rumble and per-item roll-off walks and a direct
               form II walk of order 4, forward and adjoint, bit for bit
               their plain versions on the same inputs (one walk's plain
               version on the card too) and within 1e-6 of the peak of
               scipy's float64 filter, each timed beside its bytes bound
               and the blocked design's floors (its latency chain and its
               double operations over the FP64 lanes of one SM a row);
               the same checks at the partition's edges (40, 65 and
               100,000 steps); filtfilt / lfilter at order 4 and its
               gradient card vs CPU; simulate_batch(filter_mode="iir") on
               the card against the CPU on the same draws (1e-5) in six
               launches; the IIR degradation timed beside the FIR path's
               on the same draws and traced (its top device ops and the
               host's gaps), and scipy's sosfiltfilt on the host CPU;
 22. epilogue - the eval convolutions' epilogue (csrc/conv_epilogue.cu
               behind ops/conv.py) at the stereo model's layer shapes of a
               44-row slab, [44, C, 88,200] for C = 32, 64, 128 and 1, f32
               and bf16: bit for bit ATen's bias add + LeakyReLU, timed
               beside its bytes bound, its plain version and ATen's ops;
               the launches of one eval forward of each model against
               models.epilogue_convs (17 for the stereo model);
 23. resume_jax - resuming a JAX training run at full width: the stereo
               separator (Adam without clipping, 7 + 2N optimizer leaves)
               and the denoiser (max_grad_norm 1, EMA 0.995; 3 + 2N): a
               trainer's 3 steps written as checkpoint_epoch_1.msgpack in
               the JAX layout (jax_checkpoint_payload, test tooling), then
               train_from_config in a fresh directory resumes it and runs
               the next 2 steps (K2/K3 counted), bit for bit the
               uninterrupted trainer's;
 24. library - istft(stft(x)) of the 120 s clip (n_fft 2048, hop 512) and
               transient_spectral_loss with its gradient on 16 x 2 s at
               44.1 kHz, card against CPU;
 25. profile - utils.profiling.trace around a warm default 120 s restore
               and around one stereo train step at full width, each read
               with trace_device_times and trace_top_ops: the kernels'
               total within the wall time, K1 on top of the restore's
               recurrence bucket, and the bucket within 5% of K1's time
               from phase kernels; the restore's elementwise kernels listed.
Each phase's wall seconds follow it on a line {"phase_wall_s": ...}.
Then one line {"kernels": [...]} (K1, K2, K3, the int8 conv, the IIR
scan, whose numbers are one crackle walk's with every walk in `shapes`,
and `floor_ms` its latency floor, and the conv epilogue, whose numbers
sum one f32 stereo forward's convs at a 44-row slab, its `launches` the
120 s restore program's and its `path_launches` each path's run; the int8
conv's numbers sum its layers
over one 64-chunk program, each layer with its path
in `shapes`, and whose `launches_by_path` splits its launches on the main
path among wgmma, stem and generic; K1's `path_launches` include the
serve_mesh and serve_seq paths), a line {"phase": "epilogue_paths"}
before it (each path's epilogue launches, the eval convs it routed to the
kernel and to ATen's ops, and K1's walks: every routed conv takes the
kernel, once, and where a program runs each stage once a walk the
launches are the walks times the stages' convs; a path that misses fails
the run after the kernels line) and, last, the device line
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


def _nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        "nvidia-smi unavailable")


def phase_device(torch):
    line = _nvidia_smi()
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return line


def phase_build():
    """Builds every native source of the package in parallel, one compiler
    each: the CUDA kernels and the latency probe with nvcc, the audio codec
    with g++."""
    from concurrent.futures import ThreadPoolExecutor

    from ml_audio_restoration_torch.audio import native
    from ml_audio_restoration_torch.ops import _build, _latency

    sources = ("lstm_recurrence", "lstm_train", "int8_conv", "iir_scan",
               "conv_epilogue", _latency.PROBE, native.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    for name in sources:
        _build.load(name)
    native.load_library()
    emit({"phase": "build", "sources": list(sources),
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {k: _build.build_seconds.get(k) for k in sources
                           if k not in _build.HOST_LIBRARIES},
          "gxx_seconds": {k: _build.build_seconds.get(k) for k in sources
                          if k in _build.HOST_LIBRARIES}})


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


def _lstm_segments(torch, ref, gates, seg: int, state=None):
    """cuDNN's nn.LSTM over `gates` in time segments of `seg` steps, the
    state (`state` first) threaded from one segment to the next ->
    [T, B, H]."""
    outs = []
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
    """K2 and K3 against their plain versions, then at the three training
    shapes (the f32 step's 2 s chunks at 22.05 kHz, batch 16; the bf16
    fast-train preset's 0.5 s chunks, batch 64, bf16 gates; a data-parallel
    rank's 8 of the global 16) held against them again and timed beside their latency floors, counted from the
    step latencies the probe of ops/_latency.py measures."""
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

    main = _train_kernels_at(torch, L, randn, "train_full", 44100, 16,
                             torch.float32)
    fast = _train_kernels_at(torch, L, randn, "train_bf16", 11025, 64,
                             torch.bfloat16)
    # a rank's share of the data-parallel run's global batch 16
    dp = _train_kernels_at(torch, L, randn, "train_dp", 44100, 8,
                           torch.float32)
    src = "ml_audio_restoration_torch/csrc/lstm_train.cu"
    rows = []
    for name, line, err, replaces in (
            ("lstm_train_fwd", "fwd", max(f32_err, bf16_err, halves_err,
                                          cases["f32"], cases["saturated"]),
             ":223"),
            ("lstm_train_bwd", "bwd", bwd_err, ":260")):
        # the f32 training shape first; the shapes list holds all three
        shapes = [dict(r[line]) for r in (main, fast, dp)]
        first = shapes[0]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "ml_audio_restoration_tpu/ops/pallas/lstm.py"
                        + replaces,
            "max_abs_err": max([err] + [x["max_abs_err"] for x in shapes]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "shapes": shapes})
    return rows


def _train_kernels_at(torch, L, randn, path, t, b, dtype):
    """K2 (gates in `dtype`) and K3 at one training shape (H=64): held
    against their plain versions on the same inputs, timed (median of 5
    calls) beside their bounds, latency floors, the plain versions and
    cuDNN's nn.LSTM in the gates' dtype (train-mode forward for K2, forward
    + backward minus forward for K3). Returns {"fwd": row, "bwd": row}."""
    from ml_audio_restoration_torch.ops import _latency

    dev = torch.device("cuda")
    h = 64
    gates = randn(t, b, 4 * h, scale=0.5).to(dtype)
    w_hh = randn(h, 4 * h, scale=0.15)
    h0, c0 = randn(b, h, scale=0.3), randn(b, h, scale=0.3)
    dout, dhf, dcf = (randn(t, b, h, scale=0.1), randn(b, h, scale=0.1),
                      randn(b, h, scale=0.1))
    fwd = lambda: L._lstm_train_fwd_cuda(gates, w_hh, h0, c0)  # noqa: E731
    res = fwd()
    fwd_ms = _cuda_ms(torch, fwd, 5)
    # the latency floors: each kernel's counted step chain at the step
    # latencies the probe measures now, at the SM clock nvidia-smi reads
    # right after (K1's at the restore's T)
    floor = _latency.step_floor(h, {"k1": 88200, "k2": t, "k3": t}, dev)
    emit({"phase": "latency_probe", "for": path, **floor})
    fwd_plain_ms, res_p = _timed_once(
        torch, lambda: L.lstm_recurrence_train_plain(gates, w_hh, h0, c0))
    fwd_err = max(_max_dev(x, y) for x, y in zip(res, res_p))
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
          "path": path, "shape": [t, b, h], "ms": dw_ms,
          "splits": L._dw_splits(t * b), "bytes": dw_bytes,
          "flops": dw_flops, "bound_ms": dw_bound, "bound_by": dw_by,
          "walk_ms": bwd_ms - dw_ms})
    bwd_plain_ms, grads_p = _timed_once(
        torch, lambda: L.lstm_recurrence_bwd_plain(
            acts, cseq, out, h0, c0, w_hh, dout, dhf, dcf))
    bwd_err = max(_max_dev(grads[i], grads_p[i]) for i in (0, 2, 3))
    dw_rel = (_max_dev(grads[1], grads_p[1])
              / float(grads_p[1].abs().max()))
    del grads_p
    check = {"phase": "kernel_check", "kernel": "lstm_train_fwd+bwd",
             "path": path, "shape": [t, b, h], "gates": str(dtype)[6:],
             "fwd_max_abs_err": fwd_err, "fwd_tol": K2_TOL,
             "fwd_out_dtypes": sorted({str(x.dtype)[6:] for x in res}),
             "bwd_max_abs_err": bwd_err, "bwd_tol": K3_TOL,
             "dw_rel_err": dw_rel, "dw_tol": DW_TOL}
    emit(check)
    if not (fwd_err <= K2_TOL and bwd_err <= K3_TOL and dw_rel <= DW_TOL
            and check["fwd_out_dtypes"] == ["float32"]):
        raise AssertionError(f"lstm_train disagrees with plain at "
                             f"{path}'s shape: {check}")

    # yardstick only, never called by the port: cuDNN's LSTM in train mode
    # in the gates' dtype with an identity input projection, forward for
    # K2 and forward + backward minus forward for K3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.nn.LSTM(4 * h, h).to(device=dev, dtype=dtype).train()
    with torch.no_grad():
        ref.weight_ih_l0.copy_(torch.eye(4 * h, device=dev))
        ref.weight_hh_l0.copy_(w_hh.T)
        ref.bias_ih_l0.zero_()
        ref.bias_hh_l0.zero_()
    x = gates.clone().requires_grad_()
    hc = (h0[None].to(dtype).clone().requires_grad_(),
          c0[None].to(dtype).clone().requires_grad_())
    cot = (dout.to(dtype), dhf[None].to(dtype), dcf[None].to(dtype))

    def lib_fwd():
        return ref(x, hc)

    def lib_fwd_bwd():
        y, (hn, cn) = ref(x, hc)
        return torch.autograd.grad(
            (y, hn, cn), (x, ref.weight_hh_l0, hc[0], hc[1]), cot)

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

    g4, item = 4 * h, gates.element_size()
    fwd_bytes = (item * t * b * g4                         # gates
                 + 4 * (h * g4 + 2 * b * h                 # W, h0/c0
                        + t * b * (h + g4 + h) + 2 * b * h))  # outputs
    fwd_flops = 2.0 * t * b * h * g4                       # h @ W_hh, f32
    bwd_bytes = 4 * (t * b * (g4 + 3 * h) + h * g4 + 4 * b * h  # residuals
                     + t * b * g4 + h * g4 + 2 * b * h)    # dgx, dW, dh0/dc0
    bwd_flops = 4.0 * t * b * h * g4   # d_lin @ W_hh^T and the dW products
    fwd_bound, fwd_by = _bound(fwd_bytes, fwd_flops)
    bwd_bound, bwd_by = _bound(bwd_bytes, bwd_flops)
    timing = {"phase": "kernel_time", "kernel": "lstm_train_fwd+bwd",
              "path": path, "shape": [t, b, h], "dtype": str(dtype)[6:],
              "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
              "fwd_library_ms": lib_fwd_ms, "fwd_bytes": fwd_bytes,
              "fwd_flops": fwd_flops, "fwd_bound_ms": fwd_bound,
              "bwd_ms": bwd_ms, "bwd_dw_pass_ms": dw_ms,
              "bwd_plain_ms": bwd_plain_ms,
              "bwd_library_ms": lib_bwd_ms, "bwd_bytes": bwd_bytes,
              "bwd_flops": bwd_flops, "bwd_bound_ms": bwd_bound,
              "library_vs_kernel_max_abs": lib_dev,
              "fwd_ns_per_step": fwd_ms * 1e6 / t,
              "fwd_floor_ms": floor["floor"]["k2"]["ms"],
              "fwd_floor_ns_per_step": floor["floor"]["k2"]["ns_per_step"],
              "bwd_walk_floor_ms": floor["floor"]["k3"]["ms"],
              "bwd_ns_per_step": bwd_ms * 1e6 / t}
    emit(timing)
    del gates, res, out, acts, cseq, grads, dout
    torch.cuda.empty_cache()
    common = {"path": path, "shape": [t, b, h]}
    return {
        "fwd": {**common, "gates": str(dtype)[6:], "ms": fwd_ms,
                "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound,
                "bound_by": fwd_by, "library_ms": lib_fwd_ms,
                "floor_ms": floor["floor"]["k2"]["ms"],
                "max_abs_err": fwd_err, "tol": K2_TOL},
        "bwd": {**common, "ms": bwd_ms, "dw_pass_ms": dw_ms,
                "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound,
                "bound_by": bwd_by, "library_ms": lib_bwd_ms,
                "floor_ms": floor["floor"]["k3"]["ms"],
                "max_abs_err": bwd_err, "tol": K3_TOL, "dw_rel_err": dw_rel,
                "dw_tol": DW_TOL}}


def _models(torch, dev, seed: int = 0):
    from ml_audio_restoration_torch.models import (
        AudioDenoiser, AudioSuperResolution, StereoSeparator, init_params)

    gen = torch.Generator(device=dev).manual_seed(seed)
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
    """4 s and 120 s restores on the card (against the plain recurrence
    and the CPU; launches, stage ms) and a WAV round trip. Returns the
    conv epilogue's launches in the 120 s restore's one program."""
    from ml_audio_restoration_torch.models import epilogue_convs
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
    _reset_epilogue()
    t0 = time.perf_counter()
    y, _ = pipe.restore(clip, rate)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = L.launch_count
    epilogues = _note_epilogue("main_120s")["launches"]
    peak = torch.cuda.max_memory_allocated()
    # one epilogue launch a conv of each stage a program, one K1 walk a
    # program
    ok = (tuple(y.shape) == (2, clip.shape[1] * 2)
          and bool(torch.isfinite(y).all())
          and epilogues == launches * sum(
              len(epilogue_convs(m)) for m in (dn, sr, st)))

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
           "lstm_recurrence_launches": launches,
           "conv_epilogue_launches": epilogues, "ok": ok}
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
    return epilogues


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
TRAJ_UPDATE_L2 = 1e-2  # smooth terms at lr 1e-3, kernel vs plain (set
#                     from 10-step readings; shorter runs drift less)
TRAJ_STEPS = 5      # the trajectories' length (10 before the files phase
#                     was added; the plain runs take most of the time)


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
    its smooth terms); then TRAJ_STEPS steps at lr 1e-3 on one fixed
    batch, kernel vs plain and kernel vs kernel, the latter also with
    cuDNN's nondeterministic algorithms (the trainer turns them off) and
    with every op's deterministic one."""
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

    # TRAJ_STEPS steps at lr 1e-3 on the fixed batch: kernel vs plain held
    # on the smooth terms (loss and the whole update), reported on the
    # reference loss; kernel vs kernel on the reference loss held equal, and read
    # with cuDNN's nondeterministic algorithms and with every op's
    # deterministic one
    runs = {}
    for name, kw in (("smooth", SMOOTH_TERMS), ("reference", {})):
        for label, plain in (("kernel", False), ("plain", True)):
            runs[f"{name}_{label}"] = run("cuda", plain, TRAJ_STEPS,
                                          learning_rate=1e-3, **kw)
    runs["reference_kernel_again"] = run("cuda", False, TRAJ_STEPS,
                                         learning_rate=1e-3)
    for label in ("", "_again"):
        runs[f"reference_kernel_cudnn_nondeterministic{label}"] = run(
            "cuda", False, TRAJ_STEPS, cudnn_deterministic=False,
            learning_rate=1e-3)
    with _all_deterministic(torch) as ops:
        runs["reference_kernel_all_deterministic"] = run(
            "cuda", False, TRAJ_STEPS, learning_rate=1e-3)
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
    # the adaptive overrides at their 50/s bound: 316 pop rows an item
    adaptive = {k: torch.full((x.shape[0],), v, device="cuda")
                for k, v in (("impulse_rate", 50.0),
                             ("impulse_amplitude_max", 1.0),
                             ("noise_level", 0.05))}
    adaptive_draws = A.draw_artifacts(gen.manual_seed(2), x.shape, rate,
                                      overrides=adaptive)
    pieces = {
        "draws": lambda: A.draw_artifacts(gen.manual_seed(1), x.shape, rate),
        "pops": lambda: A._make_pops(cuda_draws, x.shape[-1], rate, cfg),
        "pops_adaptive_50_per_s": lambda: A._make_pops(
            adaptive_draws, x.shape[-1], rate, cfg),
        "crackle_fft_257": lambda: A._fir_same(x, fir[257]),
        "rumble_fft_2049": lambda: A._fir_same(x, fir[2049]),
        "rolloff_conv_129": lambda: A._fir_same(x, per_item),
        "apply_artifacts": lambda: A.apply_artifacts(x, cuda_draws, rate),
        "simulate_batch": lambda: A.simulate_batch(gen.manual_seed(1), x,
                                                   rate),
        "simulate_batch_adaptive": lambda: A.simulate_batch(
            gen.manual_seed(1), x, rate, overrides=adaptive)}
    split = {k: _cuda_ms(torch, fn, 5) for k, fn in pieces.items()}
    return {"shape": list(clean.shape), "max_abs": _max_dev(got.cpu(), want),
            "tol": DEGRADE_TOL, "repeats_exactly": bool(torch.equal(got,
                                                                     again)),
            "pops": int(draws["pop_count"].sum()),
            "pop_rows": {"default": list(cuda_draws["pop_amps"].shape),
                         "adaptive_50_per_s":
                         list(adaptive_draws["pop_amps"].shape)},
            "pops_adaptive": int(adaptive_draws["pop_count"].sum()),
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


# bf16 training: the stereo fast-train preset (config/stereo_fast_train.yaml)
FAST_BATCH, FAST_SECONDS, FAST_STEPS = 64, 0.5, 12
FAST_FILES = 860   # 774 train (12 steps of 64) + 86 validation at 0.1
BF16_LOSS_REL = 1e-2  # one bf16 step against another route's, loss


def _timed_steps(torch, tr, batches, seeds, params_of=None):
    """10 timed train steps (after 2 warm-up ones) on `batches` with the
    step's draws from `seeds` (None: the trainer's generator where it
    stands), then the step split by CUDA events over 3 more steps: derive,
    forward, loss, backward, optimizer. Returns the timing dict."""
    for b, sd in zip(batches[:2], seeds[:2]):
        tr._train_step(b, sd() if sd else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b, sd in zip(batches[2:12], seeds[2:12]):
        tr._train_step(b, sd() if sd else None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    split = {"derive": 0.0, "forward": 0.0, "loss": 0.0, "backward": 0.0,
             "optimizer": 0.0}
    reps = 3
    for r in range(reps):
        b = batches[r]
        gen = seeds[r]() if seeds[r] else None
        ev[0].record()
        inputs, targets = tr._derive(b, gen)
        ev[1].record()
        tr.model.train()
        tr.optimizer.zero_grad(set_to_none=True)
        params = tr._cast()
        pre = ({n: x.clone() for n, x in tr.model.named_buffers()}
               if tr.pairing == "mixed" else None)
        out = tr._forward(inputs, params)
        ev[2].record()
        if tr.pairing == "mixed":  # the re-inference and encoders: "loss"
            loss, _ = tr._semi_supervised(out, inputs, targets, b, params,
                                          pre, gen or tr._gen)
        else:
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
    n = len(batches[2:12])
    size = batches[0][next(iter(batches[0]))].shape
    audio_s = size[0] * size[-1] / tr.sample_rate
    return {"timed_steps": n, "timed_wall_s": wall,
            "step_ms": wall * 1e3 / n, "audio_s_per_s": n * audio_s / wall,
            "split_ms": split, "split_sum_ms": sum(split.values()),
            "peak_mem_bytes": peak}


def _step_grads(torch, tr, batch, gen=None, terms=()):
    """(loss, train-forward output, gradients) of one step's loss and
    backward, without the update; with `terms`, a fourth item: {term:
    gradients} of each of those loss parts, one backward pass a term."""
    inputs, targets = tr._derive(batch, gen)
    tr.model.train()
    tr.optimizer.zero_grad(set_to_none=True)
    loss, (parts, out) = tr._loss(inputs, targets, None, batch, gen)
    params = list(tr.model.parameters())
    per_term = {}
    for k in terms:
        gs = torch.autograd.grad(parts[k], params, retain_graph=True,
                                 allow_unused=True)
        per_term[k] = [(torch.zeros_like(p) if g is None else g)
                       .detach().float().cpu() for p, g in zip(params, gs)]
    loss.backward()
    got = (loss.item(), out.detach().float().cpu(),
           [p.grad.detach().float().cpu() for p in params])
    return got + (per_term,) if terms else got


def _fast_config(root, ckpt_dir, dtype="bfloat16"):
    """config/stereo_fast_train.yaml over the WAVs in <root>/wavs: one
    epoch, a checkpoint each epoch under <root>/<ckpt_dir>."""
    from ml_audio_restoration_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "config", "stereo_fast_train.yaml"))
    cfg.train.compute_dtype = dtype
    cfg.train.num_epochs = 1
    cfg.train.save_every = 1
    cfg.train.checkpoint_dir = os.path.join(root, ckpt_dir)
    cfg.train.log_dir = os.path.join(root, "runs")
    cfg.data.data_dir = os.path.join(root, "wavs")
    return cfg


def _loader_batches(tr, n):
    it = iter(tr.train_loader)
    return [next(it) for _ in range(n)]


def _fast_steps_compared(torch, root):
    """One step of the fast-train preset on the smooth terms: at full
    width kernel vs plain recurrence (bf16) beside the f32 step, and at
    batch 2 card vs CPU (bf16, beside the CPU's f32 step). A bf16 step's
    output and gradients are held within twice the CPU's own bf16-vs-f32
    deviation (two bf16 roundings of one f32 function), the kernel-vs-plain
    deviation within the bf16-vs-f32 one of the card."""
    from ml_audio_restoration_torch.models import StereoSeparator, init_params
    from ml_audio_restoration_torch.config import TrainConfig
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.train.trainer import (
        Trainer, build_trainer)

    cfg = _fast_config(root, "ck_cmp")
    batch = _loader_batches(build_trainer(cfg, steps_per_epoch=2), 1)[0]
    base = init_params(StereoSeparator(), torch.Generator().manual_seed(31))

    def step(device, dtype, b, plain=False):
        tr = Trainer("stereo_separator", StereoSeparator(), [],
                     config=TrainConfig(model="stereo_separator",
                                        compute_dtype=dtype, **SMOOTH_TERMS),
                     pairing="mono_target_stereo", device=device)
        tr.model.load_state_dict(base.state_dict())
        L.reset_launch_count()
        with L.plain_recurrence() if plain else contextlib.nullcontext():
            got = _step_grads(torch, tr, b)
        return got, (L.train_fwd_launch_count, L.train_bwd_launch_count)

    (k16, launched), (p16, plain_launched) = (
        step("cuda", "bfloat16", batch), step("cuda", "bfloat16", batch,
                                              plain=True))
    k32, _ = step("cuda", "float32", batch)
    small = {k: v[:2] for k, v in batch.items()}
    (c16, _), (h16, _), (h32, _) = (step("cuda", "bfloat16", small),
                                    step("cpu", "bfloat16", small),
                                    step("cpu", "float32", small))
    out = {"kernel_vs_plain": _bf16_devs(k16, p16),
           "bf16_vs_f32_card": _bf16_devs(k16, k32),
           "launches_kernel": launched, "launches_plain": plain_launched,
           "card_vs_cpu_batch2": _bf16_devs(c16, h16),
           "bf16_vs_f32_cpu_batch2": _bf16_devs(h16, h32)}
    kp, bf = out["kernel_vs_plain"], out["bf16_vs_f32_card"]
    cc, bc = out["card_vs_cpu_batch2"], out["bf16_vs_f32_cpu_batch2"]
    out["ok"] = bool(
        launched == (1, 1) and plain_launched == (0, 0)
        and kp["out_rel_l2"] <= bf["out_rel_l2"]
        and kp["grad_rel_l2"] <= bf["grad_rel_l2"]
        and kp["loss_rel"] <= BF16_LOSS_REL
        and cc["out_rel_l2"] <= 2 * bc["out_rel_l2"]
        and cc["grad_rel_l2"] <= 2 * bc["grad_rel_l2"]
        and cc["loss_rel"] <= BF16_LOSS_REL)
    return out


def _runs_equal(torch, make, batches, seeds):
    """Two trainers from `make()` over the same batches and draws: equal
    losses, weights, BN statistics and EMA, bit for bit."""
    runs = []
    for _ in range(2):
        tr = make()
        losses = [float(tr._train_step(b, sd() if sd else None)["loss"])
                  for b, sd in zip(batches, seeds)]
        state = dict(tr.model.state_dict())
        if tr.ema_params is not None:
            state.update({f"ema.{k}": v for k, v in tr.ema_params.items()})
        runs.append((losses, state))
    (la, sa), (lb, sb) = runs
    return {"losses": la, "equal": la == lb and all(
        torch.equal(v, sb[k]) for k, v in sa.items())}


def _fast_train(torch, root):
    """The preset through train_from_config (K2/K3/K1 counted), then 10
    timed steps of its trainer, the same in f32, two seeded runs and a
    resumed trainer's next step."""
    from ml_audio_restoration_torch.models import count_params
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.train.trainer import (
        build_trainer, train_from_config)

    t0 = time.perf_counter()
    _write_corpus(os.path.join(root, "wavs"), files=FAST_FILES,
                  seconds=FAST_SECONDS + 0.1)
    corpus_s = time.perf_counter() - t0

    # the main path: one epoch of 12 steps plus validation, counted
    torch.cuda.synchronize()
    L.reset_launch_count()
    t0 = time.perf_counter()
    history = train_from_config(_fast_config(root, "ck"),
                                steps_per_epoch=FAST_STEPS)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = {"lstm_train_fwd": L.train_fwd_launch_count,
              "lstm_train_bwd": L.train_bwd_launch_count,
              "lstm_recurrence_validation": L.launch_count}
    written = sorted(os.listdir(os.path.join(root, "ck",
                                             "stereo_separator")))

    timing = {}
    for dtype in ("bfloat16", "float32"):
        tr = build_trainer(_fast_config(root, f"ck_{dtype}", dtype),
                           steps_per_epoch=FAST_STEPS)
        batches = _loader_batches(tr, FAST_STEPS)
        L.reset_launch_count()
        timing[dtype] = _timed_steps(torch, tr, batches, [None] * 12)
        timing[dtype]["launches_per_step"] = {
            "lstm_train_fwd": L.train_fwd_launch_count / 15,
            "lstm_train_bwd": L.train_bwd_launch_count / 15}
    params = count_params(tr.model)

    cfg = _fast_config(root, "ck_runs")
    batches = batches[:3]
    runs = _runs_equal(
        torch, lambda: build_trainer(_fast_config(root, "ck_none"),
                                     steps_per_epoch=1), batches, [None] * 3)
    tr = build_trainer(cfg, steps_per_epoch=FAST_STEPS)
    tr.epoch = 1
    for b in batches:
        tr._train_step(b)
    tr.save_checkpoint("checkpoint_epoch_1.pth")
    fresh = build_trainer(cfg, steps_per_epoch=FAST_STEPS)
    losses = [float(t._train_step(batches[0])["loss"]) for t in (tr, fresh)]
    resumed = losses[0] == losses[1] and all(
        torch.equal(x, y) for x, y in zip(tr.model.state_dict().values(),
                                          fresh.model.state_dict().values()))
    return {"params": params, "corpus_files": FAST_FILES,
            "corpus_write_s": corpus_s, "epoch_s": epoch_s,
            "history": history, "checkpoints": written,
            "main_path_launches": counts, "timed": timing,
            "repeat_3_steps": runs, "resumed_next_step_equal": resumed}


def _bf16_devs(a, b):
    """Deviations of one step (loss, output, gradients) from another's."""
    return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
            "out_rel_l2": _rel_l2([a[1]], [b[1]]),
            "grad_rel_l2": _rel_l2(a[2], b[2])}


def _bf16_held(steps):
    """A bf16 step on the card held as `_fast_steps_compared` holds the
    preset's: `steps` maps (device, dtype) to one batch-2 step on the
    same weights, batch and draws. The card's bf16 step against the CPU's,
    and against the card's f32 step, each within twice the CPU's own
    bf16-vs-f32 deviation in output and gradients (two bf16 roundings of
    one f32 function, each within D of it, lie within 2D of each other).
    Returns (deviations, ok)."""
    d = {"card_vs_cpu_bf16": _bf16_devs(steps["cuda", "bfloat16"],
                                        steps["cpu", "bfloat16"]),
         "bf16_vs_f32_card": _bf16_devs(steps["cuda", "bfloat16"],
                                        steps["cuda", "float32"]),
         "bf16_vs_f32_cpu": _bf16_devs(steps["cpu", "bfloat16"],
                                       steps["cpu", "float32"])}
    ref = d["bf16_vs_f32_cpu"]
    ok = all(d[k][m] <= 2 * ref[m]
             for k in ("card_vs_cpu_bf16", "bf16_vs_f32_card")
             for m in ("out_rel_l2", "grad_rel_l2"))
    return d, bool(ok)


def _convnet_bf16(torch, name):
    """The denoiser or SR over its own yaml with compute_dtype bfloat16
    (batch 16 of 2 s): one step against the same step in f32 (same
    weights, batch and draws); at batch 2 the card's bf16 step against the
    CPU's and against its f32 step (`_bf16_held`); then 10 timed steps in
    each dtype on the same in-memory batches."""
    import copy
    import dataclasses

    from ml_audio_restoration_torch.config import load_config
    from ml_audio_restoration_torch.models import init_params
    from ml_audio_restoration_torch.train.trainer import MODELS, Trainer

    spec = CONVNETS[name]
    cfg = load_config(os.path.join(ROOT, "config", f"{name}.yaml"))
    kw = dataclasses.asdict(getattr(cfg, name))
    if name == "denoiser":
        kw["features"] = tuple(kw["features"])
    base = init_params(MODELS[name](**kw), torch.Generator().manual_seed(32))
    frames = int(cfg.data.chunk_duration * spec["rate"])
    batches = [{spec["key"]: _mono_batch(16, frames, spec["rate"],
                                         seed=40 + i)} for i in range(12)]

    def trainer(dtype, device="cuda", **extra):
        c = copy.deepcopy(cfg.train)
        c.compute_dtype = dtype
        for k, v in extra.items():
            setattr(c, k, v)
        return Trainer(name, copy.deepcopy(base), [], config=c,
                       pairing=spec["pairing"], device=device,
                       sample_rate=spec["rate"])

    steps = {dtype: _step_grads(torch, trainer(dtype, spectral_weight=0.0),
                                batches[0], torch.Generator().manual_seed(9))
             for dtype in ("bfloat16", "float32")}
    a, b = steps["bfloat16"], steps["float32"]
    one = {"smooth_loss_rel": abs(a[0] - b[0]) / abs(b[0]),
           "out_rel_l2": _rel_l2([a[1]], [b[1]]),
           "grad_rel_l2": _rel_l2(a[2], b[2])}
    small = {k: v[:2] for k, v in batches[0].items()}
    held, held_ok = _bf16_held({
        (device, dtype): _step_grads(
            torch, trainer(dtype, device, spectral_weight=0.0), small,
            torch.Generator().manual_seed(9))
        for device in ("cuda", "cpu") for dtype in ("bfloat16", "float32")})
    timing = {}
    for dtype in ("bfloat16", "float32"):
        tr = trainer(dtype)
        seeds = [(lambda i=i, t=tr: t._seeded(2, i)) for i in range(12)]
        timing[dtype] = _timed_steps(torch, tr, batches, seeds)
    runs = _runs_equal(torch, lambda: trainer("bfloat16"), batches[:3],
                       [(lambda i=i: torch.Generator("cuda").manual_seed(i))
                        for i in range(3)])
    return {"family": name, "batch": batches[0][spec["key"]].shape[0],
            "frames": batches[0][spec["key"]].shape[-1],
            "bf16_vs_f32_one_step": one, "batch2_step": held,
            "timed": timing, "repeat_3_steps_bf16": runs,
            "ok": bool(one["smooth_loss_rel"] <= BF16_LOSS_REL and held_ok
                       and held["card_vs_cpu_bf16"]["loss_rel"]
                       <= BF16_LOSS_REL
                       and runs["equal"] and np.isfinite(a[0]))}


def phase_train_bf16(torch):
    """bf16 AMP training: config/stereo_fast_train.yaml (bf16, batch 64 of
    0.5 s, 494,786 parameters) through train_from_config over seeded
    stereo WAVs under profiles/ (removed after), K2/K3 on bf16 gates in the
    step and K1 on bf16 gates in validation, counted; 10 timed steps beside
    the same shape in f32; one step kernel vs plain and card vs CPU; two
    seeded runs and a resumed trainer's next step; then the denoiser and SR
    in bf16 against their f32 step, timed. Returns the launches of the
    main path's run."""
    import shutil

    root = os.path.join(ROOT, "profiles", "chip_smoke_train_bf16")
    shutil.rmtree(root, ignore_errors=True)
    try:
        row = {"phase": "train_bf16",
               "config": "config/stereo_fast_train.yaml",
               "batch": FAST_BATCH, "chunk_seconds": FAST_SECONDS,
               **_fast_train(torch, root)}
        row["step_compared"] = _fast_steps_compared(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(row)
    counts, timed = row["main_path_launches"], row["timed"]
    ok = (row["params"] == 494786 and row["step_compared"]["ok"]
          and counts["lstm_train_fwd"] == FAST_STEPS
          and counts["lstm_train_bwd"] == FAST_STEPS
          and counts["lstm_recurrence_validation"] >= 1
          and timed["bfloat16"]["launches_per_step"] == {
              "lstm_train_fwd": 1.0, "lstm_train_bwd": 1.0}
          and all(np.isfinite(row["history"]["train_loss"]
                              + row["history"]["val_loss"]))
          and "best_model.pth" in row["checkpoints"]
          and timed["bfloat16"]["timed_steps"] == 10
          and row["repeat_3_steps"]["equal"]
          and row["resumed_next_step_equal"])
    if not ok:
        raise AssertionError(f"bf16 training failed: {row}")
    for name in CONVNETS:
        conv = {"phase": "train_bf16", **_convnet_bf16(torch, name)}
        emit(conv)
        if not conv["ok"]:
            raise AssertionError(f"bf16 {name} training failed: {conv}")
    return counts


SEMI_FILES, SEMI_REAL = 224, 32  # clean 2.5 s WAVs; degraded "real" ones
# a semi-supervised step's gradients, card vs CPU in f32, relative L2:
# each loss term of a mixed step (read 2.4e-4 to 1.0e-3) and the adaptive
# step's reference loss, whose log-spectral terms are ill-conditioned in
# f32 (read 6.6e-3; PERF.md)
SEMI_GRAD_TOL = {"mixed": 1e-2, "adaptive": 3e-2}
SEMI_VARIANTS = ("mixed", "mixed_contrastive", "mixed_contrastive_bf16",
                 "adaptive")


def _write_real_corpus(root, files: int, seconds: float, rate: int = 22050):
    """'Real' 78rpm recordings: seeded mono WAVs degraded by the port's
    simulator on the CPU, each from its own seeded generator."""
    import torch

    from ml_audio_restoration_torch.audio import save_audio
    from ml_audio_restoration_torch.data import simulate_batch

    os.makedirs(root, exist_ok=True)
    frames = int(seconds * rate)
    for i in range(files):
        x = torch.from_numpy(_mono_batch(1, frames, rate, seed=3000 + i))
        y = simulate_batch(torch.Generator().manual_seed(3000 + i), x, rate)
        save_audio(os.path.join(root, f"real_{i:03d}.wav"), y[0].numpy(),
                   rate)


def _semi_config(root, ckpt_dir, **train):
    """config/denoiser.yaml over <root>/wavs and <root>/real: one epoch, a
    checkpoint each epoch."""
    from ml_audio_restoration_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "config", "denoiser.yaml"))
    cfg.train.num_epochs = 1
    cfg.train.save_every = 1
    cfg.train.checkpoint_dir = os.path.join(root, ckpt_dir)
    cfg.train.log_dir = os.path.join(root, "runs")
    for k, v in train.items():
        setattr(cfg.train, k, v)
    cfg.data.data_dir = os.path.join(root, "wavs")
    cfg.data.degraded_dir = os.path.join(root, "real")
    return cfg


def _semi_variant(torch, root, variant):
    """One semi-supervised variant of the denoiser at full width: 'mixed'
    and 'adaptive' through train_from_config(dataset_kind=...),
    'mixed_contrastive' through a Trainer over MixedRestorationDataset(
    use_contrastive=True) with contrastive_weight 0.1, and
    'mixed_contrastive_bf16' the same at compute_dtype bfloat16 (the
    re-inference and both encoder passes on the step's one bf16 cast);
    then one step card vs CPU at batch 2 (a CPU generator: the same draws
    on both; in f32 the gradient of each loss term of a mixed step too, in
    bf16 `_bf16_held`), two seeded 3-step runs and 10 timed steps of batch
    16."""
    import copy
    from pathlib import Path

    from ml_audio_restoration_torch.data import (
        DataLoader, MixedRestorationDataset, train_val_split)
    from ml_audio_restoration_torch.models import AudioDenoiser, init_params
    from ml_audio_restoration_torch.train.trainer import (
        Trainer, build_trainer, train_from_config)

    kind = "adaptive" if variant == "adaptive" else "mixed"
    contrastive = variant.startswith("mixed_contrastive")
    dtype = "bfloat16" if variant.endswith("_bf16") else "float32"
    cfg = _semi_config(root, f"ck_{variant}", compute_dtype=dtype,
                       contrastive_weight=0.1 if contrastive else 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if contrastive:
        d = cfg.data
        ds = MixedRestorationDataset(d.data_dir, d.degraded_dir,
                                     d.sample_rate, d.chunk_duration,
                                     synthetic_ratio=d.synthetic_ratio,
                                     use_contrastive=True)
        tr_idx, va_idx = train_val_split(ds, d.val_split, cfg.train.seed)
        bs = cfg.train.batch_size
        tr = Trainer("denoiser", init_params(
            AudioDenoiser(), torch.Generator().manual_seed(cfg.train.seed)),
            DataLoader(ds, bs, indices=tr_idx[:12 * bs],
                       seed=cfg.train.seed),
            DataLoader(ds, min(bs, len(va_idx)), indices=va_idx,
                       shuffle=False, seed=cfg.train.seed),
            config=cfg.train)
        tr.checkpoint_dir = Path(cfg.train.checkpoint_dir) / "denoiser"
        history = tr.train()
    else:
        history = train_from_config(cfg, steps_per_epoch=12,
                                    dataset_kind=kind)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    hook = None
    if not contrastive:
        # resumed from the run's checkpoint; the adaptive set's re-analysis
        # hook is read after one more epoch through Trainer.train
        tr = build_trainer(cfg, steps_per_epoch=12, dataset_kind=kind)
        if kind == "adaptive":
            history["epoch_2"] = tr.train(num_epochs=2)["train_loss"]
            hook = tr.train_loader.dataset._hook_used
    ds = tr.train_loader.dataset
    batches = _loader_batches(tr, 12)

    # one step card vs CPU at batch 2 on the same draws, of a synthetic
    # and a real item where the batch has both (each term then has a
    # gradient)
    base = copy.deepcopy(tr.model).cpu()
    rows = [0, 1]
    if "is_synthetic" in batches[0]:
        syn = np.asarray(batches[0]["is_synthetic"]) > 0
        if syn.any() and not syn.all():
            rows = [int(np.argmax(syn)), int(np.argmax(~syn))]
    small = {k: v[rows] for k, v in batches[0].items()}
    terms = (("total", "supervised", "consistency", "cycle")
             + (("contrastive",) if contrastive else ())
             if kind == "mixed" and dtype == "float32" else ())

    def side(device, dt):
        c = copy.deepcopy(cfg.train)
        c.compute_dtype = dt
        t = Trainer("denoiser", copy.deepcopy(base), [], config=c,
                    pairing=tr.pairing, device=device)
        return _step_grads(torch, t, small,
                           torch.Generator().manual_seed(51),
                           terms if dt == "float32" else ())

    if dtype == "float32":
        card, cpu = side("cuda", dtype), side("cpu", dtype)
        card_cpu = _bf16_devs(card, cpu)
        def term_dev(k):
            if any(bool(g.any()) for g in cpu[3][k]):
                return _rel_l2(card[3][k], cpu[3][k])
            # no gradient (all items of one type): nor may the card's have
            return (float("inf") if any(bool(g.any()) for g in card[3][k])
                    else 0.0)

        card_cpu["term_grad_rel_l2"] = {k: term_dev(k) for k in terms}
        card_cpu["ok"] = bool(
            card_cpu["loss_rel"] <= CPU_TOL
            and card_cpu["grad_rel_l2"] <= SEMI_GRAD_TOL[kind]
            and all(v <= SEMI_GRAD_TOL[kind]
                    for v in card_cpu["term_grad_rel_l2"].values()))
    else:
        card_cpu, ok = _bf16_held({(d, t): side(d, t)
                                   for d in ("cuda", "cpu")
                                   for t in ("bfloat16", "float32")})
        card_cpu["ok"] = ok

    runs = _runs_equal(
        torch, lambda: Trainer("denoiser", copy.deepcopy(base), [],
                               config=cfg.train, pairing=tr.pairing,
                               device="cuda"),
        batches[:3], [(lambda i=i: torch.Generator("cuda").manual_seed(i))
                      for i in range(3)])
    seeds = [(lambda i=i: tr._seeded(2, i)) for i in range(12)]
    timing = _timed_steps(torch, tr, batches, seeds)
    return {"variant": variant, "pairing": tr.pairing,
            "compute_dtype": dtype,
            "dataset": type(ds).__name__, "epoch_s": epoch_s,
            "checkpoints": sorted(os.listdir(tr.checkpoint_dir)),
            "history": history, "on_epoch_end_fired": hook,
            "batch_keys": sorted(batches[0]),
            "card_vs_cpu_batch2": card_cpu, "repeat_3_steps": runs,
            "timed": timing}


def phase_train_semi(torch):
    """The denoiser's semi-supervised and adaptive training at full width
    (config/denoiser.yaml: batch 16 of 2 s): seeded clean WAVs and "real"
    ones degraded by the port's simulator on the CPU, under profiles/
    (removed after); `mixed`, `mixed` with the contrastive term in f32 and
    in bf16, and `adaptive` (on_epoch_end firing), each one step card vs
    CPU, two seeded runs equal and 10 timed steps. No kernel of the
    package runs here."""
    import shutil

    root = os.path.join(ROOT, "profiles", "chip_smoke_train_semi")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        _write_mono_corpus(os.path.join(root, "wavs"), SEMI_FILES, 2.5,
                           22050)
        _write_real_corpus(os.path.join(root, "real"), SEMI_REAL, 2.5)
        corpus_s = time.perf_counter() - t0
        for variant in SEMI_VARIANTS:
            row = {"phase": "train_semi", "corpus_write_s": corpus_s,
                   **_semi_variant(torch, root, variant)}
            emit(row)
            ok = (row["repeat_3_steps"]["equal"]
                  and all(np.isfinite(row["history"]["train_loss"]
                                      + row["history"]["val_loss"]))
                  and "best_model.pth" in row["checkpoints"]
                  and row["timed"]["timed_steps"] == 10
                  and row["card_vs_cpu_batch2"]["ok"]
                  and (variant != "adaptive" or row["on_epoch_end_fired"])
                  and (not variant.startswith("mixed_contrastive")
                       or "contrastive_pair" in row["batch_keys"]))
            if not ok:
                raise AssertionError(f"semi-supervised training failed: "
                                     f"{row}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------- train_dp
DP_RANKS = 2        # processes, both on cuda:0 through gloo
DP_BATCH = 16       # the global batch: 8 a rank
DP_STEPS = 6        # steps of the counted epoch (and of the resumed one)
DP_FILES = 110      # 99 train (96 used: 6 steps of 16) + 11 validation
DP_WAIT_S = 150     # each rank's wait; a hung rank fails the phase
DP_PARAM_TOL = 2e-3  # parameters after Adam (JAX tests/test_trainer.py:163)
DP_STATS_TOL = 1e-5  # BN running statistics
DP_LABEL = "two ranks time-sharing one H100: not a scaling figure"


def _dp_batch(name: str, dtype=np.float32) -> dict:
    """The global batch of a step check, [16, C, 44,100] at 22.05 kHz:
    stereo tones for the stereo net; mono for the denoiser's `mixed`
    pairing with 6 synthetic items on rank 0 and 3 on rank 1, so a local
    masked mean differs from the global one."""
    if name == "stereo_separator":
        return {"stereo": _stereo_batch(DP_BATCH, 44100, 51)["stereo"]
                .astype(dtype)}
    return {"audio": _mono_batch(DP_BATCH, 44100, 22050, 52).astype(dtype),
            "is_synthetic": np.float32([1, 1, 1, 1, 1, 1, 0, 0,
                                        1, 0, 0, 1, 0, 1, 0, 0])}


def _dp_step(torch, name, rows, dtype, **cfg):
    """One train step at full width (seeded weights, in `dtype`) on rows of
    a step check's global batch, with the step seed of epoch 1, step 0, on
    cuda:0 under whatever process group is up: the loss and metrics, the
    gradients Adam was handed, the parameters and buffers after, as
    numpy."""
    from ml_audio_restoration_torch.config import TrainConfig
    from ml_audio_restoration_torch.models import (
        AudioDenoiser, StereoSeparator, init_params)
    from ml_audio_restoration_torch.parallel import distributed as dist
    from ml_audio_restoration_torch.train.trainer import Trainer

    net = StereoSeparator() if name == "stereo_separator" else AudioDenoiser()
    model = init_params(net, torch.Generator().manual_seed(5)).to(dtype)
    pairing = "mono_target_stereo" if name == "stereo_separator" else "mixed"
    tr = Trainer(name, model, [], pairing=pairing, device="cuda",
                 config=TrainConfig(model=name, learning_rate=1e-4,
                                    data_parallel=dist.process_count(),
                                    **cfg))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    batch = {k: v[rows] for k, v in _dp_batch(name, np_dtype).items()}
    metrics = tr._train_step(batch, tr._seeded(2, 0))
    out = {f"metric.{k}": v for k, v in metrics.items()}
    out.update((f"grad.{n}", p.grad) for n, p in model.named_parameters())
    out.update((f"param.{n}", p) for n, p in model.named_parameters())
    out.update((f"buffer.{n}", b) for n, b in model.named_buffers())
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


DP_STEP_CHECKS = {  # name -> (family, dtype, TrainConfig fields)
    # K2 and K3 at T=44,100 B=8 run here too
    "stereo_smooth_f32": ("stereo_separator", "float32", SMOOTH_TERMS),
    "mixed_f32": ("denoiser", "float32", {}),
    "mixed_f64": ("denoiser", "float64", {}),
}


def _dp_config(root, ckpt_dir, epochs: int, ranks: int = DP_RANKS):
    """The stereo net over the phase's WAVs: batch 16 of 2 s over `ranks`
    processes, `epochs` epochs."""
    cfg = _train_config("stereo_separator", root, ckpt_dir, DP_BATCH, 2.0)
    cfg.train.num_epochs = epochs
    cfg.train.data_parallel = ranks
    return cfg


def _train_dp_worker(spec_path: str, rank: int) -> int:
    """One rank of the train_dp phase (a fresh interpreter that
    phase_train_dp starts): the step checks in a group of two, then the
    main path, train_from_config of the stereo net over the phase's WAVs
    (the K2/K3 launches counted; each step and each collective timed by
    host clocks around a synchronize), then a resume of it in a new
    group. Writes rank<r>.json and .npz files into the spec's root."""
    import torch

    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.parallel import distributed as dist
    from ml_audio_restoration_torch.train import trainer as T

    with open(spec_path) as f:
        spec = json.load(f)
    root = spec["root"]
    coord = [f"127.0.0.1:{p}" for p in spec["ports"]]
    rows = slice(rank * DP_BATCH // DP_RANKS,
                 (rank + 1) * DP_BATCH // DP_RANKS)
    out = {"rank": rank}

    dist.initialize(coord[0], DP_RANKS, rank, device="cuda")
    out["backend"] = dist.tdist.get_backend()
    out["device"] = str(dist.device_for_rank("cuda"))
    L.reset_launch_count()
    for check, (name, dtype, cfg) in DP_STEP_CHECKS.items():
        np.savez(os.path.join(root, f"{check}_rank{rank}.npz"),
                 **_dp_step(torch, name, rows, getattr(torch, dtype), **cfg))
    out["step_check_launches"] = {"lstm_train_fwd": L.train_fwd_launch_count,
                                  "lstm_train_bwd": L.train_bwd_launch_count}

    # the main path, instrumented: every collective and every step timed
    built, steps, colls = [], [], []
    real_build, real_reduce = T.build_trainer, dist._all_reduce

    def timed_reduce(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(t)
        torch.cuda.synchronize()
        colls.append((t.numel(), (time.perf_counter() - t0) * 1e3))
        return t

    def build(*a, **kw):
        tr = real_build(*a, **kw)
        built.append(tr)
        real_step = tr._train_step

        def step(batch, generator=None):
            torch.cuda.synchronize()
            n0, t0 = len(colls), time.perf_counter()
            metrics = real_step(batch, generator)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "collectives": colls[n0:]})
            return metrics

        tr._train_step = step
        return tr

    T.build_trainer = build
    dist._all_reduce = timed_reduce
    try:
        L.reset_launch_count()
        history = T.train_from_config(_dp_config(root, "ck", 1),
                                      steps_per_epoch=DP_STEPS)
        out["launches"] = {"lstm_train_fwd": L.train_fwd_launch_count,
                           "lstm_train_bwd": L.train_bwd_launch_count,
                           "lstm_recurrence_validation": L.launch_count}
        dist._all_reduce = real_reduce
        out["history"] = history
        out["logger"] = built[0].logger is not None
        out["steps"] = list(steps)
        np.savez(os.path.join(root, f"final_rank{rank}.npz"),
                 **{k: v.cpu().numpy()
                    for k, v in built[0].model.state_dict().items()})
        # resume from rank 0's checkpoint in a new group: one more epoch
        steps.clear()
        dist.initialize(coord[1], DP_RANKS, rank, device="cuda")
        out["resumed_history"] = T.train_from_config(
            _dp_config(root, "ck", 2), steps_per_epoch=DP_STEPS)
        out["resumed_from_epoch"] = len(out["resumed_history"]["train_loss"])
        out["resumed_steps_ms"] = [s["ms"] for s in steps]
        np.savez(os.path.join(root, f"resumed_rank{rank}.npz"),
                 **{k: v.cpu().numpy()
                    for k, v in built[1].model.state_dict().items()})
    finally:
        T.build_trainer, dist._all_reduce = real_build, real_reduce
        dist.shutdown()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"RANK{rank}_DONE", flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_dp_ranks(root):
    """Start the two ranks (fresh interpreters; never a fork of this
    process, which holds a CUDA context), wait DP_WAIT_S for each, kill
    any left. A gloo connect that timed out on a loaded host is retried
    once on fresh ports. -> their outputs."""
    def once():
        spec = os.path.join(root, "spec.json")
        with open(spec, "w") as f:
            json.dump({"root": root,
                       "ports": [_free_port(), _free_port()]}, f)
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--train-dp-worker",
             spec, str(r)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(DP_RANKS)]
        try:
            outs = [p.communicate(timeout=DP_WAIT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        return procs, outs

    procs, outs = once()
    if any("Connect timeout" in o or "connectFullMesh" in o for o in outs):
        procs, outs = once()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"RANK{r}_DONE" not in o:
            raise AssertionError(f"train_dp rank {r} failed "
                                 f"(rc {p.returncode}):\n{o[-6000:]}")
    return outs


def _dp_held(check, got, want):
    """A step check's rank against the one-process step: the deviations
    and whether each is within its bar. Gradients: the largest deviation
    over every parameter, of the largest entry (train_small's STEP_TOL);
    held in f32 for the stereo net's smooth terms and in f64 for the mixed
    step, whose f32 gradient reads through the consistency term's
    log-magnitude spectrum and the leaky ReLUs' kinks (PERF.md, PR 12)."""
    grads = [k for k in want if k.startswith("grad.")]
    grad_dev = (max(float(np.abs(got[k] - want[k]).max()) for k in grads)
                / max(float(np.abs(want[k]).max()) for k in grads))
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    params = [k for k in want if k.startswith("param.")]
    row = {"loss_rel": abs(float(got["metric.loss"] - want["metric.loss"]))
           / abs(float(want["metric.loss"])),
           "grad_of_largest": grad_dev,
           "bn_stats_max_abs": max(float(np.abs(got[k] - want[k]).max())
                                   for k in stats),
           "params_max_abs": max(float(np.abs(got[k] - want[k]).max())
                                 for k in params)}
    row["ok"] = (row["loss_rel"] <= STEP_TOL
                 and row["bn_stats_max_abs"] <= DP_STATS_TOL
                 and row["params_max_abs"] <= DP_PARAM_TOL
                 and (check == "mixed_f32" or grad_dev <= STEP_TOL))
    return row


def phase_train_dp(torch):
    """Data-parallel training of the stereo net at full width as two
    processes sharing cuda:0 through gloo (the card host has one H100), a
    one-rank NCCL group, and the one-process twins they are held to.
    Returns rank 0's K2/K3 launches on the main path."""
    import shutil

    from ml_audio_restoration_torch.parallel import distributed as dist

    root = os.path.join(ROOT, "profiles", "chip_smoke_train_dp")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        _write_corpus(os.path.join(root, "wavs"), files=DP_FILES,
                      seconds=2.5)
        corpus_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = _spawn_dp_ranks(root)
        ranks_s = time.perf_counter() - t0
        info = []
        for r in range(DP_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                info.append(json.load(f))

        def arrays(stem, r):
            return dict(np.load(os.path.join(root, f"{stem}_rank{r}.npz")))

        def equal(stem):
            a, b = arrays(stem, 0), arrays(stem, 1)
            return a.keys() == b.keys() and all(
                np.array_equal(a[k], b[k]) for k in a)

        ranks_equal = {stem: equal(stem) for stem in
                       ("final", "resumed", *DP_STEP_CHECKS)}
        ranks_equal["history"] = info[0]["history"] == info[1]["history"]
        ranks_equal["resumed_history"] = (info[0]["resumed_history"]
                                          == info[1]["resumed_history"])

        # the one-process twins on the concatenated batch, here
        held = {}
        for check, (name, dtype, cfg) in DP_STEP_CHECKS.items():
            want = _dp_step(torch, name, slice(None), getattr(torch, dtype),
                            **cfg)
            held[check] = _dp_held(check, arrays(check, 0), want)

        # a one-rank NCCL group: the distributed route of a stereo step
        plain = _dp_step(torch, "stereo_separator", slice(0, 8),
                         torch.float32)
        dist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
        try:
            backend = dist.tdist.get_backend()
            grouped = _dp_step(torch, "stereo_separator", slice(0, 8),
                               torch.float32)
        finally:
            dist.shutdown()
        nccl = {"backend": backend, "bit_for_bit": plain.keys()
                == grouped.keys() and all(np.array_equal(plain[k], grouped[k])
                                          for k in plain)}

        # the one-process step at the global batch 16, beside the ranks'
        from ml_audio_restoration_torch.train.trainer import build_trainer

        tr = build_trainer(_dp_config(root, "ck_one", 1, ranks=1),
                           steps_per_epoch=DP_STEPS)
        batches = _loader_batches(tr, 4)
        tr._train_step(batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[1:]:
            tr._train_step(b)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3 / 3
        del tr

        ckpts = sorted(os.listdir(os.path.join(root, "ck",
                                               "stereo_separator")))
        metrics_files = sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(os.path.join(root, "runs"))
            for f in fs if f.endswith(".jsonl"))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def split(r):
        # the first step builds cuDNN's plans: the median of the rest
        rest = info[r]["steps"][1:]
        # the gradient all-reduce: the step's largest collective
        grad = [max(s["collectives"])[1] for s in rest]
        every = [sum(ms for _, ms in s["collectives"]) for s in rest]
        return {"step_ms": statistics.median(s["ms"] for s in rest),
                "step_ms_uninstrumented": statistics.median(
                    info[r]["resumed_steps_ms"][1:]),
                "gradient_allreduce_ms": statistics.median(grad),
                "all_collectives_ms": statistics.median(every),
                "collectives_per_step": len(rest[0]["collectives"])}

    launches = info[0]["launches"]
    row = {"phase": "train_dp", "label": DP_LABEL,
           "nvidia_smi": _nvidia_smi(), "ranks": DP_RANKS,
           "backend": info[0]["backend"],
           "devices": [i["device"] for i in info],
           "global_batch": DP_BATCH, "local_batch": DP_BATCH // DP_RANKS,
           "chunk_seconds": 2.0, "steps": DP_STEPS,
           "corpus_write_s": corpus_s, "ranks_wall_s": ranks_s,
           "history": info[0]["history"],
           "resumed_history": info[0]["resumed_history"],
           "ranks_equal": ranks_equal,
           "writers": {"rank0_saved": "checkpoint saved" in outs[0],
                       "rank1_saved": "checkpoint saved" in outs[1],
                       "loggers": [i["logger"] for i in info],
                       "checkpoints": ckpts, "metrics_files": metrics_files},
           "per_rank": [split(r) for r in range(DP_RANKS)],
           "one_process_b16_step_ms": one_ms,
           "vs_one_process": held, "nccl_one_rank": nccl,
           "launches": launches,
           "step_check_launches": info[0]["step_check_launches"]}
    emit(row)
    ok = (all(ranks_equal.values())
          and all(np.isfinite(row["history"]["train_loss"]
                              + row["history"]["val_loss"]))
          and row["backend"] == "gloo" and row["devices"] == ["cuda:0"] * 2
          and row["writers"]["rank0_saved"]
          and not row["writers"]["rank1_saved"]
          and row["writers"]["loggers"] == [True, False]
          and "best_model.pth" in ckpts and len(metrics_files) == 1
          and len(row["resumed_history"]["train_loss"]) == 2
          and row["resumed_history"]["train_loss"][0]
          == row["history"]["train_loss"][0]
          and all(h["ok"] for h in held.values())
          and nccl == {"backend": "nccl", "bit_for_bit": True}
          and launches["lstm_train_fwd"] == DP_STEPS
          and launches["lstm_train_bwd"] == DP_STEPS
          and launches["lstm_recurrence_validation"] >= 1)
    if not ok:
        raise AssertionError(f"data-parallel training failed: {row}")
    return {k: launches[k] for k in ("lstm_train_fwd", "lstm_train_bwd")}


# ------------------------------------------------------------------ files
FILES_REL = 1e-4    # a metric that reads neither the pipeline's output nor
#                     the degradation, card vs CPU: f32 reductions in
#                     another order
EVAL_SECONDS = 8.0  # evaluate's default clip length
DEVICES = (("card", "cuda"), ("cpu", "cpu"))
FLAC_RESTORE_SECONDS = 30.0  # restore_file to FLAC: the numpy FLAC writer
#                     encodes the 44.1 kHz stereo output on the host


def _host_cpu() -> str:
    """The host CPU for host-side figures: /proc/cpuinfo's model name and,
    where the machine reports it as unknown, its vendor, family and model
    numbers; the machine type and the CPU count."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name", "unknown")
    if name == "unknown" and "vendor_id" in fields:
        name += (f" ({fields['vendor_id']} family "
                 f"{fields.get('cpu family', '?')} model "
                 f"{fields.get('model', '?')})")
    return f"{name}, {platform.machine()}, {os.cpu_count()} CPUs"


def _host_ms(fn):
    """(host ms, result) of one call of fn."""
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


class _Recorded:
    """A pipeline whose restore outputs are kept, in call order."""

    def __init__(self, pipe):
        self.pipe, self.device, self.outputs = pipe, pipe.device, []

    def restore(self, audio, sample_rate):
        out, rate = self.pipe.restore(audio, sample_rate)
        self.outputs.append(out.detach().cpu())
        return out, rate


class _Moved:
    """Replays recorded outputs moved by +-eps in a seeded sign pattern:
    the pipeline's output at the chain's bar."""

    def __init__(self, outputs, eps, seed):
        self.device, self.outputs, self.eps = "cpu", list(outputs), eps
        self.gen = np.random.default_rng(seed)

    def restore(self, audio, sample_rate):
        import torch

        out = self.outputs.pop(0)
        sign = self.gen.choice([-1.0, 1.0], size=tuple(out.shape))
        return out + torch.from_numpy(self.eps * sign).float(), sample_rate


# the metrics of each evaluation that read the pipeline's output, and
# those that read the denoiser evaluation's degradation
OUTPUT_METRICS = {"snr_restored", "sisdr_restored", "lsd_restored",
                  "spec_restored", "lsd_model", "correlation_upmix",
                  "width_upmix"}
DEGRADED_METRICS = {"snr_degraded", "sisdr_degraded", "lsd_degraded",
                    "spec_degraded"}


def _metric_bars(rows_fn, recorded, rows_cpu):
    """Per file and metric, the bar card vs CPU: the larger change of the
    CPU's metric (two seeded sign patterns) when the pipeline's output
    moves by +-CPU_TOL, the chain's bar, and the degradation by
    +-DEGRADE_TOL, the simulator's card-vs-CPU bar; for the metrics that
    read neither, FILES_REL of the value (at least FILES_REL)."""
    from ml_audio_restoration_torch import evaluate as ev

    simulate = ev.simulate_vinyl_artifacts
    moved = []
    try:
        for seed in (0, 1):
            signs = np.random.default_rng(seed + 10)

            def moved_degradation(*args, **kw):
                out = simulate(*args, **kw)
                sign = signs.choice([-1.0, 1.0], size=tuple(out.shape))
                return out + _tensor_like(DEGRADE_TOL * sign, out)

            ev.simulate_vinyl_artifacts = moved_degradation
            moved.append(rows_fn(_Moved(recorded, CPU_TOL, seed)))
    finally:
        ev.simulate_vinyl_artifacts = simulate
    bars = []
    for i, row in enumerate(rows_cpu):
        bars.append({k: (max(abs(m[i][k] - v) for m in moved)
                         if k in OUTPUT_METRICS | DEGRADED_METRICS
                         else FILES_REL * max(1.0, abs(v)))
                     for k, v in row.items()})
    return bars


def _tensor_like(array, like):
    """`array` as a tensor of `like`'s dtype on its device."""
    import torch

    return torch.from_numpy(array).to(like.device, like.dtype)


def _write_eval_files(root):
    """Eight seeded 8 s mono FLACs at 44.1 kHz in <root>/eval and two
    stereo ones (L and R decorrelated) in <root>/eval_stereo."""
    from ml_audio_restoration_torch.audio import save_audio

    rate = 44100
    for i in range(8):
        save_audio(os.path.join(root, "eval", f"take_{i}.flac"),
                   _clip(EVAL_SECONDS, rate, seed=50 + i), rate)
    for i in range(2):
        mono = _clip(EVAL_SECONDS, rate, seed=60 + i)[0]
        side = 0.03 * np.random.default_rng(70 + i).standard_normal(
            mono.size)
        save_audio(os.path.join(root, "eval_stereo", f"take_{i}.flac"),
                   np.stack([mono + side, mono - side]).astype(np.float32),
                   rate)


def _files_flac(torch, L, tmp, pipe, rate, cpu_name):
    """The 120 s clip through the FLAC writer, the C++ and the numpy
    decoders (bit for bit, equal to its 16-bit WAV), host ms of each codec;
    then restore_file .flac -> .flac against .wav -> .wav on the card."""
    from ml_audio_restoration_torch.audio import (
        flac, native, read_wav, save_audio, write_wav)

    clip = _clip(120.0, rate, seed=3)
    paths = {k: os.path.join(tmp, f"clip_{k}") for k in (
        "a.flac", "numpy.wav", "native.wav")}
    ms = {}
    ms["flac_encode_numpy"], _ = _host_ms(
        lambda: flac.write_flac(paths["a.flac"], clip.T, rate))
    ms["wav_encode_numpy"], _ = _host_ms(
        lambda: write_wav(paths["numpy.wav"], clip.T, rate))
    ms["wav_encode_native"], _ = _host_ms(
        lambda: native.write_pcm16(paths["native.wav"], clip.T, rate))
    ms["flac_decode_native"], (a, _) = _host_ms(
        lambda: native.read(paths["a.flac"]))
    ms["flac_decode_numpy"], (b, _) = _host_ms(
        lambda: flac.read_flac(paths["a.flac"]))
    ms["wav_decode_native"], (c, _) = _host_ms(
        lambda: native.read(paths["numpy.wav"]))
    ms["wav_decode_numpy"], (d, _) = _host_ms(
        lambda: read_wav(paths["numpy.wav"]))
    decoders_equal = bool(np.array_equal(a, b) and np.array_equal(a, c)
                          and np.array_equal(c, d)
                          and np.array_equal(native.read(
                              paths["native.wav"])[0], c))

    short = clip[:, :int(FLAC_RESTORE_SECONDS * rate)]
    outs, launches, wall = {}, {}, {}
    for ext in ("flac", "wav"):
        src = os.path.join(tmp, f"in.{ext}")
        dst = os.path.join(tmp, f"out.{ext}")
        save_audio(src, short, rate)
        torch.cuda.synchronize()
        L.reset_launch_count()
        _reset_epilogue()
        t0 = time.perf_counter()
        _, out_rate = pipe.restore_file(src, dst)
        wall[ext] = time.perf_counter() - t0
        launches[ext] = L.launch_count
        _note_epilogue(f"files_{ext}_restore")
        outs[ext], got_rate = native.read(dst)
    row = {"phase": "files_flac", "seconds": 120.0, "host_cpu": cpu_name,
           "host_ms": ms, "flac_bytes": os.path.getsize(paths["a.flac"]),
           "wav_bytes": os.path.getsize(paths["numpy.wav"]),
           "decoders_bit_equal": decoders_equal,
           "restore_file_seconds": FLAC_RESTORE_SECONDS,
           "restore_file_wall_s": wall, "restore_file_launches": launches,
           "flac_out_equals_wav_out": bool(np.array_equal(outs["flac"],
                                                          outs["wav"])),
           "out_shape": list(outs["flac"].shape), "out_rate": got_rate}
    emit(row)
    if not (decoders_equal and row["flac_out_equals_wav_out"]
            and got_rate == out_rate == 2 * rate
            and outs["flac"].shape == (2 * short.shape[1], 2)
            and launches == {"flac": 1, "wav": 1}):
        raise AssertionError(f"FLAC files failed: {row}")
    return launches["flac"]


def _write_stage_files(torch, tmp, models):
    """Each full-width seeded model as the JAX package's .msgpack (params,
    BN state, EMA weights at half the parameters, name, epoch), written
    by the port's msgpack writer, and as an upstream .pth."""
    from ml_audio_restoration_torch.compat import (
        jax_from_state_dict, msgpack, save_pth)

    names = ("denoiser", "super_resolution", "stereo_separator")
    files = {"msgpack": [], "pth": [], "state_dicts": []}
    for name, model in zip(names, models):
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        params, state = jax_from_state_dict(name, sd)
        ema_sd = dict(sd)
        for k, _ in model.named_parameters():
            ema_sd[k] = sd[k] * 0.5
        payload = {"params": params, "model_state": state,
                   "ema_params": jax_from_state_dict(name, ema_sd)[0],
                   "model_name": name, "epoch": np.asarray(0)}
        path = os.path.join(tmp, f"{name}.msgpack")
        with open(path, "wb") as f:
            f.write(msgpack.dumps(payload))
        files["msgpack"].append(path)
        files["pth"].append(save_pth(os.path.join(tmp, f"{name}.pth"),
                                     name, sd))
        files["state_dicts"].append((sd, ema_sd))
    return files


def _files_msgpack(torch, L, files, rate):
    """RestorationPipeline.from_checkpoints(*.msgpack) on the card against
    the pipeline from the same weights' .pth, on the 120 s clip; a
    StreamingRestorer from the .msgpack files takes one feed."""
    from ml_audio_restoration_torch.pipeline import (
        RestorationPipeline, StreamingRestorer)

    clip = _clip(120.0, rate, seed=3)
    pipes = {kind: RestorationPipeline.from_checkpoints(*files[kind])
             for kind in ("msgpack", "pth")}
    outs = {}
    for kind, pipe in pipes.items():
        pipe.restore(clip, rate)  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        L.reset_launch_count()
        _reset_epilogue()
        t0 = time.perf_counter()
        outs[kind], _ = pipe.restore(clip, rate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _note_epilogue(f"files_{kind}_restore")
        if kind == "msgpack":
            launches, msgpack_wall = L.launch_count, wall
    stream = StreamingRestorer.from_checkpoints(*files["msgpack"])
    fed = stream.feed(clip[0, :rate // 2])
    row = {"phase": "files_msgpack", "seconds": 120.0,
           "wall_s": msgpack_wall, "xrt": 120.0 / msgpack_wall,
           "lstm_recurrence_launches": launches,
           "equals_pth_pipeline": bool(torch.equal(outs["msgpack"],
                                                   outs["pth"])),
           "stream_feed_shape": list(fed.shape),
           "stream_feed_finite": bool(np.isfinite(fed).all())}
    emit(row)
    if not (row["equals_pth_pipeline"] and launches == 1
            and bool(torch.isfinite(outs["msgpack"]).all())
            and fed.ndim == 2 and fed.shape[0] == 2
            and row["stream_feed_finite"]):
        raise AssertionError(f".msgpack serving failed: {row}")
    del pipes, outs, stream
    torch.cuda.empty_cache()
    return launches


def _files_export(torch, tmp, files):
    """cli export of the .msgpack files (with and without --ema) and of a
    port trainer checkpoint with --ema (one denoiser step at full width, so
    its EMA differs from its weights): each upstream .pth loads strict and
    equals its source (num_batches_tracked 0, as the JAX exporter
    writes)."""
    from ml_audio_restoration_torch import cli
    from ml_audio_restoration_torch.compat import load_pth, model_from_state_dict
    from ml_audio_restoration_torch.config import TrainConfig
    from ml_audio_restoration_torch.models import AudioDenoiser, init_params
    from ml_audio_restoration_torch.train.trainer import Trainer

    names = ("denoiser", "super_resolution", "stereo_separator")
    cases = []
    for name, path, (sd, ema_sd) in zip(names, files["msgpack"],
                                        files["state_dicts"]):
        for ema in (False, True):
            cases.append((f"{name}{'_ema' if ema else ''}", name, path, ema,
                          ema_sd if ema else sd))
    tr = Trainer("denoiser", init_params(AudioDenoiser(),
                                         torch.Generator().manual_seed(0)),
                 [], pairing="degrade",
                 config=TrainConfig(model="denoiser", ema_decay=0.9,
                                    checkpoint_dir=os.path.join(tmp, "ck")),
                 device="cuda")
    batch = {"clean": _mono_batch(2, 22050, 22050, seed=5)}
    tr._train_step(batch, tr._seeded(0, 0))
    tr.save_checkpoint("trainer.pth")
    port_sd = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    port_ema = dict(port_sd)
    port_ema.update({k: v.detach().cpu() for k, v in tr.ema_params.items()})
    cases.append(("trainer_pth_ema", "denoiser",
                  os.path.join(tr.checkpoint_dir, "trainer.pth"), True,
                  port_ema))
    result = {}
    for label, name, src, ema, want in cases:
        out = os.path.join(tmp, f"export_{label}.pth")
        rc = cli.main(["export", src, out] + (["--ema"] if ema else []))
        got = load_pth(out)
        model_from_state_dict(name, got)  # strict=True, or it raises
        equal = list(got) == list(want) and all(
            torch.equal(got[k], torch.zeros_like(v)
                        if k.endswith("num_batches_tracked") else v)
            for k, v in want.items())
        result[label] = {"rc": rc, "equal_to_source": equal}
    ema_moved = not all(torch.equal(port_ema[k], port_sd[k])
                        for k in tr.ema_params)
    row = {"phase": "files_export", "exports": result,
           "trainer_ema_differs_from_weights": ema_moved}
    emit(row)
    if not (ema_moved and all(r == {"rc": 0, "equal_to_source": True}
                              for r in result.values())):
        raise AssertionError(f"export failed: {row}")


def _files_evaluate(torch, L, tmp, files):
    """The three evaluations of evaluate.py at full width over the FLAC
    files, on the card and on the CPU, each per-file metric card vs CPU
    within its bar (_metric_bars); the stereo evaluation again with the
    plain recurrence on the card (its upmixes at PIPE_TOL of K1's).
    Returns (K1 launches of the card's stereo run, its shape, the
    kernel-vs-plain deviation)."""
    from ml_audio_restoration_torch import evaluate as ev
    from ml_audio_restoration_torch.audio import find_audio_files
    from ml_audio_restoration_torch.ops.chunking import num_chunks
    from ml_audio_restoration_torch.pipeline import RestorationPipeline
    from ml_audio_restoration_torch.pipeline.restore import _bucket

    _write_eval_files(tmp)
    mono = find_audio_files(os.path.join(tmp, "eval"))
    stereo = find_audio_files(os.path.join(tmp, "eval_stereo"))
    kinds = (("denoiser", 0, lambda p: ev.denoiser_rows(
                 p, mono, seconds=EVAL_SECONDS, seed=0)),
             ("super_resolution", 1, lambda p: ev.super_resolution_rows(
                 p, mono, seconds=EVAL_SECONDS)),
             ("stereo", 2, lambda p: ev.stereo_rows(
                 p, stereo, seconds=EVAL_SECONDS)))
    keys = ("denoiser_path", "super_res_path", "stereo_path")
    rows, readings = {}, {}
    for kind, idx, rows_fn in kinds:
        ck = {keys[idx]: files["msgpack"][idx]}
        card = _Recorded(RestorationPipeline.from_checkpoints(**ck))
        cpu = _Recorded(RestorationPipeline.from_checkpoints(**ck,
                                                             device="cpu"))
        rows_fn(card)  # warm-up; its outputs are dropped below
        card.outputs.clear()
        torch.cuda.synchronize()
        L.reset_launch_count()
        _reset_epilogue()
        t0 = time.perf_counter()
        got = rows_fn(card)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = L.launch_count
        _note_epilogue(f"evaluate_{kind}")
        t0 = time.perf_counter()
        want = rows_fn(cpu)
        cpu_wall = time.perf_counter() - t0
        bars = _metric_bars(rows_fn, cpu.outputs, want)
        devs = [{k: abs(g[k] - w[k]) for k in w} for g, w in zip(got, want)]
        held = len(got) == len(want) > 0 and all(
            d[k] <= b[k] for d, b in zip(devs, bars) for k in d)
        readings[kind] = {
            "files": len(got), "card_wall_s": wall, "cpu_wall_s": cpu_wall,
            "lstm_recurrence_launches": launches,
            "worst": {k: {"dev": max(d[k] for d in devs),
                          "bar": min(b[k] for b in bars)}
                      for k in want[0]},
            "held": held, "means": ev._mean_rows(got, ndigits=4)}
        rows[kind] = (card, launches)
        if not held or not all(np.isfinite(list(g.values())).all()
                               for g in got):
            emit({"phase": "files_evaluate", **readings})
            raise AssertionError(f"evaluate {kind}: card vs CPU failed")
    card, launches = rows[kind]
    kernel_out = list(card.outputs)
    card.outputs.clear()
    with L.plain_recurrence():
        kinds[2][2](card)
    vs_plain = max(_max_dev(a, b) for a, b in zip(kernel_out, card.outputs))
    chunk = int(round(card.pipe.config.chunk_seconds * 22050))
    hop = chunk - int(round(card.pipe.config.overlap_seconds * 22050))
    b = _bucket(num_chunks(int(EVAL_SECONDS * 22050), chunk, hop))
    row = {"phase": "files_evaluate", **readings,
           "stereo_k1_shape": [chunk, b, 64],
           "stereo_kernel_vs_plain_max_abs": vs_plain,
           "stereo_kernel_vs_plain_tol": PIPE_TOL}
    emit(row)
    if not (vs_plain <= PIPE_TOL and launches == len(stereo)):
        raise AssertionError(f"evaluate failed: {row}")
    return launches, (chunk, b), vs_plain


def _flac_twin_corpus(root, files: int, seconds: float, stereo: bool):
    """<root>/wav/wavs and <root>/flac/wavs: the same seeded 16-bit audio
    as WAV and as FLAC (the training configs read <root>/wavs)."""
    from ml_audio_restoration_torch.audio import save_audio

    frames = int(seconds * 22050)
    for i in range(files):
        x = (_stereo_batch(1, frames, seed=3000 + i)["stereo"][0] if stereo
             else _mono_batch(1, frames, 22050, seed=3000 + i)[0])
        for ext in ("wav", "flac"):
            save_audio(os.path.join(root, ext, "wavs", f"take_{i:03d}.{ext}"),
                       x, 22050)


def _files_train(torch, L, tmp, cpu_name):
    """train_from_config for two steps (batch 16 of 2 s) and a validation
    batch of the denoiser and of the stereo separator over a FLAC corpus
    (48 files, a third held out) and over the same audio as WAV: the first
    batches and every loss equal bit for bit, K2/K3 counted on the stereo
    runs. Then the C++ batch reader's mono rows/s against the numpy route
    over the FLAC and WAV corpora."""
    from ml_audio_restoration_torch.audio import flac, native, read_wav
    from ml_audio_restoration_torch.train.trainer import (
        build_trainer, train_from_config)

    steps, batch, seconds = 2, 16, 2.0
    out = {"phase": "files_train", "host_cpu": cpu_name, "steps": steps,
           "batch": batch, "chunk_seconds": seconds}
    k2k3 = {}
    for name, stereo in (("denoiser", False), ("stereo_separator", True)):
        root = os.path.join(tmp, name)
        t0 = time.perf_counter()
        _flac_twin_corpus(root, files=48, seconds=2.1, stereo=stereo)
        corpus_s = time.perf_counter() - t0
        runs = {}
        for ext in ("wav", "flac"):
            cfg, cfg_batch = (_train_config(name, os.path.join(root, ext),
                                            ck, batch, seconds)
                              for ck in ("ck", "ck_batch"))
            cfg.data.val_split = cfg_batch.data.val_split = 1 / 3
            first = next(iter(build_trainer(
                cfg_batch, steps_per_epoch=steps).train_loader))
            torch.cuda.synchronize()
            L.reset_launch_count()
            history = train_from_config(cfg, steps_per_epoch=steps)
            torch.cuda.synchronize()
            runs[ext] = (first, history, {
                "lstm_train_fwd": L.train_fwd_launch_count,
                "lstm_train_bwd": L.train_bwd_launch_count,
                "lstm_recurrence_validation": L.launch_count})
        (bw, hw, cw), (bf, hf, cf) = runs["wav"], runs["flac"]
        out[name] = {
            "corpus_write_s": corpus_s, "history_flac": hf,
            "batches_equal": all(np.array_equal(bw[k], bf[k]) for k in bw),
            "losses_equal": hw == hf, "launches_flac": cf,
            "launches_wav": cw}
        if stereo:
            k2k3 = {k: cf[k] for k in ("lstm_train_fwd", "lstm_train_bwd")}
    rates = {}
    mono_root = os.path.join(tmp, "denoiser")
    for ext, numpy_read in (("flac", flac.read_flac), ("wav", read_wav)):
        paths = sorted(os.path.join(mono_root, ext, "wavs", p) for p in
                       os.listdir(os.path.join(mono_root, ext, "wavs")))
        starts = [i * 331 for i in range(len(paths))]
        frames = int(seconds * 22050)
        ms_native, got = _host_ms(lambda: native.read_batch_mono(
            paths, starts, frames, threads=4))

        def numpy_route():
            rows = np.zeros((len(paths), frames), np.float32)
            for row, p, s in zip(rows, paths, starts):
                data, _ = numpy_read(p, start=s, frames=frames)
                row[:data.shape[0]] = data.mean(axis=1)
            return rows

        ms_numpy, want = _host_ms(numpy_route)
        rates[ext] = {"rows": len(paths), "native_rows_per_s":
                      len(paths) / ms_native * 1e3,
                      "numpy_rows_per_s": len(paths) / ms_numpy * 1e3,
                      "equal": bool(np.array_equal(got, want))}
    out["read_batch_mono"] = rates
    emit(out)
    ok = all(out[n]["batches_equal"] and out[n]["losses_equal"]
             and np.isfinite(out[n]["history_flac"]["train_loss"]).all()
             for n in ("denoiser", "stereo_separator"))
    if not (ok and k2k3 == {"lstm_train_fwd": steps,
                            "lstm_train_bwd": steps}
            and out["stereo_separator"]["launches_flac"][
                "lstm_recurrence_validation"] >= 1
            and all(r["equal"] for r in rates.values())):
        raise AssertionError(f"training over FLAC failed: {out}")
    return k2k3


def _files_analyze(torch, tmp, rate):
    """analyze_78rpm_recording on a FLAC, and compare_synthetic_vs_real
    with the simulator on the card and on the CPU: the same draws (a CPU
    generator) give the same degradation within DEGRADE_TOL."""
    from ml_audio_restoration_torch.audio import (
        analyze, detect_impulses_analytical, load_audio, save_audio)
    from ml_audio_restoration_torch.data.artifacts import \
        simulate_vinyl_artifacts

    path = os.path.join(tmp, "recording.flac")
    clip = _clip(4.0, rate, seed=2)
    save_audio(path, clip, rate)
    with contextlib.redirect_stdout(sys.stderr):
        report = analyze.analyze_78rpm_recording(path, rate)
        compared = {label: analyze.compare_synthetic_vs_real(
            path, clip, rate, seed=7, device=dev) for label, dev in DEVICES}
    decoded, _ = load_audio(path, rate)
    want = detect_impulses_analytical(decoded, rate)[2]
    degraded = {label: simulate_vinyl_artifacts(
        torch.Generator().manual_seed(7),
        torch.from_numpy(clip).to(dev), rate).cpu()
        for label, dev in DEVICES}
    dev = _max_dev(degraded["card"], degraded["cpu"])
    row = {"phase": "files_analyze", "impulse_stats": report["impulse_stats"],
           "synthetic_card": compared["card"]["synthetic"],
           "synthetic_cpu": compared["cpu"]["synthetic"],
           "degradation_card_vs_cpu_max_abs": dev, "tol": DEGRADE_TOL}
    emit(row)
    if not (report["impulse_stats"] == want and want["num_impulses"] > 0
            and dev <= DEGRADE_TOL
            and compared["card"]["real"]["impulse_stats"] == want):
        raise AssertionError(f"analyze failed: {row}")


def phase_files(torch):
    """The files slice at full published widths with seeded weights: FLAC,
    .msgpack serving, export, evaluate, training over FLAC and analyze, one
    line each. Returns the K1, K2 and K3 readings of its paths."""
    from ml_audio_restoration_torch.audio import codecs
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.pipeline import RestorationPipeline

    cpu_name = _host_cpu()
    emit({"phase": "files_codecs", "mp3": codecs.mp3_available(),
          "ogg": codecs.ogg_available(), "host_cpu": cpu_name})
    dev = torch.device("cuda")
    models = _models(torch, dev)
    rate = 22050
    parts = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        flac_launches = part("flac", _files_flac, torch, L, tmp,
                             RestorationPipeline(*models), rate, cpu_name)
        files = part("write_stage_files", _write_stage_files, torch, tmp,
                     models)
        del models
        msgpack_launches = part("msgpack", _files_msgpack, torch, L, files,
                                rate)
        part("export", _files_export, torch, tmp, files)
        eval_launches, eval_shape, eval_dev = part(
            "evaluate", _files_evaluate, torch, L, tmp, files)
        k2k3 = part("train", _files_train, torch, L, tmp, cpu_name)
        part("analyze", _files_analyze, torch, tmp, rate)
    emit({"phase": "files_parts_s", **parts})
    return {"k1": {"files_flac_restore": (flac_launches, None, None),
                   "files_msgpack_restore": (msgpack_launches, None, None),
                   "evaluate_stereo": (eval_launches, eval_dev, PIPE_TOL)},
            "evaluate_shape": eval_shape, "k2k3": k2k3}


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
    # cuDNN refuses more than 44,100 steps in one call (phase_kernels):
    # longer gates run in segments with the state threaded through
    run = lambda: _lstm_segments(torch, ref, gates, 44100, state)  # noqa
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


SEQ_T = 5292000    # K1's steps in a 120 s whole-file restore (44.1 kHz)
SEQ_SLICE = 22050  # the steps of the walk held against the plain version


def _k1_whole_file(torch, L, floor_ns, seed):
    """K1 at the whole-file shape of sequence-parallel serving (T=SEQ_T,
    B=1, f32, H=64): timed (median of 3 calls) beside its bound and its
    latency floor; the plain version (a Python loop, minutes at this T)
    runs the first SEQ_SLICE steps, held against the same steps of the
    whole walk and timed there; cuDNN's nn.LSTM, which refuses 88,200
    steps in one call, runs in 44,100-step pieces that carry the state
    (timed once, after one untimed run)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, t, b = 64, SEQ_T, 1
    gates = torch.randn((t, b, 4 * h), generator=gen, device=dev) * 0.5
    w_hh = torch.randn((h, 4 * h), generator=gen, device=dev) * 0.15
    h0 = c0 = torch.zeros(b, h, device=dev)
    run = lambda: L._lstm_recurrence_cuda(gates, w_hh, h0, c0)  # noqa: E731
    out_k = run()
    ms = _cuda_ms(torch, run, 3)
    plain_ms, out_p = _timed_once(torch, lambda: L.lstm_recurrence_plain(
        gates[:SEQ_SLICE], w_hh, h0, c0))
    err = _max_dev(out_k[0][:, :SEQ_SLICE], out_p[0])
    res = L.recurrence_resources(h, torch.float32)
    n_bytes = 4 * (t * b * 4 * h + h * 4 * h + t * b * h) + 4 * 4 * b * h
    flops = 2.0 * t * b * h * 4 * h
    bound_ms, bound_by = _bound(n_bytes, flops)
    ref = torch.nn.LSTM(4 * h, h).to(dev).eval()
    with torch.no_grad():
        ref.weight_ih_l0.copy_(torch.eye(4 * h, device=dev))
        ref.weight_hh_l0.copy_(w_hh.T)
        ref.bias_ih_l0.zero_()
        ref.bias_hh_l0.zero_()
    state = (h0[None].contiguous(), c0[None].contiguous())
    library_ms = lib_dev = None
    try:
        with torch.inference_mode():
            _lstm_segments(torch, ref, gates, 44100, state)
            library_ms, lib = _timed_once(torch, lambda: _lstm_segments(
                torch, ref, gates, 44100, state))
        lib_dev = _max_dev(lib.transpose(0, 1), out_k[0])
        del lib
    except RuntimeError as e:  # the yardstick only: cuDNN may refuse
        lib_dev = str(e)[:200]
    row = {"path": "serve_seq_whole_file", "shape": [t, b, h],
           "dtype": "float32", "carry_in": False, "ms": ms,
           "plain_ms": plain_ms, "plain_steps": SEQ_SLICE,
           "max_abs_err": err, "tol": F32_TOL, "bytes": n_bytes,
           "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
           "floor_ms": t * floor_ns * 1e-6, "ns_per_step": ms * 1e6 / t,
           "waves": 1, **res, "library_ms": library_ms,
           "library_pieces": -(-t // 44100),
           "library_vs_kernel_max_abs": lib_dev}
    emit({"phase": "kernel_check", "kernel": "lstm_recurrence",
          "path": row["path"], "shape": [t, b, h], "dtype": "float32",
          "max_abs_err": err, "tol": F32_TOL, "plain_steps": SEQ_SLICE})
    emit({"phase": "kernel_time", "kernel": "lstm_recurrence", **row})
    if not err <= F32_TOL:
        raise AssertionError(f"lstm_recurrence disagrees with plain at "
                             f"the whole-file shape: {row}")
    del gates, out_k, out_p
    torch.cuda.empty_cache()
    return row


def phase_k1_shapes(torch, evaluate_shape):
    """K1 at the shapes the serving paths give it: the 0.25 s stereo
    windows of a 120 s restore (64 chunks x 10 windows of 11,024 steps)
    in bf16 (fast_serve) and f32, source-rate stereo's 64 chunks of
    44,100 steps, and a streaming feed of 16 streams in
    0.5 s blocks (22,048 committed steps, then 1,040 lookahead steps, both
    from a carry), and the bf16 fast-train preset's validation (64 chunks
    of 0.5 s, 11,025 steps, bf16), and evaluate's stereo evaluation (the
    8 s files' bucketed chunks of 2 s at 22.05 kHz, `evaluate_shape` =
    (T, B) from the files phase), and a shard of the default 120 s restore
    under a 2-entry mesh (B=32) and the largest of a 3-entry one (B=22),
    and the whole-file walk of sequence-parallel serving (_k1_whole_file).
    Returns the rows by path."""
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
            ("stream_lookahead", 1040, 16, torch.float32, True),
            ("train_bf16_validation", 11025, 64, torch.bfloat16, False),
            ("evaluate_stereo", *evaluate_shape, torch.float32, False),
            ("serve_mesh_2", 88200, 32, torch.float32, False),
            ("serve_mesh_3", 88200, 22, torch.float32, False))):
        rows[path] = _k1_at(torch, L, path, t, b, dtype, carry, floor_ns,
                            seed=10 + i)
    rows["serve_seq_whole_file"] = _k1_whole_file(torch, L, floor_ns,
                                                  seed=30)
    return rows


def _timed_restore(torch, L, pipe, clip, rate):
    """(output, wall s, K1 launches, peak bytes) of one restore, the counts
    (the conv epilogue's too, for _note_epilogue) set to 0 just before it
    and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L.reset_launch_count()
    _reset_epilogue()
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
        _bucket, _framing, apply_stereo, stereo_sub_cfg)

    cfg = pipe.config
    chunk, hop, overlap = _framing(cfg, rate)
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
    _note_epilogue("serve_fast")
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
        _note_epilogue(f"serve_{name}")
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
        _reset_epilogue()
        t0 = time.perf_counter()
        outs[name] = fn()
        torch.cuda.synchronize()
        runs[name] = (None, time.perf_counter() - t0, L.launch_count)
        _note_epilogue("serve_many" if name == "restore_many"
                       else "serve_many_single")
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
        _reset_epilogue()
        t0 = time.perf_counter()
        written = pipe.restore_directory(os.path.join(root, "in"),
                                         os.path.join(root, "out"),
                                         coalesce=4)
        dir_wall = time.perf_counter() - t0
        dir_launches = L.launch_count
        _note_epilogue("serve_many_directory")
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
    _reset_epilogue()
    t0 = time.perf_counter()
    got, feed_ms, calls = _feed_all(s, blocks)
    wall = time.perf_counter() - t0
    launches = L.launch_count
    _note_epilogue("stream")

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


# --------------------------------------------------------------- int8 phase
H100_INT8_OPS = 1979e12  # int8 operands, dense, on the tensor cores (same)
INT8_STREAM_SECONDS = 10.0
INT8_REL = 0.05  # int8 vs f32, mean |difference| over mean |f32| (JAX
#                  tests/test_quant.py's bar for its int8 pipeline)


@contextlib.contextmanager
def _int8_capture(calls):
    """Record every int8 conv call as (layer, x, weight, kwargs): ops/
    quant.py's executor names the layer, its int8_conv the call."""
    from ml_audio_restoration_torch.ops import quant

    make, conv, layer = quant.int8_exec, quant.int8_conv, [None]

    def named_exec(x_scale, cache=None, key=None):
        ex = make(x_scale, cache, key)

        def _exec(xq, kernel, **kw):
            layer[0] = key
            return ex(xq, kernel, **kw)
        return _exec

    def recording(x, weight, **kw):
        calls.append((layer[0], x, weight, kw))
        return conv(x, weight, **kw)

    quant.int8_exec, quant.int8_conv = named_exec, recording
    try:
        yield calls
    finally:
        quant.int8_exec, quant.int8_conv = make, conv


def _int8_signature(x, weight, kw):
    add = kw.get("add")
    return (tuple(x.shape), weight.shape, kw["stride"], kw["lhs_dilation"],
            tuple(kw["padding"]), None if add is None else str(add.dtype)[6:],
            kw.get("act"), "s8" if kw.get("out_inv") is not None
            else str(kw.get("out_dtype", "float32")).replace("torch.", ""))


def _int8_check_rows(torch, calls, rows: int = 2):
    """Kernel against plain version on the first `rows` batch rows of each
    distinct layer call: (layers checked, all equal bit for bit)."""
    from ml_audio_restoration_torch.ops import int8_conv as ic

    seen, equal = {}, True
    for layer, x, weight, kw in calls:
        sig = _int8_signature(x, weight, kw)
        if sig in seen:
            continue
        part = dict(kw)
        if part.get("add") is not None:
            part["add"] = part["add"][:rows]
        got = ic.int8_conv(x[:rows], weight, **part)
        want = ic.int8_conv_plain(x[:rows], weight, **part)
        same = torch.equal(got.view(torch.int8) if got.dtype == torch.int8
                           else got.float(),
                           want.view(torch.int8) if want.dtype == torch.int8
                           else want.float())
        seen[sig] = layer
        equal &= same
        if not same:
            emit({"phase": "int8_mismatch", "layer": layer,
                  "signature": [str(s) for s in sig]})
    return seen, equal


def _int8_path(x, weight, kw):
    """The kernel's path for one int8 conv call (ops/int8_conv.py::plan)."""
    from ml_audio_restoration_torch.ops import int8_conv as ic

    return ic.plan(x.shape, weight.shape, kw["stride"], kw["lhs_dilation"],
                   kw["padding"]).path


def _int8_paths_ok(calls):
    """Every call with Cin % 16 == 0 plans wgmma, every Cin-1 stem plans
    stem, none generic: (all so, {path: calls})."""
    by_path = dict.fromkeys(("wgmma", "stem", "generic"), 0)
    ok = True
    for _, x, weight, kw in calls:
        path = _int8_path(x, weight, kw)
        by_path[path] += 1
        cin = x.shape[2]
        ok &= path == ("wgmma" if cin % 16 == 0 else "stem" if cin == 1
                       else "generic") and path != "generic"
    return ok, by_path


def _int8_program_ms(torch, calls):
    """The kernel's device ms over a program's int8 conv calls (each
    distinct layer timed once at its batch, times its count) and each
    layer's (name, count, path, ms)."""
    from ml_audio_restoration_torch.ops import int8_conv as ic

    distinct = {}
    for layer, x, weight, kw in calls:
        distinct.setdefault(_int8_signature(x, weight, kw),
                            [[], x, weight, kw])[0].append(layer)
    rows = []
    for names, x, weight, kw in distinct.values():
        ms = _cuda_ms(torch, lambda: ic.int8_conv(x, weight, **kw), 5)
        rows.append({"layer": names[0], "count": len(names),
                     "path": _int8_path(x, weight, kw), "ms": ms})
    return sum(r["ms"] * r["count"] for r in rows), rows


def _int8_work(x, weight, kw, t_out):
    """(bytes, operations) the layer must move and do: each input read
    once, each output written once; the multiply-adds of the taps that land
    on real input samples (lhs dilation and padding read zeros)."""
    n, t_in, cin = x.shape
    kp, _, cout = weight.shape
    s, d, (lo, _) = kw["stride"], kw["lhs_dilation"], kw["padding"]
    span = (t_in - 1) * d + 1
    u = (np.arange(t_out)[:, None] * s + np.arange(kp)[None, :] - lo)
    taps = int(((u >= 0) & (u < span) & (u % d == 0)).sum())
    out_item = 1 if kw.get("out_inv") is not None else (
        2 if kw.get("out_dtype") is not None
        and "bfloat16" in str(kw["out_dtype"]) else 4)
    add = kw.get("add")
    n_bytes = (x.numel() + kp * cin * cout + 4 * 4 * cout
               + n * t_out * cout * out_item
               + (0 if add is None else add.numel() * add.element_size()))
    return n_bytes, 2.0 * n * taps * cin * cout


def _int8_dilated(torch, x, kw, kp, dtype):
    """The packed layer's input as the float conv reads it: NCW in `dtype`,
    zeros inserted and padded (a negative pad crops)."""
    import torch.nn.functional as F

    d, (lo, hi) = kw["lhs_dilation"], kw["padding"]
    v = x.permute(0, 2, 1).to(dtype)
    if d > 1:
        z = v.new_zeros((v.shape[0], v.shape[1], (v.shape[2] - 1) * d + 1))
        z[..., ::d] = v
        v = z
    return F.pad(v, (lo, hi))


def _int8_library(torch, x, weight, kw, t_out):
    """torch._int_mm over an im2col of the same input, then the epilogue in
    torch ops: (median ms of 3 calls, max |difference| from the kernel's
    output), or (None, why) where its shape rules or memory refuse."""
    from ml_audio_restoration_torch.ops import int8_conv as ic

    kp, cin, cout = weight.shape
    n = x.shape[0]
    k = kp * cin
    if cout % 8 or k % 8 or n * t_out * k > 2 ** 32:
        return None, "shape or memory"
    w2 = weight.wq.reshape(k, cout).contiguous()
    s = kw["stride"]

    def run():
        xd = _int8_dilated(torch, x, kw, kp, torch.int8)  # [N, Cin, T']
        cols = xd.unfold(2, kp, s)[:, :, :t_out]          # [N, Cin, T, kp]
        cols = cols.permute(0, 2, 3, 1).reshape(n * t_out, k)
        acc = torch._int_mm(cols, w2).reshape(n, t_out, cout)
        return ic._epilogue_plain(acc, weight, kw.get("add"),
                                  kw.get("add_scale"), kw.get("act"),
                                  kw.get("out_inv"),
                                  kw.get("out_dtype", torch.float32))
    try:
        out = run()
        return _cuda_ms(torch, run, 3), out
    except RuntimeError as e:
        return None, str(e)[:120]


def _int8_layer_row(torch, names, x, weight, kw):
    """One distinct layer at the full batch: the kernel timed beside its
    bound, the plain version, the library route and cuDNN's f32 and bf16
    conv of the same packed layer."""
    import torch.nn.functional as F
    from ml_audio_restoration_torch.ops import int8_conv as ic

    kp, cin, cout = weight.shape
    run = lambda: ic.int8_conv(x, weight, **kw)  # noqa: E731
    out = run()
    t_out = out.shape[1]
    ms = _cuda_ms(torch, run, 5)
    path = _int8_path(x, weight, kw)
    plain_ms, plain = _timed_once(torch, lambda: ic.int8_conv_plain(
        x, weight, **kw))
    err = float((out.float() - plain.float()).abs().max())
    del plain
    n_bytes, ops = _int8_work(x, weight, kw, t_out)
    bound_ms, bound_by = _bound(n_bytes, ops, H100_INT8_OPS)
    library_ms, lib = _int8_library(torch, x, weight, kw, t_out)
    lib_equal = (bool(torch.equal(lib.float(), out.float()))
                 if library_ms is not None else lib)
    del lib, out
    cudnn = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xd = _int8_dilated(torch, x, kw, kp, dt)
        w = weight.wq.permute(2, 1, 0).to(dt).contiguous()
        conv = lambda: F.conv1d(xd, w, stride=kw["stride"])  # noqa: E731
        conv()
        cudnn[name] = _cuda_ms(torch, conv, 3)
        del xd
    torch.cuda.empty_cache()
    return {"layer": names[0], "layers": names, "count": len(names),
            "path": path, "x": list(x.shape),
            "kernel": list(weight.shape), "stride": kw["stride"],
            "lhs_dilation": kw["lhs_dilation"],
            "padding": list(kw["padding"]), "t_out": t_out,
            "add": None if kw.get("add") is None else str(
                kw["add"].dtype)[6:], "act": kw.get("act"),
            "out": "s8" if kw.get("out_inv") is not None else str(
                kw.get("out_dtype", torch.float32))[6:],
            "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bytes": n_bytes, "ops": ops, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_equal": lib_equal, "cudnn_f32_ms": cudnn["f32"],
            "cudnn_bf16_ms": cudnn["bf16"]}


def _int8_stage_fns(torch, pipe, chunk, rate):
    """The int8 program's three stages as callables on NWC chunks, with the
    stereo stage as the pipeline runs it (int8 on whole windows, float on
    sub-chunked ones)."""
    from ml_audio_restoration_torch.models import denoiser as dmod
    from ml_audio_restoration_torch.models import super_resolution as smod
    from ml_audio_restoration_torch.pipeline.restore import (
        apply_stereo, stereo_sub_cfg)

    cfg = pipe.config
    dn, sr, st = pipe._models()
    ctx = lambda stage: pipe._int8.ctx(  # noqa: E731
        stage, cfg.int8_scope, cfg.compute_dtype, pipe.device)
    q_dn, q_sr = ctx("denoiser"), ctx("super_resolution")
    sub = stereo_sub_cfg(cfg, chunk * 2, 2, sample_rate=rate)
    q_st = ctx("stereo") if sub is None else None

    def stereo(v):
        v = v.float() if q_st is not None else v
        return apply_stereo(st, v.permute(0, 2, 1), sub,
                            q=q_st).permute(0, 2, 1)

    return (("denoiser", lambda v: dmod.apply_packed(dn, v, q=q_dn)),
            ("super_resolution", lambda v: smod.apply_packed(sr, v, q=q_sr)),
            ("stereo", stereo))


def _int8_stages(torch, pipe, clip, rate, capture: bool):
    """Device ms of each stage over the clip's chunk batch (median of 3),
    the int8 conv launches of each, and, with `capture`, every int8 conv
    call of the program."""
    from ml_audio_restoration_torch.ops import frame_structured, num_chunks
    from ml_audio_restoration_torch.ops import int8_conv as ic
    from ml_audio_restoration_torch.pipeline.restore import _bucket, _framing

    chunk, hop, _ = _framing(pipe.config, rate)
    n = _bucket(num_chunks(clip.shape[1], chunk, hop))
    total = (n - 1) * hop + chunk
    audio = torch.nn.functional.pad(torch.from_numpy(clip).to(pipe.device),
                                    (0, total - clip.shape[1]))
    dtype = getattr(torch, pipe.config.compute_dtype)
    stage_ms, launches, calls = {}, {}, []
    with torch.inference_mode():
        x = frame_structured(audio, n, chunk, hop).to(dtype)  # [n, chunk, 1]
        for name, fn in _int8_stage_fns(torch, pipe, chunk, rate):
            x_in = x
            stage_ms[name] = _cuda_ms(torch, lambda: fn(x_in), 3)
            ic.reset_launch_count()
            if capture:
                mine = []
                with _int8_capture(mine):
                    x = fn(x_in)
                calls += [(f"{name}:{layer}", *rest) for layer, *rest in mine]
            else:
                x = fn(x_in)
            torch.cuda.synchronize()
            launches[name] = ic.launch_count
    return stage_ms, launches, calls


def _timed_int8_restore(torch, L, ic, pipe, clip, rate):
    """(output, wall s, K1 launches, int8 conv launches) of one restore,
    the counts (the conv epilogue's too, for _note_epilogue) set to 0 just
    before it and read just after."""
    torch.cuda.synchronize()
    L.reset_launch_count()
    ic.reset_launch_count()
    _reset_epilogue()
    t0 = time.perf_counter()
    y, _ = pipe.restore(clip, rate)
    torch.cuda.synchronize()
    return y, time.perf_counter() - t0, L.launch_count, ic.launch_count


def _snr_db(ref, y) -> float:
    err = float(((y.float() - ref.float()) ** 2).sum())
    return 10.0 * np.log10(float((ref.float() ** 2).sum()) / max(err, 1e-30))


def _int8_streams(torch, dn, sr, st, rate):
    """16 lockstep int8 streams on one preloaded scales dict (from a
    restorer that calibrated on stream 0's first window) against 16 float
    streams, and two of them against single int8 streams."""
    from ml_audio_restoration_torch.ops import int8_conv as ic
    from ml_audio_restoration_torch.pipeline import StreamingRestorer

    b = 16
    block = int(0.5 * rate)
    streams = np.concatenate([_clip(INT8_STREAM_SECONDS, rate, seed=400 + i)
                              for i in range(b)])
    blocks = [streams[:, o:o + block]
              for o in range(0, streams.shape[1], block)]
    calib = StreamingRestorer(dn, sr, st, quantize_int8=True)
    calib.feed(blocks[0][0])
    calib.feed(blocks[1][0])
    scales = calib._int8.scales
    runs = {}
    for name, kw in (("int8", {"quantize_int8": True,
                               "int8_scales": scales}), ("float", {})):
        s = StreamingRestorer(dn, sr, st, batch=b, **kw)
        s.warmup(block)
        ic.reset_launch_count()
        out, feed_ms, calls = _feed_all(s, blocks)
        runs[name] = (out, statistics.median(feed_ms), _slowest(calls),
                      dict(ic.launch_count_by_path))
    got, ref = runs["int8"][0], runs["float"][0]
    vs_single = 0.0
    for i in (0, b - 1):
        one = _feed_all(StreamingRestorer(dn, sr, st, quantize_int8=True,
                                          int8_scales=scales),
                        [x[i] for x in blocks])[0]
        vs_single = max(vs_single, float(np.abs(got[i] - one[0]).max()))
    err = float(((got - ref) ** 2).sum())
    return {"streams": b, "seconds": INT8_STREAM_SECONDS,
            "block_s": block / rate, "shape": list(got.shape),
            "finite": bool(np.isfinite(got).all()),
            "calibrated_stages": sorted(scales),
            "int8_feed_ms_median": runs["int8"][1],
            "int8_conv_launches_by_path": runs["int8"][3],
            "float_feed_ms_median": runs["float"][1],
            "int8_slowest_call": runs["int8"][2][0],
            "int8_new_windows_after_warmup": runs["int8"][2][1],
            "int8_vs_float_max_abs": float(np.abs(got - ref).max()),
            "int8_vs_float_snr_db": 10.0 * np.log10(
                float((ref ** 2).sum()) / max(err, 1e-30)),
            "batch_vs_single_max_abs": vs_single, "batch_tol": MANY_TOL}


def phase_int8(torch):
    """int8 serving at full width on the 120 s clip: the kernel against its
    plain version at every distinct int8 layer (default and full scope, and
    the bf16 preset's), each default layer timed at the full batch, the
    int8 restore against f32 and fast_serve, the plain-conv restore, card
    vs CPU, a scales file round trip, config/fast_serve_int8.yaml, one
    full-scope restore and 16 int8 streams. Returns the kernels-line row's
    numbers."""
    import dataclasses

    from ml_audio_restoration_torch.config import PipelineConfig, load_config
    from ml_audio_restoration_torch.ops import int8_conv as ic
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.pipeline import RestorationPipeline

    dev = torch.device("cuda")
    dn, sr, st = _models(torch, dev)
    rate, seconds = 22050, 120.0
    clip = _clip(seconds, rate, seed=3)
    pipe = RestorationPipeline(dn, sr, st,
                               config=PipelineConfig(quantize_int8=True))
    t0 = time.perf_counter()
    pipe.calibrate_int8(clip, rate)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    pipe.restore(clip, rate)  # the kernels built, cuDNN's algorithms picked
    y8, wall8, k1, launches = _timed_int8_restore(torch, L, ic, pipe, clip,
                                                  rate)
    _note_epilogue("int8")
    by_path = dict(ic.launch_count_by_path)
    version = pipe._int8.version
    with ic.plain_int8_conv():
        t0 = time.perf_counter()
        y_plain, _ = pipe.restore(clip, rate)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    plain_equal = bool(torch.equal(y8, y_plain))
    del y_plain
    f32 = RestorationPipeline(dn, sr, st)
    f32.restore(clip, rate)
    y32, wall32, _, _ = _timed_int8_restore(torch, L, ic, f32, clip, rate)
    fast_cfg = load_config(os.path.join(ROOT, "config",
                                        "fast_serve.yaml")).pipeline
    fast = RestorationPipeline(dn, sr, st, config=fast_cfg)
    fast.restore(clip, rate)
    _, wall_fast, _, _ = _timed_int8_restore(torch, L, ic, fast, clip, rate)

    # stage split and every int8 layer of the 64-chunk program
    stage_ms, stage_launches, calls = _int8_stages(torch, pipe, clip, rate,
                                                   capture=True)
    stage_ms32 = {}
    from ml_audio_restoration_torch.ops import frame_structured, num_chunks
    from ml_audio_restoration_torch.pipeline.restore import _bucket, _framing
    chunk, hop, _ = _framing(pipe.config, rate)
    n = _bucket(num_chunks(clip.shape[1], chunk, hop))
    audio = torch.nn.functional.pad(torch.from_numpy(clip).to(dev), (
        0, (n - 1) * hop + chunk - clip.shape[1]))
    with torch.inference_mode():
        x = frame_structured(audio, n, chunk, hop).permute(0, 2, 1)
        for name, fn in (("denoiser", dn), ("super_resolution", sr),
                         ("stereo", st)):
            x_in = x
            stage_ms32[name] = _cuda_ms(torch, lambda: fn(x_in), 3)
            x = fn(x_in)
    del x, x_in, audio
    distinct = {}  # signature -> [layer names, x, weight, kwargs]
    for layer, x, weight, kw in calls:
        distinct.setdefault(_int8_signature(x, weight, kw),
                            [[], x, weight, kw])[0].append(layer)
    checked, equal = _int8_check_rows(torch, calls)
    paths_ok, plan_paths = _int8_paths_ok(calls)
    layers = [_int8_layer_row(torch, names, x, weight, kw)
              for names, x, weight, kw in distinct.values()]
    del calls, distinct
    torch.cuda.empty_cache()
    for row in layers:
        emit({"phase": "int8_layer", **row})
    total = lambda key: sum(r[key] * r["count"] for r in layers)  # noqa
    lib_rows = [r for r in layers if r["library_ms"] is not None]

    # full scope on the same scales: its new layers checked, one restore
    full = RestorationPipeline(dn, sr, st, config=PipelineConfig(
        quantize_int8=True, int8_scope="full"))
    full._int8.set(pipe._int8.scales)
    small = _clip(4.0, rate, seed=2)
    full_calls = []
    with _int8_capture(full_calls):
        full.restore(small, rate)
    full_checked, full_equal = _int8_check_rows(torch, full_calls)
    del full_calls
    full.restore(clip, rate)
    y_full, wall_full, k1_full, launches_full = _timed_int8_restore(
        torch, L, ic, full, clip, rate)
    full_by_path = dict(ic.launch_count_by_path)
    _, _, full_calls = _int8_stages(torch, full, clip, rate, capture=True)
    full_paths_ok, full_plan_paths = _int8_paths_ok(full_calls)
    full_ms, full_layers = _int8_program_ms(torch, full_calls)
    del full_calls
    torch.cuda.empty_cache()

    # card vs CPU on a 4 s clip, the same scales
    cpu = RestorationPipeline(*(m.to("cpu") for m in _models(torch, dev)),
                              config=PipelineConfig(quantize_int8=True),
                              device="cpu")
    cpu._int8.set(pipe._int8.scales)
    y_card, _ = pipe.restore(small, rate)
    y_card32, _ = f32.restore(small, rate)
    y_cpu, _ = cpu.restore(small, rate)
    own_dev = _max_dev(y_card, y_card32)
    card_cpu = _max_dev(y_card.cpu(), y_cpu)
    rms = lambda d: float(d.float().square().mean().sqrt())  # noqa: E731
    own_rms = rms(y_card - y_card32)
    card_cpu_rms = rms(y_card.cpu() - y_cpu)
    del cpu, y_cpu
    # the same on the mono chain (denoiser + SR, no stereo stage)
    mono = {}
    for where, models in (("card", (dn, sr)), ("cpu", tuple(
            m.to("cpu") for m in _models(torch, dev)[:2]))):
        m_pipe = RestorationPipeline(*models, config=PipelineConfig(
            quantize_int8=True), device=next(models[0].parameters()).device)
        m_pipe._int8.set({k: v for k, v in pipe._int8.scales.items()
                          if k != "stereo"})
        mono[where] = m_pipe.restore(small, rate)[0]
    mono_f32, _ = RestorationPipeline(dn, sr).restore(small, rate)
    mono_ratio = (_max_dev(mono["card"].cpu(), mono["cpu"])
                  / _max_dev(mono["card"], mono_f32))
    del mono, mono_f32

    # the scales file: save, a fresh pipeline loads it, equal bit for bit
    path = os.path.join(ROOT, "profiles", "chip_smoke_int8_scales.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        pipe.save_int8_scales(path)
        fresh = RestorationPipeline(dn, sr, st, config=PipelineConfig(
            quantize_int8=True))
        fresh.load_int8_scales(path)
        v_fresh = fresh._int8.version
        y_fresh, _ = fresh.restore(clip, rate)
        file_equal = bool(torch.equal(y_fresh, y8))
        recalibrated = fresh._int8.version != v_fresh
    finally:
        if os.path.exists(path):
            os.remove(path)
    del y_fresh, fresh

    # the shipped preset: bf16, 0.25 s stereo windows (stereo stays float)
    preset_cfg = load_config(os.path.join(
        ROOT, "config", "fast_serve_int8.yaml")).pipeline
    preset = RestorationPipeline(dn, sr, st, config=preset_cfg)
    preset.restore(clip, rate)  # calibrates, then warm
    k1_shapes = []
    k1_run = L._lstm_recurrence_cuda

    def k1_recording(gates, *a):
        k1_shapes.append([*gates.shape, str(gates.dtype)[6:]])
        return k1_run(gates, *a)

    L._lstm_recurrence_cuda = k1_recording
    try:
        y_p, wall_preset, k1_preset, launches_preset = _timed_int8_restore(
            torch, L, ic, preset, clip, rate)
        _note_epilogue("int8_preset")
    finally:
        L._lstm_recurrence_cuda = k1_run
    preset_by_path = dict(ic.launch_count_by_path)
    preset_stage_ms, preset_launches, preset_calls = _int8_stages(
        torch, preset, clip, rate, capture=True)
    preset_checked, preset_equal = _int8_check_rows(torch, preset_calls)
    preset_paths_ok, preset_plan_paths = _int8_paths_ok(preset_calls)
    preset_ms, preset_layers = _int8_program_ms(torch, preset_calls)
    del preset_calls
    torch.cuda.empty_cache()
    fast_y, _ = fast.restore(clip, rate)
    preset_dev = _max_dev(y_p, fast_y)
    del fast_y, y_p

    streams = _int8_streams(torch, dn, sr, st, rate)
    emit({"phase": "int8_stream", **streams})

    ref_peak = float(y32.abs().max())
    rel_mean = float((y8 - y32).abs().mean() / y32.abs().mean())
    row = {"phase": "int8", "seconds": seconds, "shape": list(y8.shape),
           "finite": bool(torch.isfinite(y8).all()),
           "calibration_s": calib_s, "wall_s": wall8, "xrt": seconds / wall8,
           "f32_xrt": seconds / wall32, "fast_serve_xrt": seconds / wall_fast,
           "stage_ms": stage_ms, "f32_stage_ms": stage_ms32,
           "int8_conv_launches_by_stage": stage_launches,
           "int8_conv_ms_by_stage": {
               s: sum(r["ms"] * r["count"] for r in layers
                      if r["layer"].startswith(s + ":"))
               for s in ("denoiser", "super_resolution", "stereo")},
           "lstm_recurrence_launches": k1,
           "int8_conv_launches": launches,
           "int8_conv_launches_by_path": by_path,
           "planned_paths": plan_paths,
           "vs_f32_max_abs": _max_dev(y8, y32),
           "vs_f32_snr_db": _snr_db(y32, y8), "f32_peak": ref_peak,
           "vs_f32_rel_mean": rel_mean, "rel_mean_tol": INT8_REL,
           "plain_conv_restore_equal": plain_equal,
           "plain_conv_restore_wall_s": plain_wall,
           "no_recalibration": pipe._int8.version == version,
           "layers_checked": len(checked), "layers_equal": equal,
           "full_scope_layers_checked": len(full_checked),
           "full_scope_layers_equal": full_equal,
           "preset_layers_checked": len(preset_checked),
           "preset_layers_equal": preset_equal,
           "card_vs_cpu_4s_max_abs": card_cpu,
           "int8_vs_f32_4s_max_abs": own_dev,
           "card_vs_cpu_max_ratio": card_cpu / own_dev,
           "card_vs_cpu_4s_rms": card_cpu_rms,
           "int8_vs_f32_4s_rms": own_rms,
           "card_vs_cpu_rms_tol": 0.25 * own_rms,
           "mono_chain_card_vs_cpu_max_ratio": mono_ratio,
           "scales_file_restore_equal": file_equal,
           "scales_file_recalibrated": recalibrated,
           "full_scope": {"xrt": seconds / wall_full,
                          "lstm_recurrence_launches": k1_full,
                          "int8_conv_launches": launches_full,
                          "int8_conv_launches_by_path": full_by_path,
                          "planned_paths": full_plan_paths,
                          "layers": full_layers,
                          "vs_f32_max_abs": _max_dev(y_full, y32),
                          "vs_f32_snr_db": _snr_db(y32, y_full)},
           "preset": {"config": "config/fast_serve_int8.yaml",
                      "xrt": seconds / wall_preset,
                      "fast_serve_xrt": seconds / wall_fast,
                      "lstm_recurrence_launches": k1_preset,
                      "k1_calls": k1_shapes,
                      "int8_conv_launches": launches_preset,
                      "int8_conv_launches_by_path": preset_by_path,
                      "planned_paths": preset_plan_paths,
                      "layers": preset_layers,
                      "int8_conv_launches_by_stage": preset_launches,
                      "stage_ms": preset_stage_ms,
                      "vs_fast_serve_max_abs": preset_dev},
           "program_kernel_ms": total("ms"),
           "program_kernel_ms_full": full_ms,
           "program_kernel_ms_fast_serve_int8": preset_ms,
           "program_plain_ms": total("plain_ms"),
           "program_bound_ms": total("bound_ms"),
           "program_cudnn_f32_ms": total("cudnn_f32_ms"),
           "program_cudnn_bf16_ms": total("cudnn_bf16_ms"),
           "library_layers": [r["layer"] for r in lib_rows],
           "library_ms": sum(r["library_ms"] * r["count"] for r in lib_rows),
           "kernel_ms_on_library_layers": sum(r["ms"] * r["count"]
                                              for r in lib_rows)}
    emit(row)
    # every Cin % 16 == 0 layer on wgmma, the three stems on stem
    paths = (paths_ok and full_paths_ok and preset_paths_ok
             and by_path == {"wgmma": 32, "stem": 3, "generic": 0}
             and full_by_path == {"wgmma": 46, "stem": 3, "generic": 0}
             and preset_by_path == {"wgmma": 21, "stem": 2, "generic": 0}
             and by_path == plan_paths and full_by_path == full_plan_paths
             and preset_by_path == preset_plan_paths
             and all(r["path"] == "wgmma" for r in layers
                     if r["x"][2] % 16 == 0))
    ok = (row["finite"] and tuple(y8.shape) == (2, 2 * clip.shape[1])
          and k1 == 1 and launches == 35 and equal and full_equal
          and launches_full == 49 and launches_preset == 23 and paths
          and preset_equal and plain_equal and row["no_recalibration"]
          and all(r["max_abs_err"] == 0.0 for r in layers)
          and card_cpu_rms <= 0.25 * own_rms and file_equal
          and not recalibrated
          and k1_preset == 1 and k1_shapes == [[11024, 640, 256, "bfloat16"]]
          and preset_launches["stereo"] == 0
          and preset_launches["denoiser"] > 0
          and streams["finite"] and streams["batch_vs_single_max_abs"]
          <= MANY_TOL and not streams["int8_new_windows_after_warmup"]
          and rel_mean <= INT8_REL)
    if not ok:
        raise AssertionError(f"int8 serving failed: {row}")
    bound_by = ("bytes" if sum(r["bound_ms"] * r["count"] for r in layers
                               if r["bound_by"] == "bytes")
                >= total("bound_ms") / 2 else "operations")
    return {"launches": launches, "launches_by_path": by_path,
            "k1_launches": k1,
            "k1_preset_launches": k1_preset,
            "max_abs_err": max(r["max_abs_err"] for r in layers),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"), "bound_by": bound_by,
            # torch._int_mm takes only some of the layers (each layer's
            # figure is in `shapes`), so no one call covers the program
            "library_ms": (row["library_ms"] if len(lib_rows) == len(layers)
                           else None),
            "layers": layers}


# -------------------------------------------------------------- serve phase
SERVE_SECONDS = 30.0   # the solo request and each stream
SERVE_CLIENTS = 8      # concurrent HTTP clients
SERVE_REQUESTS = 24    # their requests, 5-60 s each (seeded)
SERVE_STREAMS = 16     # lockstep TCP streams (the restorer's batch)
INT8_SERVE_SECONDS = 10.0  # the int8 daemon's request


def _serve_body(clip, rate):
    from ml_audio_restoration_torch.audio import encode_wav

    return encode_wav(clip[0][:, None], rate, subtype="FLOAT")


def _serve_post(srv, body):
    from ml_audio_restoration_torch.pipeline.server import restore_over_http

    return restore_over_http(srv.host, srv.port, body, subtype="FLOAT",
                             timeout=300)


def _served_want(pipe, clip, rate):
    """What the daemon must answer: restore_file's contract on the host
    (input normalization, restore, output normalization)."""
    from ml_audio_restoration_torch.audio import normalize_audio

    y, _ = pipe.restore(np.asarray(normalize_audio(clip)), rate)
    return np.asarray(normalize_audio(y.cpu().numpy()), np.float32)


def _serve_host_split(body, restored):
    """Host ms (median of 5) of the daemon's own work on one response:
    the handler's decode and normalization of the body, normalization and
    FLOAT WAV encoding of the output, and the client's decode of it."""
    from ml_audio_restoration_torch.audio import (decode_wav, encode_wav,
                                                  normalize_audio)

    def ms(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    data, rate = decode_wav(body)
    out = normalize_audio(restored)
    wav = encode_wav(out.T, 2 * rate, subtype="FLOAT")
    return {"decode_body": ms(lambda: decode_wav(body)),
            "normalize_in": ms(lambda: normalize_audio(data.T)),
            "normalize_out": ms(lambda: normalize_audio(restored)),
            "encode_out": ms(lambda: encode_wav(out.T, 2 * rate,
                                                subtype="FLOAT")),
            "client_decode": ms(lambda: decode_wav(wav))}


def _serve_concurrent(torch, L, srv, pipe, rate):
    """SERVE_CLIENTS threads send SERVE_REQUESTS requests of seeded lengths;
    each response against its solo restore. Counts set to 0 just before."""
    import json
    import threading
    import urllib.request

    lengths = np.random.default_rng(410).uniform(5.0, 60.0, SERVE_REQUESTS)
    clips = [_clip(float(s), rate, seed=420 + i)
             for i, s in enumerate(lengths)]
    bodies = [_serve_body(c, rate) for c in clips]
    results, lat = [None] * len(clips), [None] * len(clips)
    errors = []
    todo = iter(range(len(clips)))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                i = next(todo, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                results[i] = _serve_post(srv, bodies[i])
            except Exception as e:  # reported with the row, fails the run
                errors.append(repr(e))
                return
            lat[i] = time.perf_counter() - t0

    def stats():
        return json.load(urllib.request.urlopen(
            f"http://{srv.host}:{srv.port}/v1/stats", timeout=60))

    before = stats()
    torch.cuda.synchronize()
    L.reset_launch_count()
    _reset_epilogue()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client)
               for _ in range(SERVE_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = L.launch_count
    _note_epilogue("serve_http_concurrent")
    after = stats()
    dev = max((float(np.abs(r[0] - _served_want(pipe, c, rate)).max())
               if r is not None and r[0].shape == (2, 2 * c.shape[1])
               else float("inf")) for r, c in zip(results, clips))
    done = [x for x in lat if x is not None]
    audio_s = float(sum(c.shape[1] for c in clips)) / rate
    return {"requests": len(clips), "clients": SERVE_CLIENTS,
            "audio_s": audio_s, "errors": errors,
            "alive_threads": sum(th.is_alive() for th in threads),
            "wall_s": wall, "xrt": audio_s / wall,
            "latency_s_p50": float(np.percentile(done, 50)) if done else None,
            "latency_s_p95": float(np.percentile(done, 95)) if done else None,
            "coalesced": after["coalesced"] - before["coalesced"],
            "busy_seconds": after["busy_seconds"] - before["busy_seconds"],
            "lstm_recurrence_launches": launches,
            "vs_solo_max_abs": dev, "tol": MANY_TOL}


def _serve_reload(models, paths, clip, rate, dtype):
    """A daemon over `models` in `dtype` serves `clip`, reloads `paths`
    over HTTP and serves it again: the answer must equal a fresh pipeline
    on the files and differ from the first."""
    import json
    import urllib.request

    from ml_audio_restoration_torch.config import PipelineConfig
    from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                     RestorationServer)

    cfg = PipelineConfig(compute_dtype=dtype)
    pipe = RestorationPipeline(*models, config=cfg)
    body = _serve_body(clip, rate)
    with RestorationServer(pipe, request_timeout=300) as srv:
        before, _ = _serve_post(srv, body)
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/v1/reload",
            data=json.dumps(paths).encode(), method="POST")
        reloaded = json.load(urllib.request.urlopen(req, timeout=300))
        after, _ = _serve_post(srv, body)
    fresh = RestorationPipeline.from_checkpoints(
        denoiser_path=paths["denoiser"],
        super_res_path=paths["super_resolution"],
        stereo_path=paths["stereo"], config=cfg)
    want = _served_want(fresh, clip, rate)
    on_card = all(p.device.type == "cuda" for m in (
        pipe.denoiser, pipe.super_resolution, pipe.stereo)
        for p in m.parameters())
    return {"dtype": dtype, "reloaded": reloaded["reloaded"],
            "equal_to_fresh": bool(np.array_equal(after, want)),
            "differs_from_old": not np.array_equal(before, after),
            "stages_on_card": on_card}


def _pcm_exchange(sock, samples, block: int, channels: int):
    """stream_over_tcp's exchange on a connected socket: a writer thread
    sends f32le blocks and half-closes while this thread reads the
    restored interleaved PCM until EOF -> [channels, T_out]."""
    import socket
    import threading

    payload = np.asarray(samples, "<f4").tobytes()

    def write():
        for off in range(0, len(payload), 4 * block):
            sock.sendall(payload[off:off + 4 * block])
        sock.shutdown(socket.SHUT_WR)

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    chunks = []
    while True:
        buf = sock.recv(1 << 16)
        if not buf:
            break
        chunks.append(buf)
    writer.join(timeout=300)
    sock.close()
    return np.frombuffer(b"".join(chunks), "<f4").reshape(-1, channels).T


def _serve_streams(torch, L, models, http, rate):
    """SERVE_STREAMS TCP clients of SERVE_SECONDS each through StreamServer
    (offline mode) against a direct restorer fed the same blocks; one
    WebSocket stream through `http` against its TCP twin. Every client
    connects before any sends, so all join on the first tick: a slot that
    joins a running clock equals a fresh restorer fed the zero gap before
    its samples (StreamingRestorer.reset_stream), which the stereo LSTM
    does not forget at once."""
    import socket
    import threading

    from ml_audio_restoration_torch.pipeline import (StreamingRestorer,
                                                     StreamServer)
    from ml_audio_restoration_torch.pipeline.server import stream_over_tcp
    from ml_audio_restoration_torch.pipeline.ws import stream_over_ws

    b = SERVE_STREAMS
    client_block = int(0.5 * rate)
    restorer = StreamingRestorer(*models, batch=b)
    streams = np.concatenate([_clip(SERVE_SECONDS, rate, seed=500 + i)
                              for i in range(b)])
    feed_ms = []
    with StreamServer(restorer, block=client_block) as srv:
        block = srv.block  # the client's block on the pooling grid
        warm = restorer.warmup(block)
        feed = restorer.feed

        def timed_feed(x):  # the clock thread's feeds, on the host clock
            t0 = time.perf_counter()
            out = feed(x)
            feed_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        restorer.feed = timed_feed
        outs = [None] * b
        socks = [socket.create_connection((srv.host, srv.port), timeout=300)
                 for _ in range(b)]
        deadline = time.monotonic() + 60
        while (srv.stats()["active_streams"] < b
               and time.monotonic() < deadline):
            time.sleep(0.01)

        def client(i):
            outs[i] = _pcm_exchange(socks[i], streams[i], client_block, 2)

        torch.cuda.synchronize()
        L.reset_launch_count()
        _reset_epilogue()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(b)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = L.launch_count
        _note_epilogue("serve_streams")
        ticks = srv.stats()["ticks"]
        restorer.feed = feed
        # one WebSocket stream through the HTTP daemon and its TCP twin
        http.stream_addr = (srv.host, srv.port)
        twin = streams[0][:int(10.0 * rate)]
        got_ws = stream_over_ws(http.host, http.port, twin,
                                block=client_block, channels=2, timeout=300)
        got_tcp = stream_over_tcp(srv.host, srv.port, twin,
                                  block=client_block, channels=2,
                                  timeout=300)
        http.stream_addr = None
    direct = StreamingRestorer(*models, batch=b)
    direct.warmup(block)
    t_d = time.perf_counter()
    want, direct_ms, _ = _feed_all(
        direct, [streams[:, o:o + block]
                 for o in range(0, streams.shape[1], block)])
    direct_wall = time.perf_counter() - t_d
    n = 2 * streams.shape[1]
    dev = max((float(np.abs(o - want[i][:, :n]).max())
               if o is not None and o.shape == (2, n) else float("inf"))
              for i, o in enumerate(outs))
    return {"streams": b, "seconds": SERVE_SECONDS, "block": block,
            "warmup": warm, "alive_threads": sum(t.is_alive()
                                                 for t in threads),
            "wall_s": wall, "ticks": ticks,
            "feed_ms_median": statistics.median(feed_ms),
            "stream_audio_s_per_wall_s": b * SERVE_SECONDS / wall,
            "direct_feed_ms_median": statistics.median(direct_ms),
            "direct_stream_audio_s_per_wall_s": b * SERVE_SECONDS
            / direct_wall,
            "lstm_recurrence_launches": launches,
            "vs_direct_max_abs": dev, "tol": MANY_TOL,
            "ws_shape": list(got_ws.shape),
            "ws_equal_to_tcp": bool(got_ws.shape == got_tcp.shape
                                    == (2, 2 * twin.shape[0])
                                    and np.array_equal(got_ws, got_tcp))}


def _serve_int8(torch, L, models, root, rate):
    """A daemon with quantize_int8 calibrates on its first request; at
    shutdown `serve`'s persistence writes the scales file; a second daemon
    loads it and serves without recalibrating, bit for bit the first."""
    from ml_audio_restoration_torch.cli import _persist_int8_scales
    from ml_audio_restoration_torch.config import PipelineConfig
    from ml_audio_restoration_torch.ops import int8_conv as I8
    from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                     RestorationServer)

    path = os.path.join(root, "int8_scales.json")
    body = _serve_body(_clip(INT8_SERVE_SECONDS, rate, seed=600), rate)
    first = RestorationPipeline(*models, config=PipelineConfig(
        quantize_int8=True))
    with RestorationServer(first, request_timeout=300) as srv:
        _serve_post(srv, body)  # calibrates on this recording
        calibrated = first._int8.scales is not None
        torch.cuda.synchronize()
        L.reset_launch_count()
        I8.reset_launch_count()
        _reset_epilogue()
        got, _ = _serve_post(srv, body)
        launches = (I8.launch_count, L.launch_count)
        _note_epilogue("serve_int8")
        by_path = dict(I8.launch_count_by_path)
        rtt = []
        for _ in range(5):
            t0 = time.perf_counter()
            _serve_post(srv, body)
            rtt.append(time.perf_counter() - t0)
    _persist_int8_scales(path, first)  # what `serve` runs at shutdown
    second = RestorationPipeline(*models, config=PipelineConfig(
        quantize_int8=True))
    second.load_int8_scales(path)
    version = second._int8.version
    with RestorationServer(second, request_timeout=300) as srv:
        again, _ = _serve_post(srv, body)
    return {"calibrated": calibrated, "scales_written": os.path.exists(path),
            "recalibrated": second._int8.version != version,
            "equal_to_first": bool(np.array_equal(got, again)),
            "int8_conv_launches": launches[0],
            "int8_conv_launches_by_path": by_path,
            "seconds": INT8_SERVE_SECONDS,
            "round_trip_s_median": statistics.median(rtt),
            "lstm_recurrence_launches": launches[1]}


def _serve_cli(paths, rate, *extra):
    """`python -m ml_audio_restoration_torch serve --warmup` (and `extra`
    arguments) as a subprocess on the phase's .pth files: /healthz names a
    CUDA device, a restore and a stream succeed, and SIGTERM ends it with
    exit code 0."""
    import json
    import queue
    import re
    import signal
    import threading
    import urllib.request

    from ml_audio_restoration_torch.pipeline.server import (
        restore_over_http, stream_over_tcp)

    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "ml_audio_restoration_torch", "serve",
         "--port", "0", "--stream-port", "0", "--stream-slots", "4",
         "--warmup", "--denoiser", paths["denoiser"],
         "--super-res", paths["super_resolution"],
         "--stereo", paths["stereo"], *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines, log = queue.Queue(), []

    def pump():
        for line in proc.stdout:
            log.append(line.rstrip())
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    row = {"started_s": None}
    t0 = time.perf_counter()
    try:
        ports = {}
        deadline = time.monotonic() + 180
        while len(ports) < 2 and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=max(0.1, deadline
                                             - time.monotonic()))
            except queue.Empty:
                break
            if line is None:
                break
            for kind in ("http", "tcp"):
                m = re.search(kind + r"://[\d.]+:(\d+)", line)
                if m:
                    ports[kind] = int(m.group(1))
        row["started_s"] = time.perf_counter() - t0
        if len(ports) < 2:
            raise AssertionError(f"serve did not start: {log[-20:]}")
        health = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{ports['http']}/healthz", timeout=60))
        clip = _clip(4.0, rate, seed=700)
        got, out_rate = restore_over_http(
            "127.0.0.1", ports["http"], _serve_body(clip, rate),
            subtype="FLOAT", timeout=300)
        streamed = stream_over_tcp("127.0.0.1", ports["tcp"],
                                   clip[0][:int(2.0 * rate)],
                                   block=int(0.5 * rate), channels=2,
                                   timeout=300)
        row.update({
            "devices": health["devices"],
            "restore_shape": list(got.shape), "out_rate": out_rate,
            "restore_finite": bool(np.isfinite(got).all()),
            "stream_shape": list(streamed.shape),
            "stream_finite": bool(np.isfinite(streamed).all())})
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            row["returncode"] = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
            row["returncode"] = None
    row["ok"] = bool(
        any("cuda" in d for d in row.get("devices", []))
        and row.get("restore_shape") == [2, 2 * clip.shape[1]]
        and row.get("out_rate") == 2 * rate and row.get("restore_finite")
        and row.get("stream_shape") == [2, int(2.0 * rate) * 2]
        and row.get("stream_finite") and row["returncode"] == 0)
    if not row["ok"]:
        row["log"] = log[-20:]
    return row


def phase_serve(torch):
    """The serving daemon at full published width (seeded weights, the
    default config unless a step says otherwise), over loopback: HTTP
    solo and concurrent, hot reload in f32 and bf16, TCP and WebSocket
    streams, int8 scales persistence, and `serve` as a subprocess."""
    import shutil

    from ml_audio_restoration_torch.audio import normalize_audio
    from ml_audio_restoration_torch.compat import save_pth
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                     RestorationServer)

    dev = torch.device("cuda")
    models = _models(torch, dev)
    pipe = RestorationPipeline(*models)
    rate = pipe.config.sample_rate
    root = os.path.join(ROOT, "profiles", "chip_smoke_serve")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    row = {"phase": "serve"}
    try:
        http = RestorationServer(pipe, max_queue=2 * SERVE_CLIENTS,
                                 request_timeout=300).start()
        try:
            row["warmup"] = pipe.warmup(coalesce=4)
            # 1. one request alone
            clip = _clip(SERVE_SECONDS, rate, seed=400)
            body = _serve_body(clip, rate)
            _serve_post(http, body)
            torch.cuda.synchronize()
            L.reset_launch_count()
            _reset_epilogue()
            got, out_rate = _serve_post(http, body)
            solo_launches = L.launch_count
            _note_epilogue("serve_http_solo")
            want = _served_want(pipe, clip, rate)
            rtt, inproc = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                _serve_post(http, body)
                rtt.append(time.perf_counter() - t0)
            for _ in range(5):
                t0 = time.perf_counter()
                y, _ = pipe.restore(np.asarray(normalize_audio(clip)), rate)
                y.cpu()
                inproc.append(time.perf_counter() - t0)
            row["solo"] = {
                "host_ms": _serve_host_split(body, y.cpu().numpy()),
                "seconds": SERVE_SECONDS, "shape": list(got.shape),
                "out_rate": out_rate,
                "equal_to_restore": bool(np.array_equal(got, want)),
                "lstm_recurrence_launches": solo_launches,
                "round_trip_s_median": statistics.median(rtt),
                "in_process_s_median": statistics.median(inproc),
                "daemon_cost_s": statistics.median(rtt)
                - statistics.median(inproc)}
            emit({"phase": "serve_solo", **row["solo"]})
            # 2. concurrent clients, coalesced
            row["concurrent"] = _serve_concurrent(torch, L, http, pipe, rate)
            emit({"phase": "serve_concurrent", **row["concurrent"]})
            # 3. hot reload onto seeded files, in f32 and bf16
            new = _models(torch, dev, seed=1)
            paths = {}
            for (attr, name), m in zip(
                    (("denoiser", "denoiser"),
                     ("super_resolution", "super_resolution"),
                     ("stereo", "stereo_separator")), new):
                paths[attr] = os.path.join(root, f"{attr}.pth")
                save_pth(paths[attr], name, {k: v.cpu() for k, v in
                                             m.state_dict().items()})
            del new
            reload_clip = _clip(10.0, rate, seed=401)
            row["reload"] = [_serve_reload(models, paths, reload_clip, rate,
                                           dtype)
                             for dtype in ("float32", "bfloat16")]
            emit({"phase": "serve_reload", "runs": row["reload"]})
            # 4. lockstep streams over TCP, one over WebSocket
            row["streams"] = _serve_streams(torch, L, models, http, rate)
            emit({"phase": "serve_streams", **row["streams"]})
        finally:
            http.shutdown()
        # 5. int8 scales persistence across two daemons
        row["int8"] = _serve_int8(torch, L, models, root, rate)
        emit({"phase": "serve_int8", **row["int8"]})
        # 6. the CLI's daemon
        row["cli"] = _serve_cli(paths, rate)
        emit({"phase": "serve_cli", **row["cli"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    solo, conc = row["solo"], row["concurrent"]
    streams, int8 = row["streams"], row["int8"]
    checks = {
        "solo": (solo["shape"] == [2, 2 * clip.shape[1]]
                 and solo["equal_to_restore"]
                 and solo["lstm_recurrence_launches"] == 1),
        "concurrent": (not conc["errors"] and not conc["alive_threads"]
                       and conc["coalesced"] > 0
                       and conc["vs_solo_max_abs"] <= MANY_TOL
                       and conc["lstm_recurrence_launches"] >= 1),
        "reload": all(r["equal_to_fresh"] and r["differs_from_old"]
                      and r["stages_on_card"]
                      and r["reloaded"] == ["denoiser", "stereo",
                                            "super_resolution"]
                      for r in row["reload"]),
        "streams": (not streams["alive_threads"]
                    and streams["vs_direct_max_abs"] <= MANY_TOL
                    and streams["ws_equal_to_tcp"]
                    and streams["lstm_recurrence_launches"] >= 2),
        "int8": (int8["calibrated"] and int8["scales_written"]
                 and not int8["recalibrated"] and int8["equal_to_first"]
                 and int8["int8_conv_launches"] > 0
                 and int8["int8_conv_launches_by_path"]
                 == {"wgmma": 32, "stem": 3, "generic": 0}
                 and int8["lstm_recurrence_launches"] == 1),
        "cli": row["cli"]["ok"]}
    emit({"phase": "serve", "checks": checks,
          "solo_round_trip_s": solo["round_trip_s_median"],
          "solo_in_process_s": solo["in_process_s_median"],
          "concurrent_xrt": conc["xrt"],
          "concurrent_latency_s_p50": conc["latency_s_p50"],
          "concurrent_latency_s_p95": conc["latency_s_p95"],
          "concurrent_coalesced": conc["coalesced"],
          "concurrent_busy_seconds": conc["busy_seconds"],
          "stream_feed_ms_median": streams["feed_ms_median"],
          "stream_audio_s_per_wall_s": streams["stream_audio_s_per_wall_s"],
          "direct_feed_ms_median": streams["direct_feed_ms_median"],
          "direct_stream_audio_s_per_wall_s":
              streams["direct_stream_audio_s_per_wall_s"],
          "int8_conv_launches": int8["int8_conv_launches"],
          "int8_round_trip_s_median": int8["round_trip_s_median"]})
    if not all(checks.values()):
        raise AssertionError(f"serving daemon failed: {checks}")
    return {"serve_http_solo": (solo["lstm_recurrence_launches"], None, None),
            "serve_http_concurrent": (conc["lstm_recurrence_launches"],
                                      None, None),
            "serve_streams": (streams["lstm_recurrence_launches"], None,
                              None),
            "serve_int8": (int8["lstm_recurrence_launches"], None, None),
            "int8_conv": int8["int8_conv_launches"]}


MESH_TOL = {"atol": 2e-5, "rtol": 1e-4}  # sharded vs unsharded restore
#                     (JAX tests/test_pipeline.py:181): a shard's convs
#                     run at another batch size, cuDNN's algorithm may differ
MESH_STREAM_TOL = 1e-6  # sharded vs unsharded streams (JAX
#                     tests/test_streaming.py:229)
MESH_ENTRIES = (1, 2, 3)  # meshes of repeated cuda:0 entries
MESH_LABEL = "shards time-sharing one H100: not a scaling figure"


@contextlib.contextmanager
def _k1_shapes_seen(L):
    """Record [T, B] of every K1 launch inside the block (the launch
    itself and its count are the kernel's own)."""
    seen = []
    k1 = L._lstm_recurrence_cuda

    def spy(gates, w_hh, h0, c0):
        seen.append(list(gates.shape[:2]))
        return k1(gates, w_hh, h0, c0)

    L._lstm_recurrence_cuda = spy
    try:
        yield seen
    finally:
        L._lstm_recurrence_cuda = k1


def _mesh_restore(torch, L, pipe, clip, rate, mesh, path, reps: int = 3):
    """`pipe` under `mesh` (None: unsharded) on `clip`: one warm-up restore
    (cuDNN picks its algorithms at the shards' shapes), one counted with
    the K1 shapes of each shard (the conv epilogue's reading kept as
    `path`'s), then `reps` timed. (output, median wall s, K1 launches, K1
    [T, B] per launch)."""
    pipe.mesh = mesh
    pipe.restore(clip, rate)
    with _k1_shapes_seen(L) as shapes:
        y, _, launches, _ = _timed_restore(torch, L, pipe, clip, rate)
    _note_epilogue(path)
    walls = [_timed_restore(torch, L, pipe, clip, rate)[1]
             for _ in range(reps)]
    return y, statistics.median(walls), launches, shapes


def _mesh_bar(torch, got, want) -> dict:
    """Sharded `got` against unsharded `want` at MESH_TOL."""
    return {"max_abs": _max_dev(got, want),
            "within_bar": bool(torch.allclose(got, want, **MESH_TOL)),
            "bit_for_bit": bool(torch.equal(got, want))}


def _mesh_reload(torch, models, paths, mesh, clip, rate, dtype):
    """A pipeline over `models` on `mesh` restores `clip`, reloads `paths`
    and restores again: equal to a fresh pipeline on the files under the
    same mesh, different from before, and every device's stage models
    (`_copies`, pipeline/restore.py::StageCopies) hold the files'
    weights."""
    from ml_audio_restoration_torch.config import PipelineConfig
    from ml_audio_restoration_torch.pipeline import RestorationPipeline

    cfg = PipelineConfig(compute_dtype=dtype)
    pipe = RestorationPipeline(*models, config=cfg, mesh=mesh)
    before, _ = pipe.restore(clip, rate)
    reloaded = pipe.reload_stages(paths)
    after, _ = pipe.restore(clip, rate)
    fresh = RestorationPipeline.from_checkpoints(
        denoiser_path=paths["denoiser"],
        super_res_path=paths["super_resolution"],
        stereo_path=paths["stereo"], config=cfg)
    fresh.mesh = mesh
    want, _ = fresh.restore(clip, rate)
    new = {name: getattr(fresh, name).state_dict()
           for name in ("denoiser", "super_resolution", "stereo")}
    served = [(dev, m, new[name]) for (name, kind, dev), m
              in pipe._copies.copies.items()
              if kind == getattr(torch, dtype) and name in new]
    weights_new = all(
        torch.equal(sd[k].to(t.dtype), t) for _, m, sd in served
        for k, t in m.state_dict().items())
    return {"dtype": dtype, "reloaded": reloaded,
            "devices": list(dict.fromkeys(str(d) for d, _, _ in served)),
            "equal_to_fresh": bool(torch.equal(after, want)),
            "differs_from_old": not torch.equal(before, after),
            "every_device_new_weights": bool(weights_new)}


def _mesh_cli(torch, paths, root, rate):
    """`restore --data-parallel 1` writes the bytes of a run without the
    flag (in process); `--data-parallel N` with N above the card count
    exits non-zero naming the count (a subprocess); `serve --data-parallel
    1` answers a request and a stream (_serve_cli)."""
    from ml_audio_restoration_torch import cli
    from ml_audio_restoration_torch.audio import save_audio

    src = os.path.join(root, "in.wav")
    save_audio(src, _clip(4.0, rate, seed=800), rate)
    ckpts = ["--denoiser", paths["denoiser"], "--super-res",
             paths["super_resolution"], "--stereo", paths["stereo"]]
    outs = {}
    for name, extra in (("plain", []), ("dp1", ["--data-parallel", "1"])):
        dst = os.path.join(root, f"{name}.wav")
        cli.main(["restore", src, dst, *ckpts, *extra])
        with open(dst, "rb") as fh:
            outs[name] = fh.read()
    cards = torch.cuda.device_count()
    proc = subprocess.run(
        [sys.executable, "-m", "ml_audio_restoration_torch", "restore", src,
         os.path.join(root, "too_many.wav"), *ckpts, "--data-parallel",
         str(cards + 1)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    names_count = f"only {cards} available" in proc.stderr
    row = {"restore_dp1_same_bytes": outs["plain"] == outs["dp1"],
           "too_many_returncode": proc.returncode,
           "too_many_names_count": names_count,
           "serve": _serve_cli(paths, rate, "--data-parallel", "1")}
    if not names_count:
        row["too_many_stderr"] = proc.stderr[-600:]
    row["ok"] = bool(row["restore_dp1_same_bytes"] and proc.returncode != 0
                     and names_count and row["serve"]["ok"])
    return row


def phase_serve_mesh(torch):
    """Multi-device serving (parallel/mesh.py, pipeline/staged.py) at full
    published width with seeded weights. The card host has one card, so
    the meshes repeat cuda:0 (MESH_LABEL): this checks the split, the
    gather and the numbers, not scaling. Returns {path: (K1 launches,
    None, None)} for the kernels line, and the int8 conv's launches."""
    import shutil

    from ml_audio_restoration_torch.compat import save_pth
    from ml_audio_restoration_torch.config import PipelineConfig
    from ml_audio_restoration_torch.ops import int8_conv as ic
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.parallel import make_mesh
    from ml_audio_restoration_torch.pipeline import (
        RestorationPipeline, StagedRestorationPipeline, StreamingRestorer)

    dev = torch.device("cuda")
    models = _models(torch, dev)
    pipe = RestorationPipeline(*models)
    rate, seconds = pipe.config.sample_rate, 120.0
    clip = _clip(seconds, rate, seed=3)
    meshes = {k: make_mesh(k, devices=["cuda:0"] * k) for k in MESH_ENTRIES}
    root = os.path.join(ROOT, "profiles", "chip_smoke_serve_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    row = {"phase": "serve_mesh", "label": MESH_LABEL}
    try:
        # 1. the 120 s clip unsharded and through 1-, 2- and 3-entry meshes
        y0, wall0, k1_0, shapes0 = _mesh_restore(torch, L, pipe, clip, rate,
                                                 None, "serve_mesh_0")
        row["plain"] = {"xrt": seconds / wall0, "wall_s": wall0,
                        "k1_launches": k1_0, "k1_shapes": shapes0}
        emit({"phase": "serve_mesh_restore", "entries": 0, **row["plain"]})
        row["restores"] = {}
        for k, mesh in meshes.items():
            y, wall, k1, shapes = _mesh_restore(torch, L, pipe, clip, rate,
                                                mesh, f"serve_mesh_{k}")
            r = {"entries": k, "xrt": seconds / wall, "wall_s": wall,
                 "plain_xrt": seconds / wall0, "k1_launches": k1,
                 "k1_shapes": shapes, **_mesh_bar(torch, y, y0)}
            row["restores"][k] = r
            emit({"phase": "serve_mesh_restore", **r})
        del y
        # 2. restore_many over the 2-entry mesh against single restores
        mix = [_clip(s, rate, seed=500 + i)
               for i, s in enumerate((5.0, 10.0, 20.0, 30.0, 7.5))]
        pipe.mesh = meshes[2]
        pipe.restore_many(mix, rate)
        torch.cuda.synchronize()
        with _k1_shapes_seen(L) as shapes:
            L.reset_launch_count()
            _reset_epilogue()
            t0 = time.perf_counter()
            many = pipe.restore_many(mix, rate)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k1_many = L.launch_count
            _note_epilogue("serve_mesh_many")
        singles = [pipe.restore(a, rate)[0] for a in mix]
        row["many"] = {
            "recordings": len(mix), "seconds": sum(a.shape[1] for a in mix)
            / rate, "wall_s": wall, "k1_launches": k1_many,
            "k1_shapes": shapes,
            "vs_single_max_abs": max(_max_dev(o, s) for (o, _), s in zip(
                many, singles)), "tol": MANY_TOL}
        row["many"]["xrt"] = row["many"]["seconds"] / wall
        emit({"phase": "serve_mesh_many", **row["many"]})
        del many, singles
        # 3. int8 through the 2-entry mesh on the unsharded run's scales
        q = RestorationPipeline(*models, config=PipelineConfig(
            quantize_int8=True))
        q.calibrate_int8(clip, rate)
        scales = os.path.join(root, "scales.json")
        q.save_int8_scales(scales)
        y8, _ = q.restore(clip, rate)
        qm = RestorationPipeline(*models, config=PipelineConfig(
            quantize_int8=True), mesh=meshes[2])
        qm.load_int8_scales(scales)
        loaded = qm._int8.scales
        qm.restore(clip, rate)
        y8m, wall8m, k1_8m, int8_launches = _timed_int8_restore(
            torch, L, ic, qm, clip, rate)
        _note_epilogue("serve_mesh_int8")
        by_path = dict(ic.launch_count_by_path)
        with ic.plain_int8_conv():
            y8m_plain, _ = qm.restore(clip, rate)
        rms = lambda d: float(d.float().square().mean().sqrt())  # noqa: E731
        row["int8"] = {
            "entries": 2, "xrt": seconds / wall8m, "k1_launches": k1_8m,
            "int8_conv_launches": int8_launches,
            "int8_conv_launches_by_path": by_path,
            "kernel_equal_to_plain": bool(torch.equal(y8m, y8m_plain)),
            "not_recalibrated": qm._int8.scales is loaded,
            "vs_unsharded_rms": rms(y8m - y8),
            "int8_vs_f32_rms": rms(y8 - y0)}
        row["int8"]["rms_tol"] = 0.25 * row["int8"]["int8_vs_f32_rms"]
        emit({"phase": "serve_mesh_int8", **row["int8"]})
        del q, qm, y8, y8m, y8m_plain
        torch.cuda.empty_cache()
        # 4. 16 lockstep streams over the 2-entry mesh vs unsharded
        block = int(0.5 * rate)
        streams = np.concatenate([_clip(10.0, rate, seed=600 + i)
                                  for i in range(16)])
        blocks = [streams[:, o:o + block]
                  for o in range(0, streams.shape[1], block)]
        runs = {}
        for name, mesh in (("plain", None), ("mesh", meshes[2])):
            r = StreamingRestorer(*models, batch=16, mesh=mesh)
            r.warmup(block)
            torch.cuda.synchronize()
            L.reset_launch_count()
            _reset_epilogue()
            out, emitted, _ = _feed_all(r, blocks)
            runs[name] = (out, statistics.median(emitted), L.launch_count)
            _note_epilogue("serve_mesh_stream" if name == "mesh"
                           else "serve_mesh_stream_plain")
        row["stream"] = {
            "streams": 16, "seconds": 10.0, "block_s": 0.5, "entries": 2,
            "feed_ms_median": runs["mesh"][1],
            "plain_feed_ms_median": runs["plain"][1],
            "k1_launches": runs["mesh"][2],
            "plain_k1_launches": runs["plain"][2],
            "vs_unsharded_max_abs": float(np.abs(
                runs["mesh"][0] - runs["plain"][0]).max()),
            "tol": MESH_STREAM_TOL}
        emit({"phase": "serve_mesh_stream", **row["stream"]})
        del runs
        # 5. staged: one stage an entry of [cuda:0] * 3
        pipe.mesh = None
        staged = StagedRestorationPipeline(*models, devices=["cuda:0"] * 3)
        row["staged"] = {}
        for name, c in (("120s", clip), ("4s", _clip(4.0, rate, seed=2))):
            want, _ = pipe.restore(c, rate)
            staged.restore(c, rate)
            torch.cuda.synchronize()
            with _k1_shapes_seen(L) as shapes:
                L.reset_launch_count()
                _reset_epilogue()
                t0 = time.perf_counter()
                got, _ = staged.restore(c, rate)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                k1 = L.launch_count
                _note_epilogue("serve_mesh_staged" if name == "120s"
                               else "serve_mesh_staged_4s")
            row["staged"][name] = {
                "seconds": c.shape[1] / rate, "wall_s": wall,
                "xrt": c.shape[1] / rate / wall, "k1_launches": k1,
                "k1_shapes": shapes,
                "bit_for_bit": bool(torch.equal(got, want)),
                "placement": {k: str(v)
                              for k, v in staged.placement.items()}}
            emit({"phase": "serve_mesh_staged", "clip": name,
                  **row["staged"][name]})
        del staged, got, want
        # 6. reload on a 2-entry mesh pipeline
        paths = {}
        for (attr, name), m in zip(
                (("denoiser", "denoiser"),
                 ("super_resolution", "super_resolution"),
                 ("stereo", "stereo_separator")),
                _models(torch, dev, seed=1)):
            paths[attr] = os.path.join(root, f"{attr}.pth")
            save_pth(paths[attr], name, {k: v.cpu() for k, v in
                                         m.state_dict().items()})
        row["reload"] = [_mesh_reload(torch, models, paths, meshes[2],
                                      _clip(10.0, rate, seed=401), rate,
                                      dtype)
                         for dtype in ("float32", "bfloat16")]
        emit({"phase": "serve_mesh_reload", "runs": row["reload"]})
        # 7. the CLI's --data-parallel
        row["cli"] = _mesh_cli(torch, paths, root, rate)
        emit({"phase": "serve_mesh_cli", **row["cli"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res, int8, stream = row["restores"], row["int8"], row["stream"]
    checks = {
        "mesh1": res[1]["bit_for_bit"] and res[1]["k1_launches"] == 1,
        "mesh2": (res[2]["within_bar"] and res[2]["k1_launches"] == 2
                  and res[2]["k1_shapes"] == [[88200, 32]] * 2),
        "mesh3": (res[3]["within_bar"] and res[3]["k1_launches"] == 3
                  and res[3]["k1_shapes"] == [[88200, 22], [88200, 21],
                                              [88200, 21]]),
        "many": (row["many"]["vs_single_max_abs"] <= MANY_TOL
                 and row["many"]["k1_launches"] == 2),
        "int8": (int8["kernel_equal_to_plain"] and int8["not_recalibrated"]
                 and int8["vs_unsharded_rms"] <= int8["rms_tol"]
                 and int8["k1_launches"] == 2
                 and int8["int8_conv_launches_by_path"]
                 == {"wgmma": 64, "stem": 6, "generic": 0}),
        "stream": (stream["vs_unsharded_max_abs"] <= MESH_STREAM_TOL
                   and stream["k1_launches"]
                   == 2 * stream["plain_k1_launches"]),
        "staged": all(r["bit_for_bit"] and r["k1_launches"] == 1
                      for r in row["staged"].values()),
        "reload": all(r["equal_to_fresh"] and r["differs_from_old"]
                      and r["every_device_new_weights"]
                      and r["reloaded"] == ["denoiser", "stereo",
                                            "super_resolution"]
                      for r in row["reload"]),
        "cli": row["cli"]["ok"]}
    emit({"phase": "serve_mesh", "label": MESH_LABEL, "checks": checks,
          "plain_xrt": row["plain"]["xrt"],
          "xrt_by_entries": {k: r["xrt"] for k, r in res.items()},
          "k1_shapes_by_entries": {k: r["k1_shapes"] for k, r in res.items()},
          "max_abs_by_entries": {k: r["max_abs"] for k, r in res.items()},
          "many_xrt": row["many"]["xrt"], "int8_xrt": int8["xrt"],
          "stream_feed_ms_median": stream["feed_ms_median"],
          "staged_s": {k: r["wall_s"] for k, r in row["staged"].items()}})
    if not all(checks.values()):
        raise AssertionError(f"multi-device serving failed: {checks}")
    return {"serve_mesh_1": (res[1]["k1_launches"], None, None),
            "serve_mesh_2": (res[2]["k1_launches"], None, None),
            "serve_mesh_3": (res[3]["k1_launches"], None, None),
            "serve_mesh_many": (row["many"]["k1_launches"], None, None),
            "serve_mesh_int8": (int8["k1_launches"], None, None),
            "serve_mesh_stream": (stream["k1_launches"], None, None),
            "serve_mesh_staged": (row["staged"]["120s"]["k1_launches"],
                                  None, None),
            "int8_conv": int8["int8_conv_launches"]}


SEQ_LABEL = ("time shards on repeated cuda:0 entries of one H100, one "
             "after another on its one stream: not a scaling figure")
SEQ_STAGES = ("front", "stereo", "encode", "recur", "decode", "combine")


@contextlib.contextmanager
def _seq_stage_events(torch):
    """CUDA events around every call of the stage pieces the
    sequence-parallel stack runs (pipeline/restore.py::_Stages): yields
    a function that returns {piece: device ms summed over its calls,
    "gather": the rest of the stack's span (the crops, the gathers' cats
    and the windows' slices), "span": first start to last end}."""
    from ml_audio_restoration_torch.pipeline import restore as R

    spans = []
    saved = {name: getattr(R._Stages, name) for name in SEQ_STAGES}

    def timed(name, fn):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans.append((name, start, end))
            return out
        return run

    def read():
        torch.cuda.synchronize()
        ms = dict.fromkeys(SEQ_STAGES, 0.0)
        for name, a, b in spans:
            ms[name] += a.elapsed_time(b)
        ms["span"] = spans[0][1].elapsed_time(spans[-1][2]) if spans else 0.0
        ms["gather"] = ms["span"] - sum(ms[n] for n in SEQ_STAGES)
        return ms

    for name, fn in saved.items():
        setattr(R._Stages, name, timed(name, fn))
    try:
        yield read
    finally:
        for name, fn in saved.items():
            setattr(R._Stages, name, fn)


def _seq_restore(torch, L, pipe, clip, rate, mesh, path):
    """`pipe` under `mesh` (None: unsharded) on `clip`: one warm-up
    restore, then one counted, with K1's [T, B] a launch, the peak memory
    and the device ms of each stage piece (the conv epilogue's reading kept
    as `path`'s). Returns (output, row)."""
    pipe.mesh = mesh
    pipe.restore(clip, rate)
    with _k1_shapes_seen(L) as shapes, _seq_stage_events(torch) as read:
        y, wall, launches, peak = _timed_restore(torch, L, pipe, clip, rate)
        _note_epilogue(path)
        stage_ms = read()
    seconds = clip.shape[1] / rate
    return y, {"mesh": None if mesh is None else [mesh.shape["data"],
                                                  mesh.shape["model"]],
               "xrt": seconds / wall, "wall_s": wall,
               "k1_launches": launches, "k1_shapes": shapes,
               "peak_mem_bytes": peak, "stage_ms": stage_ms}


def phase_serve_seq(torch):
    """Sequence-parallel serving (the mesh's 'model' axis,
    parallel/sequence.py) at full published width with seeded weights, TF32
    off (the pipeline turns it off): a 120 s whole-file restore through
    1x1 (bit for bit the unsharded restore), 1x2 and 1x4 meshes (MESH_TOL),
    the same in bf16 (BF16_CHAIN_TOL) and under int8 over 1x2 on the
    unsharded run's scales file (RMS within a quarter of the int8-vs-f32
    RMS), a chunked 120 s restore on 2x2, and 16 streams over 1x2. The
    card host has one card, so the meshes repeat cuda:0 (SEQ_LABEL).
    Returns {path: (K1 launches, None, None)} and the int8 conv's
    launches."""
    import shutil

    from ml_audio_restoration_torch.config import PipelineConfig
    from ml_audio_restoration_torch.ops import int8_conv as ic
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.parallel import make_mesh
    from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                     StreamingRestorer)

    dev = torch.device("cuda")
    models = _models(torch, dev)
    rate, seconds = 22050, 120.0
    clip = _clip(seconds, rate, seed=3)

    def mesh(d, m):
        return make_mesh(d, m, devices=["cuda:0"] * (d * m))

    root = os.path.join(ROOT, "profiles", "chip_smoke_serve_seq")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    row = {"phase": "serve_seq", "label": SEQ_LABEL, "seconds": seconds}
    whole = [(1, 1), (1, 2), (1, 4)]
    try:
        # 1-2. whole-file f32 and bf16: unsharded, then 1x1, 1x2, 1x4
        for dtype, tol in (("float32", MESH_TOL),
                           ("bfloat16", {"atol": BF16_CHAIN_TOL,
                                         "rtol": 0.0})):
            pipe = RestorationPipeline(*models, config=PipelineConfig(
                whole_file=True, compute_dtype=dtype))
            tag = "" if dtype == "float32" else "bf16_"
            y0, plain = _seq_restore(torch, L, pipe, clip, rate, None,
                                     f"serve_seq_{tag}whole_file")
            emit({"phase": "serve_seq_restore", "dtype": dtype, **plain})
            runs = {"plain": plain}
            for d, m in whole:
                y, r = _seq_restore(torch, L, pipe, clip, rate, mesh(d, m),
                                    f"serve_seq_{tag}{d}x{m}")
                r.update(max_abs=_max_dev(y, y0),
                         within_bar=bool(torch.allclose(y, y0, **tol)),
                         bit_for_bit=bool(torch.equal(y, y0)),
                         finite=bool(torch.isfinite(y).all()),
                         shape=list(y.shape))
                runs[f"{d}x{m}"] = r
                emit({"phase": "serve_seq_restore", "dtype": dtype, **r})
                del y
            row[dtype] = runs
            if dtype == "float32":
                y32 = y0
            del pipe, y0
            torch.cuda.empty_cache()
        # 3. int8 over 1x2 on the unsharded run's scales file
        cfg8 = PipelineConfig(whole_file=True, quantize_int8=True)
        q = RestorationPipeline(*models, config=cfg8)
        q.calibrate_int8(clip, rate)
        scales = os.path.join(root, "scales.json")
        q.save_int8_scales(scales)
        y8, _ = q.restore(clip, rate)
        del q
        qm = RestorationPipeline(*models, config=cfg8, mesh=mesh(1, 2))
        loaded = qm.load_int8_scales(scales)
        qm.restore(clip, rate)
        with _k1_shapes_seen(L) as shapes:
            y8m, wall8, k1_8, int8_launches = _timed_int8_restore(
                torch, L, ic, qm, clip, rate)
            _note_epilogue("serve_seq_int8")
        by_path = dict(ic.launch_count_by_path)
        rms = lambda d: float(d.float().square().mean().sqrt())  # noqa: E731
        row["int8"] = {
            "mesh": [1, 2], "xrt": seconds / wall8, "wall_s": wall8,
            "k1_launches": k1_8, "k1_shapes": shapes,
            "int8_conv_launches": int8_launches,
            "int8_conv_launches_by_path": by_path,
            "not_recalibrated": qm._int8.scales is loaded,
            "vs_unsharded_rms": rms(y8m - y8),
            "vs_unsharded_max_abs": _max_dev(y8m, y8),
            "int8_vs_f32_rms": rms(y8 - y32)}
        row["int8"]["rms_tol"] = 0.25 * row["int8"]["int8_vs_f32_rms"]
        emit({"phase": "serve_seq_int8", **row["int8"]})
        del qm, y8, y8m, y32
        torch.cuda.empty_cache()
        # 4. a chunked 120 s restore on 2x2 (64 chunks: 32 a row)
        pipe = RestorationPipeline(*models)
        y0, plain = _seq_restore(torch, L, pipe, clip, rate, None,
                                 "serve_seq_chunked")
        y, r = _seq_restore(torch, L, pipe, clip, rate, mesh(2, 2),
                            "serve_seq_chunked_2x2")
        r.update(plain_xrt=plain["xrt"], plain_stage_ms=plain["stage_ms"],
                 max_abs=_max_dev(y, y0),
                 within_bar=bool(torch.allclose(y, y0, **MESH_TOL)))
        row["chunked"] = r
        emit({"phase": "serve_seq_chunked", **r})
        del pipe, y, y0
        # 5. 16 lockstep streams of 10 s over 1x2 against unsharded
        block = int(0.5 * rate)
        streams = np.concatenate([_clip(10.0, rate, seed=600 + i)
                                  for i in range(16)])
        blocks = [streams[:, o:o + block]
                  for o in range(0, streams.shape[1], block)]
        outs = {}
        for name, msh in (("plain", None), ("1x2", mesh(1, 2))):
            r = StreamingRestorer(*models, batch=16, mesh=msh)
            r.warmup(block)
            torch.cuda.synchronize()
            L.reset_launch_count()
            _reset_epilogue()
            out, emitted, _ = _feed_all(r, blocks)
            outs[name] = (out, statistics.median(emitted), L.launch_count)
            _note_epilogue("serve_seq_stream" if name == "1x2"
                           else "serve_seq_stream_plain")
        row["stream"] = {
            "streams": 16, "seconds": 10.0, "block_s": 0.5, "mesh": [1, 2],
            "feed_ms_median": outs["1x2"][1],
            "plain_feed_ms_median": outs["plain"][1],
            "k1_launches": outs["1x2"][2],
            "plain_k1_launches": outs["plain"][2],
            "vs_unsharded_max_abs": float(np.abs(
                outs["1x2"][0] - outs["plain"][0]).max()),
            "tol": MESH_STREAM_TOL}
        emit({"phase": "serve_seq_stream", **row["stream"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    f32, bf16, int8 = row["float32"], row["bfloat16"], row["int8"]
    walk = [[SEQ_T, 1]]
    checks = {
        "f32_1x1": f32["1x1"]["bit_for_bit"],
        "f32_sharded": all(f32[k]["within_bar"] for k in ("1x2", "1x4")),
        "bf16_1x1": bf16["1x1"]["bit_for_bit"],
        "bf16_sharded": all(bf16[k]["within_bar"] for k in ("1x2", "1x4")),
        "finite": all(r[k]["finite"] for r in (f32, bf16)
                      for k in ("1x1", "1x2", "1x4")),
        "k1_whole_file": all(r[k]["k1_shapes"] == walk
                             for r in (f32, bf16)
                             for k in ("plain", "1x1", "1x2", "1x4")),
        "int8": (int8["not_recalibrated"] and int8["k1_shapes"] == walk
                 and int8["vs_unsharded_rms"] <= int8["rms_tol"]
                 and int8["int8_conv_launches_by_path"]
                 == {"wgmma": 64, "stem": 6, "generic": 0}),
        "chunked": (row["chunked"]["within_bar"]
                    and row["chunked"]["k1_shapes"] == [[88200, 32]] * 2),
        "stream": (row["stream"]["vs_unsharded_max_abs"] <= MESH_STREAM_TOL
                   and row["stream"]["k1_launches"]
                   == row["stream"]["plain_k1_launches"])}
    emit({"phase": "serve_seq", "label": SEQ_LABEL, "checks": checks,
          "xrt": {dt: {k: r["xrt"] for k, r in row[dt].items()}
                  for dt in ("float32", "bfloat16")},
          "max_abs": {dt: {k: r["max_abs"] for k, r in row[dt].items()
                           if k != "plain"}
                      for dt in ("float32", "bfloat16")},
          "int8_xrt": int8["xrt"], "chunked_xrt": row["chunked"]["xrt"],
          "stream_feed_ms_median": row["stream"]["feed_ms_median"]})
    if not all(checks.values()):
        raise AssertionError(f"sequence-parallel serving failed: {checks}")
    return {"serve_seq_1x2": (f32["1x2"]["k1_launches"], None, None),
            "serve_seq_1x4": (f32["1x4"]["k1_launches"], None, None),
            "serve_seq_bf16_1x4": (bf16["1x4"]["k1_launches"], None, None),
            "serve_seq_int8": (int8["k1_launches"], None, None),
            "serve_seq_chunked_2x2": (row["chunked"]["k1_launches"], None,
                                      None),
            "serve_seq_stream": (row["stream"]["k1_launches"], None, None),
            "int8_conv": int8["int8_conv_launches"]}


# ----------------------------------------------------------------- IIR scans
IIR_RATE, IIR_B, IIR_T = 22050, 16, 44100  # the denoiser's training batch
IIR_TOL = 0.0       # kernel vs plain: the same IEEE operations in the same
#                     order (-fmad=false), so bit for bit
IIR_SIM_TOL = 1e-5  # simulate_batch(iir) and DF2T filtfilt, card vs CPU
#                     on the same inputs (DEGRADE_TOL: the pops' exp and
#                     sin, and sums around the walks, round differently)
IIR_REF_TOL = 1e-6  # a walk, forward or adjoint (gx), against scipy's
#                     float64 filter of the same f32 coefficients and state,
#                     of the reference's peak: the double state's accuracy
#                     (JAX's f32 serial walk of the rumble low-pass: 3.3e-5)
IIR_EDGE_STEPS = (40, 65, 100_000)  # below one block, one past it, and a
#                     row long enough that the blocks grow past 64 steps
H100_FP64_LANES = 64  # FP64 operations an SM issues a cycle: 33.5 TFLOP/s
#                     FP64 (an FMA two) over 132 SMs at 1.98 GHz, H100 SXM
#                     data sheet


def _iir_walk(torch, x, sos, zi):
    """The rows one walk of sosfiltfilt's first pass sees: x [B, C, T]
    oddly extended, the coefficients and the scaled steady state a row."""
    from ml_audio_restoration_torch.ops import filters as F

    sos = torch.as_tensor(sos, device=x.device).to(x.dtype)
    zi = torch.as_tensor(zi, device=x.device).to(x.dtype)
    n = sos.shape[-2]
    ext = F._odd_extend(x, 3 * (2 * n + 1))
    lead = tuple(ext.shape[:-1])
    z0 = zi * ext[..., 0][..., None, None]
    return (ext.reshape(-1, ext.shape[-1]).contiguous(),
            sos.broadcast_to(lead + (n, 6)).reshape(-1, n, 6).contiguous(),
            z0.broadcast_to(lead + (n, 2)).reshape(-1, n, 2).contiguous())


def _iir_bound(rows: int, steps: int, flops_per_step: float):
    """(bound ms, "bytes" or "operations") of one walk: each input read and
    each output written once, against its f32 operations."""
    return _bound(2 * 4 * rows * steps, flops_per_step * rows * steps)


def _iir_reference(kind, x, coef, zi, gy):
    """(y, gx) of scipy's float64 filter, a row at a time, with each row's
    coefficients and initial state widened to float64: y the forward walk,
    gx the adjoint's (a linear time-invariant filter's transpose is the
    same filter on the time-reversed cotangent from the zero state,
    reversed back)."""
    from scipy import signal as sig

    x, coef, zi, gy = (t.detach().cpu().double().numpy()
                       for t in (x, coef, zi, gy))
    ys, gxs = [], []
    for r in range(x.shape[0]):
        if kind == "sos":
            y, _ = sig.sosfilt(coef[r], x[r], zi=zi[r])
            gx = sig.sosfilt(coef[r], gy[r, ::-1])[::-1]
        else:
            b, a = np.split(coef[r], 2)
            y, _ = sig.lfilter(b, a, x[r], zi=zi[r])
            gx = sig.lfilter(b, a, gy[r, ::-1])[::-1]
        ys.append(y)
        gxs.append(gx)
    return np.stack(ys), np.stack(gxs)


def _peak_dev(got, want) -> float:
    """max |got - want| over the peak of want."""
    got = got.detach().cpu().double().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _iir_check(torch, I, kind, x, coef, zi, gy):
    """One walk on the card, forward and adjoint: (its max abs deviations
    from the plain versions on the CPU, its deviations from scipy's
    float64 reference over the reference's peak)."""
    fwd, adj = ((I._sos_forward, I._sos_adjoint) if kind == "sos"
                else (I._df2t_forward, I._df2t_adjoint))
    plain_fwd, plain_adj = ((I.sos_scan_plain, I.sos_adjoint_plain)
                            if kind == "sos" else
                            (I.df2t_scan_plain, I.df2t_adjoint_plain))
    y = fwd(x, coef, zi)
    gx, gzi = adj(gy, coef)
    torch.cuda.synchronize()
    cpu = [t.cpu() for t in (x, coef, zi, gy)]
    gx_p, gzi_p = plain_adj(cpu[3], cpu[1])
    y_ref, gx_ref = _iir_reference(kind, *cpu)
    return {"forward": _max_dev(y.cpu(), plain_fwd(*cpu[:3])),
            "adjoint": max(_max_dev(gx.cpu(), gx_p),
                           _max_dev(gzi.cpu(), gzi_p))}, {
        "forward": _peak_dev(y, y_ref), "adjoint": _peak_dev(gx, gx_ref)}


def _iir_ops(kind: str, size: int) -> int:
    """Double operations of one step of a walk, forward or adjoint (they
    are equal): nine a biquad section, 4 N + 1 a DF2T step of order N."""
    return 9 * size if kind == "sos" else 4 * size + 1


def _iir_floors(kind: str, size: int, rows: int, steps: int, lat: dict,
                ghz: float, sms: int) -> dict:
    """The blocked design's floors, ms: `latency`, its critical chain (two
    passes of L steps, local and replay, at four dependent DADD-latency
    operations a biquad step and three a DF2T one, plus the combine's
    log2(P) levels, each a product of 2 n dependent operations and a
    shared-memory round trip through a barrier, twice); `fp64_issue`, its
    double operations (the passes' 2 T steps, the unit states' n L, the
    combine's levels x P x 2 n^2) over the FP64 lanes of an SM, one CTA a
    row and `sms` rows at once; and the serial design's latency floor
    (`serial`, T steps of the chain in f32), which no one-thread-a-row walk
    beats."""
    from ml_audio_restoration_torch.ops import iir as I

    block, blocks = I.partition(steps)
    n = 2 * size if kind == "sos" else size
    chain = 4 if kind == "sos" else 3
    levels = (blocks - 1).bit_length()
    latency = (2 * block * chain + levels * 2 * n) * lat["dadd"] + (
        levels * 2 * lat["sts_bar_lds_fadd"])
    ops = (_iir_ops(kind, size) * (2 * steps + n * block)
           + levels * blocks * 2 * n * n)
    waves = -(-rows // sms)
    return {"latency_ms": latency / ghz * 1e-6,
            "fp64_issue_ms": waves * ops / H100_FP64_LANES / ghz * 1e-6,
            "serial_ms": steps * chain * lat["fadd"] / ghz * 1e-6,
            "block": block, "blocks": blocks, "levels": levels,
            "fp64_ops_per_row": ops}


def _iir_kernel_ms(torch, fn, reps: int = 20) -> float:
    """The median device time of one launch of fn's kernel over `reps`
    calls. A walk is shorter than the host's work for a call, so the calls
    queue behind a spin of the card first (torch.cuda._sleep, ~5 ms) and
    run back to back, each between its own pair of CUDA events."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    return _cuda_ms(torch, fn, reps)


def _iir_rows(torch, I, walks, lat, ghz):
    """Each walk against its plain version on the CPU (the same inputs) and
    scipy's float64 filter, forward and adjoint, and timed on the card
    beside its bytes bound and the design's floors (_iir_floors): the
    kernel's device time (`ms`, `adjoint_ms`) and a forward call's on the
    stream, the wrapper's host work included (`call_ms`)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, worst, worst_ref = [], 0.0, 0.0
    gen = torch.Generator(device="cuda").manual_seed(8)
    for name, (x, coef, zi, kind) in walks.items():
        fwd, adj = ((I._sos_forward, I._sos_adjoint) if kind == "sos"
                    else (I._df2t_forward, I._df2t_adjoint))
        gy = torch.randn(x.shape, generator=gen, device="cuda")
        err, ref = _iir_check(torch, I, kind, x, coef, zi, gy)
        worst = max(worst, *err.values())
        worst_ref = max(worst_ref, *ref.values())
        r, t = x.shape
        size = coef.shape[1] if kind == "sos" else zi.shape[1]
        bound, by = _iir_bound(r, t, _iir_ops(kind, size))
        floors = _iir_floors(kind, size, r, t, lat, ghz, sms)
        rows.append({"walk": name, "kind": kind, "rows": r, "steps": t,
                     "size": size, "max_abs_err": err,
                     "reference_peak_dev": ref,
                     "ms": _iir_kernel_ms(torch, lambda: fwd(x, coef, zi)),
                     "adjoint_ms": _iir_kernel_ms(torch,
                                                  lambda: adj(gy, coef)),
                     "call_ms": _cuda_ms(torch, lambda: fwd(x, coef, zi),
                                         20),
                     "bound_ms": bound, "bound_by": by,
                     "floor_ms": max(floors["latency_ms"],
                                     floors["fp64_issue_ms"]),
                     "floors": floors})
    return rows, worst, worst_ref


def _iir_edges(torch, I):
    """The partition's edges on the card (IIR_EDGE_STEPS), a biquad
    cascade (the crackle high-pass) and DF2T of order 4 on 4 rows: each
    walk bit for bit its plain version and within IIR_REF_TOL of scipy."""
    from ml_audio_restoration_torch.ops import filters as F

    gen = torch.Generator(device="cuda").manual_seed(9)
    sos, zi = F.butter_sos(4, 2500.0, IIR_RATE, "high")
    bb, ba, bzi = F.butter_coeffs(4, 0.3 * IIR_RATE / 2, IIR_RATE, "low")
    out = []
    for t in IIR_EDGE_STEPS:
        x = torch.randn((4, t), generator=gen, device="cuda")
        gy = torch.randn((4, t), generator=gen, device="cuda")
        scale = x[:, :1]
        cases = {
            "sos": (torch.from_numpy(sos).cuda().expand(4, -1, -1)
                    .contiguous(),
                    torch.from_numpy(zi).cuda() * scale[..., None]),
            "df2t": (torch.from_numpy(np.concatenate([bb, ba])).cuda()
                     .expand(4, -1).contiguous(),
                     torch.from_numpy(bzi).cuda() * scale)}
        for kind, (coef, z0) in cases.items():
            err, ref = _iir_check(torch, I, kind, x, coef, z0.contiguous(),
                                  gy)
            out.append({"kind": kind, "steps": t,
                        "partition": I.partition(t), "max_abs_err": err,
                        "reference_peak_dev": ref})
    return out


def _iir_profile(torch, run):
    """The IIR degradation under utils.profiling.trace: wall ms, device ms
    by bucket, the top device ops and the host's gaps (wall - device)."""
    from ml_audio_restoration_torch.utils import profiling as P

    run()  # warm
    with tempfile.TemporaryDirectory() as tmp:
        with P.trace(tmp):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        try:
            times = P.trace_device_times(tmp)
            top = P.trace_top_ops(tmp, 12)
        except RuntimeError as err:  # a trace the profiler left empty
            return {"wall_ms_traced": wall, "not_measured": str(err)}
    return {"wall_ms_traced": wall, "device_times": times, "top_ops": top,
            "host_gap_ms": wall - times["total_device_ms"],
            "idle_share": 1.0 - times["total_device_ms"] / wall}


EPILOGUE_ROWS = 44       # a balanced slab of the restore cell (40-64 rows)
#: the eval convs the port ran on the card since the last _reset_epilogue,
#: by the route each took: csrc/conv_epilogue.cu, or ATen's ops (a gradient
#: wanted, or inside aten_epilogue())
EPILOGUE_ROUTE = {"kernel": 0, "aten": 0}
#: path -> the conv epilogue's reading over the run that gave the path's K1
#: count (_note_epilogue)
EPILOGUE_PATHS = {}
#: paths whose every program runs each of these stages (0 denoiser, 1 SR,
#: 2 stereo) once and walks K1 once (slabs, coalesced recordings, 0.25 s
#: stereo windows in one batch): the epilogue launches the stages' convs a
#: walk; the other paths window or shard the stages apart from the walks
EPILOGUE_WALK_STAGES = {
    **{p: (0, 1, 2) for p in (
        "main_120s", "serve_fast", "serve_sub_0.25", "serve_mid_exact",
        "serve_source_rate", "serve_many", "files_flac_restore",
        "files_wav_restore", "files_msgpack_restore", "serve_http_solo",
        "serve_mesh_0", "serve_mesh_1")},
    "evaluate_stereo": (2,)}


def _count_epilogue_route():
    """Tally each eval conv on the card by the route it takes
    (EPILOGUE_ROUTE): wraps ops/conv.py's route decision for the rest of
    the run."""
    from ml_audio_restoration_torch.ops import conv as C

    takes = C._takes_epilogue

    def counted(*tensors):
        took = takes(*tensors)
        if tensors[0].device.type == "cuda":
            EPILOGUE_ROUTE["kernel" if took else "aten"] += 1
        return took

    C._takes_epilogue = counted


def _reset_epilogue():
    """The conv epilogue's launch count and EPILOGUE_ROUTE to 0, beside a
    reset of K1's count."""
    from ml_audio_restoration_torch.ops import conv as C

    C.reset_epilogue_launch_count()
    EPILOGUE_ROUTE.update(kernel=0, aten=0)


def _note_epilogue(path) -> dict:
    """Keep (and return) the reading since _reset_epilogue as `path`'s: the
    kernel's launches, the route's tallies and K1's launches."""
    from ml_audio_restoration_torch.ops import conv as C
    from ml_audio_restoration_torch.ops import lstm as L

    EPILOGUE_PATHS[path] = reading = {
        "launches": C.epilogue_launch_count, **EPILOGUE_ROUTE,
        "k1_launches": L.launch_count}
    return reading


def _epilogue_failures(paths) -> dict:
    """The paths (every one the kernels line counts K1 on, and every
    reading kept) where the conv epilogue misses: a run must send each
    eval conv it routes to the kernel (none to ATen's ops: no gradient is
    wanted on a serving path), one launch each, at least one; on
    EPILOGUE_WALK_STAGES' paths the launches are K1's walks times the
    stages' convs (models.epilogue_convs). path -> its reading and want."""
    from ml_audio_restoration_torch.models import (
        AudioDenoiser, AudioSuperResolution, StereoSeparator, epilogue_convs)

    convs = [len(epilogue_convs(m())) for m in (
        AudioDenoiser, AudioSuperResolution, StereoSeparator)]
    failures = {}
    for path in sorted(set(paths) | set(EPILOGUE_PATHS)):
        r = EPILOGUE_PATHS.get(path)
        if r is None:
            failures[path] = "no reading"
            continue
        want = r["kernel"]
        if path in EPILOGUE_WALK_STAGES:
            want = r["k1_launches"] * sum(
                convs[i] for i in EPILOGUE_WALK_STAGES[path])
        if r["aten"] or not 1 <= r["launches"] == r["kernel"] == want:
            failures[path] = {**r, "want": want}
    return failures


def _epilogue_stereo_layers():
    """(channels, convs a forward, LeakyReLU) of the stereo model's eval
    convs, from models.epilogue_convs: the shapes the epilogue is timed
    at."""
    from collections import Counter

    from ml_audio_restoration_torch.models import (
        StereoSeparator, epilogue_convs)

    return [(c, n, lrelu) for (c, lrelu), n in sorted(
        Counter(epilogue_convs(StereoSeparator())).items())]


def phase_epilogue(torch):
    """The eval convolutions' epilogue (csrc/conv_epilogue.cu behind
    ops/conv.py::conv_epilogue) at the stereo model's layer shapes, a
    44-row slab of 2 s chunks ([44, C, 88,200]): bit for bit ATen's ops
    (the bias add in place, F.leaky_relu), then timed beside its bytes
    bound (one read and one write of the output), its plain version and
    ATen's bias add + LeakyReLU as the conv_bn path ran them (library);
    the sum over one stereo forward's convs; and the launches of one eval
    forward of each model against models.epilogue_convs."""
    import torch.nn.functional as F

    from ml_audio_restoration_torch.models import epilogue_convs
    from ml_audio_restoration_torch.ops import conv as C

    dev = torch.device("cuda")
    t = 88200
    shapes = []
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for c, count, lrelu in _epilogue_stereo_layers():
            g = torch.Generator(device=dev).manual_seed(c)
            y = torch.randn((EPILOGUE_ROWS, c, t), device=dev,
                            generator=g).to(dtype)
            b = torch.randn(c, device=dev, generator=g).to(dtype)

            def library(out):
                out = out.add_(b.view(1, -1, 1))
                return F.leaky_relu(out, 0.2) if lrelu else out

            want = library(y.clone())
            got = C.conv_epilogue(y.clone(), b, lrelu=lrelu)
            torch.cuda.synchronize()
            equal = bool(torch.equal(got, want))
            worst = max(worst, _max_dev(got, want))
            del got, want
            ms = _cuda_ms(torch, lambda: C.conv_epilogue(y, b, lrelu=lrelu),
                          10)
            plain_ms = _cuda_ms(torch, lambda: C.conv_epilogue_plain(
                y, b, lrelu=lrelu), 10)
            library_ms = _cuda_ms(torch, lambda: library(y), 10)
            n_bytes = 2 * y.numel() * y.element_size() + b.numel() * 4
            bound_ms = n_bytes / H100_BYTES_PER_S * 1e3
            shapes.append({"shape": [EPILOGUE_ROWS, c, t],
                           "dtype": str(dtype).split(".")[-1],
                           "lrelu": lrelu, "count": count, "equal": equal,
                           "ms": ms, "plain_ms": plain_ms,
                           "library_ms": library_ms, "bound_ms": bound_ms,
                           "bandwidth_share": bound_ms / ms,
                           "bytes": n_bytes})
            del y
            torch.cuda.empty_cache()
    f32 = [r for r in shapes if r["dtype"] == "float32"]

    def forward(key):
        return sum(r["count"] * r[key] for r in f32)

    from ml_audio_restoration_torch.models import (
        AudioDenoiser, AudioSuperResolution, StereoSeparator, init_params)

    gen = torch.Generator().manual_seed(0)
    launches = {}
    x = torch.randn((2, 1, 8000), device=dev)
    for model in (AudioDenoiser(), AudioSuperResolution(), StereoSeparator()):
        model = init_params(model, gen).to(dev).eval()
        C.reset_epilogue_launch_count()
        with torch.inference_mode():
            model(x)
        launches[type(model).__name__] = (C.epilogue_launch_count,
                                          len(epilogue_convs(model)))
    row = {"phase": "epilogue", "shapes": shapes,
           "stereo_forward": {"ms": forward("ms"),
                              "bound_ms": forward("bound_ms"),
                              "plain_ms": forward("plain_ms"),
                              "library_ms": forward("library_ms")},
           "launches_per_forward": launches, "max_abs_err": worst}
    emit(row)
    if not (all(r["equal"] for r in shapes)
            and all(n == want for n, want in launches.values())):
        raise AssertionError(f"conv epilogue failed: {row}")
    # `launches` (a restore program's) and `path_launches` come from the
    # paths' runs (main)
    return {"name": "conv_epilogue", "route": "cuda",
            "source": "ml_audio_restoration_torch/csrc/conv_epilogue.cu",
            "replaces": "none: ATen's bias add and F.leaky_relu after cuDNN",
            "max_abs_err": worst,
            "ms": row["stereo_forward"]["ms"],
            "plain_ms": row["stereo_forward"]["plain_ms"],
            "bound_ms": row["stereo_forward"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": row["stereo_forward"]["library_ms"],
            "shapes": shapes}


def phase_iir(torch):
    """The simulator's IIR path (ops/filters.py over csrc/iir_scan.cu) at
    the denoiser's training shape, B=16, C=1, T=44,100 at 22.05 kHz (the
    walks see 44,130 samples: padlen 15 each side): each walk of the
    degradation (crackle high-pass, rumble low-pass, the per-item roll-off)
    forward and adjoint against its plain version, one walk's plain version
    on the card too, DF2T lfilter / filtfilt at order 4, the partition's
    edges, then simulate_batch(filter_mode="iir") on the card against the
    CPU on the same draws, its launches, and the whole IIR degradation
    timed beside the FIR path's on the same draws and scipy's sosfiltfilt
    on the host, and traced (its top device ops and the host's gaps)."""
    from scipy import signal as sig

    from ml_audio_restoration_torch.config import ArtifactConfig
    from ml_audio_restoration_torch.data import artifacts as A
    from ml_audio_restoration_torch.ops import _latency
    from ml_audio_restoration_torch.ops import filters as F
    from ml_audio_restoration_torch.ops import iir as I

    dev = torch.device("cuda")
    rate, b, t = IIR_RATE, IIR_B, IIR_T
    clean = torch.from_numpy(_mono_batch(b, t, rate, seed=31))
    draws = A.draw_artifacts(torch.Generator().manual_seed(31), (b, 1, t),
                             rate)
    clean_d = clean.to(dev)
    draws_d = {k: v.to(dev) for k, v in draws.items()}

    # the three walks' inputs as apply_artifacts forms them
    def scaled(key, level):
        return draws_d[key] * draws_d[level][:, None, None]

    mix = A.apply_artifacts(clean_d, draws_d, rate,
                            ArtifactConfig(add_rolloff=False),
                            filter_mode="iir")
    f_lo, f_hi = ArtifactConfig().rolloff_freq
    bank = F.butter_bank(3, f_lo, f_hi, rate, "low", A.ROLLOFF_BANK)
    idx = F.bank_index(A.ROLLOFF_BANK, draws["rolloff_freq"], f_lo,
                       f_hi).long().numpy()
    walks = {
        "crackle": (*_iir_walk(torch, scaled("crackle", "crackle_level"),
                               *F.butter_sos(4, 2500.0, rate, "high")),
                    "sos"),
        "rumble": (*_iir_walk(torch, scaled("rumble", "rumble_level"),
                              *F.butter_sos(4, 100.0, rate, "low")), "sos"),
        "rolloff": (*_iir_walk(torch, mix, bank[0][idx][:, None],
                               bank[1][idx][:, None]), "sos")}
    bb, ba, _ = F.butter_coeffs(4, 2500.0, rate, "high")
    ext = F._odd_extend(scaled("crackle", "crackle_level"), 15)[:, 0]
    zi = F.lfilter_zi(bb, ba).to(dev) * ext[:, :1]
    coef = torch.cat([torch.from_numpy(bb / ba[0]),
                      torch.from_numpy(ba / ba[0])]).to(dev)
    walks["df2t_order4"] = (ext.contiguous(),
                            coef.expand(b, 10).contiguous(),
                            zi.contiguous(), "df2t")
    probe = _latency.step_floor(64, {"k1": 1, "k2": 1, "k3": 1}, dev)
    lat, ghz = probe["latency_cycles"], probe["sm_ghz"]
    rows, worst, worst_ref = _iir_rows(torch, I, walks, lat, ghz)
    edges = _iir_edges(torch, I)
    for edge in edges:
        worst = max(worst, *edge["max_abs_err"].values())
        worst_ref = max(worst_ref, *edge["reference_peak_dev"].values())

    # one walk's plain version on the card, the whole length
    x, sos, z0, _ = walks["crackle"]
    y_k = I._sos_forward(x, sos, z0)
    plain_ms, y_p = _timed_once(torch, lambda: I.sos_scan_plain(x, sos, z0))
    plain_card_err = _max_dev(y_k, y_p)
    worst = max(worst, plain_card_err)

    # DF2T lfilter / filtfilt at order 4 through the public functions,
    # with the gradient: card vs CPU
    sig_in = scaled("crackle", "crackle_level")[:, 0]
    xg = sig_in.clone().requires_grad_()
    y = F.filtfilt(bb, ba, xg)
    (y * sig_in).sum().backward()
    xc = sig_in.cpu().clone().requires_grad_()
    yc = F.filtfilt(bb, ba, xc)
    (yc * sig_in.cpu()).sum().backward()
    lf = F.lfilter(bb, ba, sig_in)
    # (card vs CPU: the walks agree bit for bit, the gradient's products
    # with zi and the first samples are summed in another order)
    df2t = {"filtfilt_max_abs": _max_dev(y.detach().cpu(), yc.detach()),
            "filtfilt_grad_max_abs": _max_dev(xg.grad.cpu(), xc.grad),
            "lfilter_max_abs": _max_dev(lf.cpu(),
                                        F.lfilter(bb, ba, sig_in.cpu()))}

    # the simulator's IIR path: its launches, card vs CPU, timed
    torch.cuda.synchronize()
    I.reset_launch_count()
    got = A.simulate_batch(torch.Generator().manual_seed(31), clean_d, rate,
                           filter_mode="iir")
    torch.cuda.synchronize()
    launches = {"forward": I.launch_count, "adjoint": I.adjoint_launch_count}
    want = A.simulate_batch(torch.Generator().manual_seed(31), clean, rate,
                            filter_mode="iir")
    sim_err = _max_dev(got.cpu(), want)

    def degrade(mode):
        return lambda: A.apply_artifacts(clean_d, draws_d, rate,
                                         filter_mode=mode)

    iir_ms = _cuda_ms(torch, degrade("iir"), 5)
    fir_ms = _cuda_ms(torch, degrade("fir"), 5)
    walk_ms = {r["walk"]: r["ms"] for r in rows}
    traced = _iir_profile(torch, degrade("iir"))

    # scipy's sosfiltfilt of the same three filters on the host CPU
    host = {}
    for name, design, arr in (
            ("crackle", (4, 2500.0, "high"),
             scaled("crackle", "crackle_level")),
            ("rumble", (4, 100.0, "low"), scaled("rumble", "rumble_level")),
            ("rolloff_7khz", (3, 7000.0, "low"), mix)):
        s64 = sig.butter(design[0], design[1] / (rate / 2), btype=design[2],
                         output="sos")
        arr = arr.cpu().numpy()
        host[name] = _host_ms(lambda: sig.sosfiltfilt(s64, arr, axis=-1))[0]
    row = {"phase": "iir", "shape": [b, 1, t], "rate": rate,
           "walks": rows, "edges": edges, "kernel_vs_plain_max_abs": worst,
           "kernel_vs_plain_tol": IIR_TOL,
           "reference_peak_dev": worst_ref, "reference_tol": IIR_REF_TOL,
           "plain_on_card": {"walk": "crackle", "ms": plain_ms,
                             "max_abs_err": plain_card_err},
           "df2t_card_vs_cpu": df2t, "simulate_launches": launches,
           "simulate_card_vs_cpu_max_abs": sim_err,
           "simulate_tol": IIR_SIM_TOL,
           "degradation_ms": {"iir": iir_ms, "fir": fir_ms,
                              "iir_six_walks": 2 * sum(
                                  walk_ms[k] for k in ("crackle", "rumble",
                                                       "rolloff"))},
           "degradation_traced": traced,
           "latency_cycles": lat, "sm_clock": probe["sm_clock"],
           "scipy_sosfiltfilt_host_ms": host, "host_cpu": _host_cpu()}
    emit(row)
    if not (worst <= IIR_TOL and worst_ref <= IIR_REF_TOL
            and sim_err <= IIR_SIM_TOL
            and max(df2t.values()) <= IIR_SIM_TOL
            and launches == {"forward": 6, "adjoint": 0}
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"IIR path failed: {row}")
    crackle = rows[0]
    return {"name": "iir_scan", "route": "cuda",
            "source": "ml_audio_restoration_torch/csrc/iir_scan.cu",
            "replaces": "ml_audio_restoration_tpu/ops/filters.py:94",
            "launches": launches["forward"], "max_abs_err": worst,
            "ms": crackle["ms"], "plain_ms": plain_ms,
            "bound_ms": crackle["bound_ms"], "bound_by": crackle["bound_by"],
            "library_ms": None, "floor_ms": crackle["floor_ms"],
            "shapes": rows, "path_launches": {"iir": launches["forward"]}}


# -------------------------------------------------- resuming a JAX run
RESUME_FILES = 48   # 2 s items: 2 batches of 16 an epoch, a validation set


def _resume_jax_family(torch, name, root, **train):
    """One family through a JAX-layout resume: trainer A takes 3 steps,
    is written as checkpoint_epoch_1.msgpack (jax_checkpoint_payload), and
    goes on through train() for one epoch of 2 steps (the uninterrupted
    run); train_from_config in a fresh directory resumes the file and runs
    the same epoch. Both must end equal bit for bit."""
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.train.trainer import (
        build_trainer, train_from_config)

    def config(ckpt_dir):
        cfg = _train_config(name, root, ckpt_dir, 16, 2.0)
        cfg.train.num_epochs = 2
        for k, v in train.items():
            setattr(cfg.train, k, v)
        if name == "denoiser":
            cfg.data.data_dir = os.path.join(root, "mono")
        return cfg

    a = build_trainer(config("ck_a"), steps_per_epoch=2)
    # three steps on batches of another loader, so that a's own loader
    # starts its epoch where the resumed run's fresh one does
    two = _loader_batches(build_trainer(config("ck_x"), steps_per_epoch=2),
                          2)
    for i, batch in enumerate(two + two[:1]):
        a._train_step(batch, a._seeded(99, i))
        a.global_step += 1
    a.epoch = 1
    path = write_jax_checkpoint(
        a, os.path.join(root, "ck_b", name, "checkpoint_epoch_1.msgpack"))
    a.train()
    L.reset_launch_count()
    history = train_from_config(config("ck_b"), steps_per_epoch=2)
    launches = {"lstm_train_fwd": L.train_fwd_launch_count,
                "lstm_train_bwd": L.train_bwd_launch_count}
    b = build_trainer(config("ck_b"), steps_per_epoch=2)
    # BN's num_batches_tracked is not in the JAX layout (it loads as 0) and
    # no model reads it (they run BN at a fixed momentum)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    same = (all(torch.equal(sa[k], sb[k]) for k in sa
                if not k.endswith("num_batches_tracked"))
        and all(torch.equal(sa[k], sb[k]) for sa, sb in zip(
            a.optimizer.state_dict()["state"].values(),
            b.optimizer.state_dict()["state"].values()) for k in sa)
        and history == a.history
        and (b.ema_params is None) == (a.ema_params is None)
        and all(torch.equal(a.ema_params[k], b.ema_params[k])
                for k in (a.ema_params or {})))
    return {"family": name, "leaves": len(
        jax_checkpoint_payload(a)["opt_state"]["leaves"]),
        "written": path.name, "resumed_files": sorted(os.listdir(
            os.path.join(root, "ck_b", name))),
        "steps": [b.global_step, a.global_step], "history": history,
        "bit_for_bit": same, "launches": launches, **train}


def phase_resume_jax(torch):
    """Resuming a JAX training run at full width: the stereo separator
    (batch 16 of 2 s, K2/K3 at T=44,100 B=16; Adam without clipping, the
    7 + 2N leaf layout) and the denoiser with max_grad_norm 1 and EMA
    0.995 (3 + 2N); each resumed run's next 2 steps bit for bit the
    uninterrupted run's."""
    with tempfile.TemporaryDirectory() as tmp:
        _write_corpus(os.path.join(tmp, "wavs"), files=RESUME_FILES,
                      seconds=2.5)
        _write_mono_corpus(os.path.join(tmp, "mono"), RESUME_FILES, 2.5,
                           22050)
        rows = [_resume_jax_family(torch, "stereo_separator", tmp),
                _resume_jax_family(torch, "denoiser", tmp,
                                   max_grad_norm=1.0, ema_decay=0.995)]
    emit({"phase": "resume_jax", "families": rows})
    st = rows[0]["launches"]
    if not (all(r["bit_for_bit"] for r in rows)
            and [r["leaves"] for r in rows] == [7 + 2 * 68, 3 + 2 * 70]
            and all("checkpoint_epoch_1.msgpack" in r["resumed_files"]
                    for r in rows)
            and st == {"lstm_train_fwd": 2, "lstm_train_bwd": 2}):
        raise AssertionError(f"JAX resume failed: {rows}")
    return st


# ------------------------------------------------------- library functions
LIB_FFT_TOL = 1e-5  # istft(stft(x)), card vs CPU, of the clip's peak
TRANSIENT_LOSS_RTOL = 1e-5  # the transient loss, card vs CPU
TRANSIENT_GRAD_L2 = 2e-3    # its gradient, relative L2: about five times
#                             the reading on the H100 (3.9e-4; the
#                             log-spectral term weighs each bin by 1/|S|)


def phase_library(torch):
    """istft(stft(x)) of the 120 s clip (n_fft 2048, hop 512) and
    transient_spectral_loss with its gradient on 16 x 2 s at 44.1 kHz,
    each on the card against the CPU."""
    from ml_audio_restoration_torch.losses import (
        detect_transients, transient_spectral_loss)
    from ml_audio_restoration_torch.ops import istft, stft

    clip = torch.from_numpy(_clip(120.0, 22050, seed=41))
    n_fft, hop = 2048, 512

    def roundtrip(x):
        return istft(stft(x, n_fft, hop), n_fft, hop, length=x.shape[-1])

    card = roundtrip(clip.cuda())
    cpu = roundtrip(clip)
    fft_ms = _cuda_ms(torch, lambda: roundtrip(clip.cuda()), 3)
    x = torch.from_numpy(_stereo_batch(16, 88200, seed=42)["stereo"])
    out, target = x[:, :1].transpose(1, 2), x[:, 1:].transpose(1, 2)

    def loss_and_grad(o, tgt):
        o = o.clone().requires_grad_()
        loss = transient_spectral_loss(o, tgt)
        loss.backward()
        return loss.detach(), o.grad, detect_transients(tgt[:, :, 0])

    lc, gc, mc = loss_and_grad(out.cuda(), target.cuda())
    lh, gh, mh = loss_and_grad(out, target)
    loss_ms = _cuda_ms(torch, lambda: loss_and_grad(out.cuda(),
                                                    target.cuda()), 3)
    row = {"phase": "library",
           "istft_shape": list(card.shape),
           "istft_card_vs_cpu_max_abs": _max_dev(card.cpu(), cpu),
           "istft_roundtrip_max_abs": _max_dev(cpu, clip[:, :cpu.shape[1]]),
           "istft_tol": LIB_FFT_TOL * float(clip.abs().max()),
           "stft_istft_ms": fft_ms,
           "transient_loss": [float(lc), float(lh)],
           "transient_loss_rtol": TRANSIENT_LOSS_RTOL,
           "transient_grad_rel_l2": _rel_l2(gc.cpu(), gh),
           "transient_grad_tol": TRANSIENT_GRAD_L2,
           "transient_mask_agree": float((mc.cpu() == mh).float().mean()),
           "transient_loss_grad_ms": loss_ms}
    emit(row)
    if not (row["istft_card_vs_cpu_max_abs"] <= row["istft_tol"]
            and abs(float(lc) - float(lh)) <= TRANSIENT_LOSS_RTOL * abs(
                float(lh))
            and row["transient_grad_rel_l2"] <= TRANSIENT_GRAD_L2
            and card.shape[1] == hop * (clip.shape[1] // hop)):
        raise AssertionError(f"library check failed: {row}")


# ----------------------------------------------------------------- profile
PROFILE_K1_REL = 0.05  # the recurrence bucket against K1's kernel_time


def phase_profile(torch, k1_ms: float):
    """utils.profiling.trace around a warm default 120 s restore, then
    around one stereo train step at full width (batch 16 of 2 s), each
    read with trace_device_times and trace_top_ops: the kernels' total is
    at most the wall time, K1 tops the restore's recurrence bucket, and the
    bucket is within 5% of K1's time from phase kernels."""
    from ml_audio_restoration_torch.models import StereoSeparator
    from ml_audio_restoration_torch.pipeline import RestorationPipeline
    from ml_audio_restoration_torch.utils import profiling as P

    dev = torch.device("cuda")
    dn, sr, st = _models(torch, dev)
    pipe = RestorationPipeline(dn, sr, st)
    rate = pipe.config.sample_rate
    clip = _clip(120.0, rate, seed=3)
    pipe.restore(clip, rate)  # warm
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("restore", "train_step"):
            logdir = os.path.join(tmp, name)
            if name == "restore":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with P.trace(logdir):  # restore() opens its own span
                    pipe.restore(clip, rate)
            else:
                model = StereoSeparator().to(dev)
                tr = _train_trainer(torch, model, dev, learning_rate=1e-4)
                batch = _stereo_batch(16, 44100, seed=5)
                tr._train_step(batch)  # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with P.trace(logdir):
                    with P.annotate("train_step"):
                        tr._train_step(batch)
            wall = (time.perf_counter() - t0) * 1e3
            times = P.trace_device_times(logdir)
            top = P.trace_top_ops(logdir, 8)
            out[name] = {"wall_ms_traced": wall, "device_times": times,
                         "top_ops": top,
                         "top_recurrence": next(
                             (op for op in top
                              if P.bucket(op[0]) == "recurrence"), None)}
            if name == "restore":
                # every kernel of the restore's elementwise bucket
                out[name]["elementwise_ops"] = [
                    op for op in P.trace_top_ops(logdir, 10 ** 4)
                    if P.bucket(op[0]) == "fusion(elementwise)"]
    row = {"phase": "profile", **out, "k1_kernel_time_ms": k1_ms}
    emit(row)
    rs = out["restore"]
    rec = rs["device_times"].get("recurrence", 0.0)
    k1 = rs["top_recurrence"]
    if not (0 < rs["device_times"]["total_device_ms"] <= rs["wall_ms_traced"]
            and k1 is not None and "lstm_recurrence" in k1[0]
            and abs(rec - k1_ms) <= PROFILE_K1_REL * k1_ms
            and out["train_step"]["device_times"]["total_device_ms"]
            <= out["train_step"]["wall_ms_traced"]):
        raise AssertionError(f"profile check failed: {row}")


# ------------------------------------------------ JAX-layout checkpoints
def jax_checkpoint_payload(tr) -> dict:
    """The payload the JAX trainer's save_checkpoint writes for the state
    of port trainer `tr` (test tooling: it lets the card, which has no
    JAX, make a JAX-layout run; the tests hold it leaf for leaf to the
    JAX trainer's own file). The optax leaves are the layout
    `inject_hyperparams` gives: [count, learning_rate, adam_count, *mu,
    *nu] when the config clips, [count, b1, b2, eps, eps_root,
    learning_rate, adam_count, *mu, *nu] when it does not."""
    from ml_audio_restoration_torch.compat.optim import ADAM_DEFAULTS, LeafMap
    from ml_audio_restoration_torch.compat.weights import jax_from_state_dict

    name = tr.model_name
    sd = tr.model.state_dict()
    params, model_state = jax_from_state_dict(name, sd)
    leaf_map = LeafMap(name, tr.model)
    named = list(tr.model.named_parameters())
    states = [tr.optimizer.state.get(p, {}) for _, p in named]

    def leaves(key):
        flat = np.concatenate([
            (s[key].detach().cpu().numpy() if key in s
             else np.zeros(tuple(p.shape), np.float32)).ravel()
            for s, (_, p) in zip(states, named)]).astype(np.float32)
        return [flat[idx] for idx in leaf_map.index]

    step = np.asarray(int(states[0]["step"]) if "step" in states[0] else 0,
                      np.int32)
    lr = np.asarray(tr.lr, np.float32)
    hyper = ([lr] if tr.cfg.max_grad_norm > 0 else
             [np.asarray(ADAM_DEFAULTS[k], np.float32)
              for k in ("b1", "b2", "eps", "eps_root")] + [lr])
    payload = {
        "params": params, "model_state": model_state,
        "opt_state": {"leaves": [step, *hyper, step.copy(),
                                 *leaves("exp_avg"), *leaves("exp_avg_sq")]},
        "epoch": np.asarray(tr.epoch), "global_step": np.asarray(
            tr.global_step),
        "best_val_loss": np.asarray(tr.best_val_loss),
        "lr": np.asarray(tr.lr),
        "history": {k: np.asarray(v, np.float64)
                    for k, v in tr.history.items()},
        "model_name": name, "plateau_wait": np.asarray(tr._plateau_wait)}
    if tr.ema_params is not None:
        ema = {k: v.detach().cpu() for k, v in tr.ema_params.items()}
        payload["ema_params"] = jax_from_state_dict(name, {**sd, **ema})[0]
    return payload


def write_jax_checkpoint(tr, path):
    """`jax_checkpoint_payload(tr)` as a flax msgpack file at `path`."""
    from pathlib import Path

    from ml_audio_restoration_torch.compat import msgpack

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack.dumps(jax_checkpoint_payload(tr)))
    return path


def _timed_phase(fn, *args):
    """Run one phase and print its wall seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase_wall_s": fn.__name__, "seconds": time.perf_counter() - t0})
    return out


def main() -> int:
    if sys.argv[1:2] == ["--train-dp-worker"]:
        return _train_dp_worker(sys.argv[2], int(sys.argv[3]))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import ml_audio_restoration_torch  # noqa: F401  (fail before any output)

    _count_epilogue_route()
    phase_device(torch)
    _timed_phase(phase_build)
    rows = ([_timed_phase(phase_kernels, torch)]
            + _timed_phase(phase_train_kernels, torch))
    main_epilogues = _timed_phase(phase_main, torch, rows[0])
    _timed_phase(phase_grad, torch)
    _timed_phase(phase_train_small, torch)
    launches = _timed_phase(phase_train_full, torch)
    _timed_phase(phase_train_convnets, torch)
    bf16 = _timed_phase(phase_train_bf16, torch)
    _timed_phase(phase_train_semi, torch)
    dp = _timed_phase(phase_train_dp, torch)
    files = _timed_phase(phase_files, torch)
    for row in rows[1:]:
        # the f32 training step's run, the bf16 preset's, then a rank's of
        # the data-parallel run (each its shape)
        row["launches"] = launches[row["name"]]
        for shape, n in zip(row["shapes"], (launches, bf16, dp)):
            shape["launches"] = n[row["name"]]
        row["path_launches"] = {"train_full": launches[row["name"]],
                                "train_bf16": bf16[row["name"]],
                                "train_dp_rank0": dp[row["name"]],
                                "files_train_flac": files["k2k3"][row["name"]]}
    k1 = _timed_phase(phase_k1_shapes, torch, files["evaluate_shape"])
    paths = {"serve_fast": _timed_phase(phase_serve_fast, torch, k1)}
    paths.update((f"serve_{k}", v)
                 for k, v in _timed_phase(phase_serve_options, torch).items())
    paths.update({
        "serve_many": _timed_phase(phase_serve_many, torch),
        "stream": _timed_phase(phase_stream, torch, k1)})
    paths.update(files["k1"])
    int8 = _timed_phase(phase_int8, torch)
    paths["int8"] = (int8["k1_launches"], None, None)
    paths["int8_preset"] = (int8["k1_preset_launches"], None, None)
    serve = _timed_phase(phase_serve, torch)
    serve_int8 = serve.pop("int8_conv")
    paths.update(serve)
    mesh = _timed_phase(phase_serve_mesh, torch)
    mesh_int8 = mesh.pop("int8_conv")
    paths.update(mesh)
    seq = _timed_phase(phase_serve_seq, torch)
    seq_int8 = seq.pop("int8_conv")
    paths.update(seq)
    iir = _timed_phase(phase_iir, torch)
    epilogue = _timed_phase(phase_epilogue, torch)
    resume = _timed_phase(phase_resume_jax, torch)
    for row in rows[1:]:
        row["path_launches"]["resume_jax"] = resume[row["name"]]
    _timed_phase(phase_library, torch)
    _timed_phase(phase_profile, torch, rows[0]["ms"])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K1's new shapes, each with the launches of the run of the path that
    # gives it (a stream feed launches one committed and one lookahead run)
    launches_of = {"train_bf16_validation":
                   bf16["lstm_recurrence_validation"],
                   "serve_fast": paths["serve_fast"][0],
                   "serve_sub_f32": paths["serve_sub_0.25"][0],
                   "serve_source_rate": paths["serve_source_rate"][0],
                   "stream_committed": paths["stream"][0] // 2,
                   "stream_lookahead": paths["stream"][0] // 2,
                   "evaluate_stereo": paths["evaluate_stereo"][0],
                   # a 2-entry mesh launches B=32 twice a restore, a
                   # 3-entry one B=22 once (and B=21 twice)
                   "serve_mesh_2": paths["serve_mesh_2"][0],
                   "serve_mesh_3": 1,
                   # one walk a whole-file restore, whatever the mesh
                   "serve_seq_whole_file": paths["serve_seq_1x4"][0]}
    rows[0]["shapes"] = [
        {**{key: k1[shape][key] for key in (
            "path", "shape", "dtype", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err", "tol", "floor_ms",
            "ctas_per_sm", "waves", "regs_per_thread")},
         # the whole-file walk's plain version ran on its first steps only
         **{k: k1[shape][k] for k in ("plain_steps",) if k in k1[shape]},
         "launches": launches_of[shape]} for shape in k1]
    rows[0]["path_launches"] = {
        "train_bf16_validation": bf16["lstm_recurrence_validation"],
        **{p: v[0] for p, v in paths.items()}}
    # K1 against its plain version: at its own shapes, f32 (bar F32_TOL)
    # apart from bf16 (bar BF16_TOL), and through each path's chain
    for r in k1.values():
        key = "max_abs_err_bf16" if r["dtype"] == "bfloat16" else "max_abs_err"
        rows[0][key] = max(rows[0][key], r["max_abs_err"])
    rows[0]["path_max_abs_err"] = {p: {"max_abs_err": v[1], "tol": v[2]}
                                   for p, v in paths.items()
                                   if v[1] is not None}
    extra = ("max_abs_err_bf16", "shapes", "path_launches", "path_max_abs_err",
             "launches_by_path", "floor_ms")
    rows.append({
        "name": "int8_conv", "route": "cuda",
        "source": "ml_audio_restoration_torch/csrc/int8_conv.cu",
        "replaces": "ml_audio_restoration_tpu/ops/quant.py:103",
        **{k: int8[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")},
        "launches_by_path": int8["launches_by_path"],
        "shapes": [{k: r[k] for k in (
            "layer", "count", "path", "x", "kernel", "stride", "lhs_dilation",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "cudnn_f32_ms", "cudnn_bf16_ms")} for r in int8["layers"]],
        "path_launches": {"int8": int8["launches"],
                          "serve_int8": serve_int8,
                          "serve_mesh_int8": mesh_int8,
                          "serve_seq_int8": seq_int8}})
    rows.append(iir)
    # the conv epilogue: a 120 s restore program's launches, and each
    # path's, held to the route (EPILOGUE_ROUTE) and the walks
    epilogue["launches"] = main_epilogues
    epilogue["path_launches"] = {p: r["launches"]
                                 for p, r in sorted(EPILOGUE_PATHS.items())}
    rows.append(epilogue)
    failures = _epilogue_failures(paths)
    emit({"phase": "epilogue_paths", "readings": EPILOGUE_PATHS,
          "walk_stages": EPILOGUE_WALK_STAGES, "failures": failures})
    emit({"kernels": [{key: row[key] for key in keys + tuple(
        k for k in extra if k in row)} for row in rows]})
    if failures:
        raise AssertionError(f"conv epilogue off its route: {failures}")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
