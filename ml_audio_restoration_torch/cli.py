"""Command-line interface of the port.

    python -m ml_audio_restoration_torch restore in.wav out.wav \
        --denoiser d.pth --super-res sr.pth --stereo st.pth [--device cuda]
    python -m ml_audio_restoration_torch restore in_dir/ out_dir/ \
        --config config/fast_serve.yaml [--coalesce 4]
    python -m ml_audio_restoration_torch restore in.wav out.wav \
        --int8 --int8-scales scales.json
    python -m ml_audio_restoration_torch restore in_dir/ out_dir/ \
        --data-parallel 4

    python -m ml_audio_restoration_torch stream a.wav b.wav \
        --output-dir streamed/ [--block-seconds 0.5]
    ffmpeg -i live.flac -f f32le -ac 1 -ar 22050 - | \
        python -m ml_audio_restoration_torch stream - --pcm f32le | \
        ffmpeg -f f32le -ac 2 -ar 44100 -i - restored.flac

    python -m ml_audio_restoration_torch serve --port 8000 \
        --stream-port 8001 --warmup [--device cuda] [--data-parallel 4]

    python -m ml_audio_restoration_torch train denoiser \
        --data-dir wavs/ [--steps-per-epoch N] [--device cuda]
    python -m ml_audio_restoration_torch train super_resolution \
        --data-dir wavs_44k/ --config config/super_resolution.yaml

    python -m ml_audio_restoration_torch analyze recording.flac [--plot]
    python -m ml_audio_restoration_torch evaluate --eval-dir eval/ \
        --denoiser best_model.msgpack [--stereo st.pth] [--device cpu]
    python -m ml_audio_restoration_torch export best_model.msgpack \
        denoiser.pth [--ema]
    python -m ml_audio_restoration_torch acquire internetarchive \
        --output-dir data/raw --max-files 50

`restore` restores one recording through the chain, or every recording of
a directory (coalesced device batches); `stream` feeds recordings block by
block through the streaming restorer, one lockstep stream per input, or
raw mono PCM from stdin to stdout (`-`); `serve` runs the serving daemon
(HTTP restore, hot reload and stats, TCP and WebSocket PCM streams,
pipeline/server.py); `train` trains one model family
on a directory of recordings: the denoiser on clean mono chunks degraded
on the device, super-resolution on 44.1 kHz chunks downsampled on the
device, the stereo separator on stereo chunks; `analyze` prints a
recording's impulse statistics; `evaluate` measures checkpoints' quality
on held-out audio; `export` writes a checkpoint as an upstream `.pth`;
`acquire` downloads eligible stereo training recordings (acquire/).
`train` resumes from the newest checkpoint in its checkpoint directory,
the port's `.pth` or a `.msgpack` the JAX trainer wrote. Recordings are WAV, FLAC, mp3 or ogg; checkpoints are upstream `.pth`
files, the port's trainer checkpoints or the JAX package's `.msgpack`
files. All run on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import sys


def _add_restore(sub):
    p = sub.add_parser("restore", help="restore a 78rpm recording (WAV, "
                       "FLAC, mp3, ogg) or a directory of them")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--denoiser", default="models/checkpoints/best_model.pth")
    p.add_argument("--super-res",
                   default="models/checkpoints/super_resolution/best_model.pth")
    p.add_argument("--stereo",
                   default="models/checkpoints/stereo/best_model.pth")
    p.add_argument("--sample-rate", type=int, default=None)
    p.add_argument("--no-super-res", action="store_true")
    p.add_argument("--no-stereo", action="store_true")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--enhancer", default=None,
                   help="BS-RoFormer state dict (.pth / .ckpt, lucidrains's "
                        "keys) with its widths in the YAML beside it: a "
                        "fourth stage after the stereo stage")
    p.add_argument("--whole-file", action="store_true",
                   help="one unchunked forward over the whole recording")
    p.add_argument("--coalesce", type=int, default=4,
                   help="directory mode: files per device batch "
                        "(restore_many; 1 = one batch a file)")
    p.add_argument("--config", default=None,
                   help="YAML overlay whose `pipeline:` section seeds the "
                        "config (e.g. config/fast_serve.yaml); the flags "
                        "below override it")
    p.add_argument("--chunk-seconds", type=float, default=None)
    p.add_argument("--overlap-seconds", type=float, default=None)
    p.add_argument("--data-parallel", type=int, default=None,
                   help="shard the chunk batch over this many devices")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="compute dtype")
    p.add_argument("--stereo-chunk-seconds", type=float, default=None,
                   help="internal stereo LSTM window in seconds")
    p.add_argument("--no-packed-convs", action="store_true",
                   help="float serving computes the plain layout whatever "
                        "this says (the packed one equals it up to float "
                        "reassociation); with --int8 it disables int8, "
                        "which rides the packed layout")
    p.add_argument("--stereo-mid-exact", action="store_true",
                   help="rebuild L/R around the true mid (out = mid +/- "
                        "the predicted side)")
    p.add_argument("--stereo-source-rate", action="store_true",
                   help="run the stereo stage on the pre-super-res signal "
                        "and upsample only its side (implies mid-exact)")
    _add_int8(p, "int8 serving: the conv stacks in int8 (auto-calibrates "
                 "on the first recording)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    return p


def _add_int8(p, what: str):
    p.add_argument("--int8", action="store_true", help=what)
    p.add_argument("--int8-scales", default=None,
                   help="calibration JSON (the JAX package's format): "
                        "loaded if it exists, else written after "
                        "auto-calibration (and rewritten if its stages no "
                        "longer cover the enabled ones)")


def _mesh(args):
    """The device mesh of --data-parallel N, or None: every card of the
    host (N of them, or it raises naming how many there are), or on
    --device cpu N shards sharing the CPU."""
    if not args.data_parallel:
        return None
    import torch

    from .parallel import make_mesh

    devices = None
    if torch.device(args.device).type == "cpu":
        devices = ["cpu"] * args.data_parallel
    return make_mesh(data_parallel=args.data_parallel, devices=devices)


def _persist_int8_scales(path, restorer):
    """Write auto- or re-calibrated int8 scales to `path`, so later runs
    skip the calibration pass. An existing file is rewritten only when its
    stages no longer cover the restorer's."""
    import os

    from .ops.quant import load_scales_file

    if not path or restorer._int8.scales is None:
        return
    if os.path.exists(path):
        try:
            have = set(load_scales_file(path))
        except (OSError, ValueError):
            have = set()
        if set(restorer._int8.scales) <= have:
            return
    restorer.save_int8_scales(path)


def _cmd_restore(args):
    import os

    from .config import load_config
    from .pipeline import RestorationPipeline

    config = load_config(args.config).pipeline
    # only explicit flags override the YAML overlay
    for flag, field in [("sample_rate", "sample_rate"),
                        ("chunk_seconds", "chunk_seconds"),
                        ("overlap_seconds", "overlap_seconds"),
                        ("dtype", "compute_dtype"),
                        ("stereo_chunk_seconds", "stereo_chunk_seconds")]:
        v = getattr(args, flag)
        if v is not None:
            setattr(config, field, v)
    if args.no_super_res:
        config.enable_super_resolution = False
    if args.whole_file:
        config.whole_file = True
    if args.no_packed_convs:
        config.packed_convs = False
    if args.stereo_mid_exact:
        config.stereo_mid_exact = True
    if args.stereo_source_rate:
        config.stereo_source_rate = True
    if args.int8:
        config.quantize_int8 = True
    mesh = _mesh(args)
    pipe = RestorationPipeline.from_checkpoints(
        denoiser_path=None if args.no_denoise else args.denoiser,
        super_res_path=None if args.no_super_res else args.super_res,
        stereo_path=None if args.no_stereo else args.stereo,
        config=config, device=args.device, enhancer_path=args.enhancer)
    pipe.mesh = mesh
    if args.int8_scales and os.path.exists(args.int8_scales):
        pipe.load_int8_scales(args.int8_scales)
    if os.path.isdir(args.input):
        results = pipe.restore_directory(args.input, args.output,
                                         coalesce=args.coalesce)
        for out, rate in results:
            print(f"restored -> {out} @ {rate} Hz")
        print(f"{len(results)} files restored")
    else:
        out, rate = pipe.restore_file(args.input, args.output)
        print(f"restored -> {out} @ {rate} Hz")
    _persist_int8_scales(args.int8_scales, pipe)
    return 0


def _add_stream(sub):
    p = sub.add_parser(
        "stream", help="block-fed (streaming) restore of recordings")
    p.add_argument("inputs", nargs="+",
                   help="input recordings, each one lockstep stream of the "
                        "batched restorer; or '-' for raw PCM on stdin")
    p.add_argument("--output-dir", default="restored_stream")
    p.add_argument("--denoiser", default="models/checkpoints/best_model.pth")
    p.add_argument("--super-res",
                   default="models/checkpoints/super_resolution/best_model.pth")
    p.add_argument("--stereo",
                   default="models/checkpoints/stereo/best_model.pth")
    p.add_argument("--no-super-res", action="store_true")
    p.add_argument("--no-stereo", action="store_true")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--sample-rate", type=int, default=22050,
                   help="input rate the models expect (files are resampled)")
    p.add_argument("--block-seconds", type=float, default=0.5,
                   help="samples fed a step (output latency ~ block + "
                        "lookahead)")
    p.add_argument("--context", type=int, default=1024,
                   help="history samples re-fed a block (must exceed the "
                        "conv receptive field, ~400)")
    p.add_argument("--lookahead", type=int, default=512,
                   help="future samples required before emitting (ditto)")
    p.add_argument("--stereo-mid-exact", action="store_true",
                   help="rebuild L/R around the true mid (see restore)")
    p.add_argument("--stereo-source-rate", action="store_true",
                   help="stereo stage at the pre-super-res rate (see "
                        "restore)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32", help="compute dtype")
    _add_int8(p, "int8 streaming: the denoiser and SR in int8 "
                 "(auto-calibrates on the first window)")
    p.add_argument("--lstm-impl", choices=["pallas", "scan"], default=None,
                   help="accepted for the JAX package's command line; the "
                        "port's recurrence is its CUDA kernel on the card "
                        "and the plain loop on the CPU")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="shard the stream batch over this many devices "
                        "(stream count must divide evenly)")
    p.add_argument("--pcm", choices=["f32le", "s16le"], default=None,
                   help="pipe mode (single '-' input): raw mono PCM in this "
                        "format on stdin, restored interleaved PCM on stdout "
                        "(headerless, at sample-rate x upscale); status on "
                        "stderr")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    return p


def _stream_pipe(args, restorer, block):
    """Raw mono PCM on stdin -> restored interleaved PCM on stdout, one
    full block a feed (a pipe read may come back short)."""
    import numpy as np

    fmt = args.pcm or "f32le"
    dtype = np.dtype(np.float32 if fmt == "f32le" else np.int16)
    want = block * dtype.itemsize
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer

    def emit(out):
        if out.shape[-1] == 0:
            return
        inter = np.ascontiguousarray(out.T)  # [t, ch] interleaved
        if fmt == "s16le":
            inter = np.clip(np.rint(inter * 32767.0),
                            -32768, 32767).astype(np.int16)
        stdout.write(inter.astype(dtype).tobytes())
        stdout.flush()

    print(f"streaming stdin ({fmt} @ {args.sample_rate} Hz) -> stdout "
          f"({fmt}, {2 if restorer.stereo is not None else 1} ch @ "
          f"{args.sample_rate * restorer.f} Hz), block {block} samples",
          file=sys.stderr)
    pending = b""
    while True:
        buf = stdin.read(want - len(pending))
        pending += buf or b""
        if buf and len(pending) < want:
            continue
        whole = len(pending) // dtype.itemsize * dtype.itemsize
        if whole:
            x = np.frombuffer(pending[:whole], dtype).astype(np.float32)
            if fmt == "s16le":
                x /= 32768.0
            emit(restorer.feed(x))
        pending = pending[whole:]
        if not buf:
            break
    emit(restorer.flush())
    return 0


def _cmd_stream(args):
    import os

    import numpy as np

    from .audio import load_audio, save_audio
    from .pipeline.streaming import StreamingRestorer

    pipe = args.inputs == ["-"]
    if "-" in args.inputs and not pipe:
        raise SystemExit("stream: '-' (pipe mode) must be the only input")
    if pipe and args.data_parallel:
        raise SystemExit("stream: pipe mode is single-stream; "
                         "--data-parallel needs file inputs")
    if args.pcm and not pipe:
        raise SystemExit("stream: --pcm is pipe mode's input format; "
                         "it requires the single '-' input")
    restorer = StreamingRestorer.from_checkpoints(
        denoiser_path=None if args.no_denoise else args.denoiser,
        super_res_path=None if args.no_super_res else args.super_res,
        stereo_path=None if args.no_stereo else args.stereo,
        context=args.context, lookahead=args.lookahead,
        batch=len(args.inputs), mid_exact=args.stereo_mid_exact,
        source_rate=args.stereo_source_rate, compute_dtype=args.dtype,
        lstm_impl=args.lstm_impl, quantize_int8=args.int8,
        int8_scales=(args.int8_scales if args.int8_scales
                     and os.path.exists(args.int8_scales) else None),
        mesh=_mesh(args), device=args.device)
    block = max(1, int(round(args.block_seconds * args.sample_rate)))
    if pipe:
        rc = _stream_pipe(args, restorer, block)
        _persist_int8_scales(args.int8_scales, restorer)
        return rc

    # one lockstep stream per input: shorter recordings ride along
    # zero-padded and are trimmed back to their length on save
    streams = [load_audio(p, sample_rate=args.sample_rate)[0][0]
               for p in args.inputs]
    lengths = [s.shape[0] for s in streams]
    t = max(lengths)
    batch = np.zeros((len(streams), t), np.float32)
    for i, s in enumerate(streams):
        batch[i, :s.shape[0]] = s
    outs = [restorer.feed(batch[:, o:o + block]) for o in range(0, t, block)]
    outs.append(restorer.flush())
    out = np.concatenate([o if o.ndim == 3 else o[None] for o in outs],
                         axis=2)

    os.makedirs(args.output_dir, exist_ok=True)
    out_rate = args.sample_rate * restorer.f
    used = set()
    for i, path in enumerate(args.inputs):
        base = os.path.splitext(os.path.basename(path))[0]
        # two inputs of one basename must not overwrite each other
        name, k = base, 2
        while name in used:
            name, k = f"{base}_{k}", k + 1
        used.add(name)
        dest = os.path.join(args.output_dir, f"{name}_restored.wav")
        save_audio(dest, out[i, :, :lengths[i] * restorer.f], out_rate)
        print(f"streamed -> {dest} @ {out_rate} Hz")
    _persist_int8_scales(args.int8_scales, restorer)
    return 0


def _add_serve(sub):
    p = sub.add_parser(
        "serve",
        help="serving daemon: HTTP restore endpoint + TCP PCM streaming")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="HTTP port (POST /v1/restore, GET /healthz, "
                        "GET /v1/stats); 0 picks a free port")
    p.add_argument("--stream-port", type=int, default=None,
                   help="also serve live PCM streams on this TCP port "
                        "(one lockstep stream slot per connection; 0 "
                        "picks a free port)")
    p.add_argument("--stream-slots", type=int, default=16,
                   help="concurrent stream connections (the batched "
                        "restorer's lockstep batch size)")
    p.add_argument("--lstm-impl", choices=["pallas", "scan"], default=None,
                   help="accepted for the JAX package's command line; the "
                        "port's recurrence is its CUDA kernel on the card "
                        "and the plain loop on the CPU")
    p.add_argument("--block-seconds", type=float, default=0.5,
                   help="stream block clock (output latency ~ block + "
                        "lookahead)")
    p.add_argument("--tick-seconds", type=float, default=None,
                   help="max wait for a full block before a starved live "
                        "stream gets silence (default: wait indefinitely; "
                        "offline/backpressure mode)")
    p.add_argument("--pcm", choices=["f32le", "s16le"], default="f32le",
                   help="stream sample format, both directions")
    p.add_argument("--max-outbox-mb", type=float, default=32.0,
                   help="per-stream output buffer bound; a client that "
                        "falls further behind is dropped so it can't "
                        "stall or bloat the server")
    p.add_argument("--sndbuf-kb", type=int, default=None,
                   help="cap SO_SNDBUF on stream sockets (default: OS "
                        "autotuning, which may kernel-buffer several MB "
                        "per slow client before --max-outbox-mb bites)")
    p.add_argument("--drain-stall-seconds", type=float, default=30.0,
                   help="offline mode only: drop a stream whose client "
                        "makes zero read progress for this long while "
                        "its outbox is above high water")
    p.add_argument("--denoiser", default="models/checkpoints/best_model.pth")
    p.add_argument("--super-res",
                   default="models/checkpoints/super_resolution/best_model.pth")
    p.add_argument("--stereo",
                   default="models/checkpoints/stereo/best_model.pth")
    p.add_argument("--no-super-res", action="store_true")
    p.add_argument("--no-stereo", action="store_true")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--config", default=None,
                   help="YAML overlay whose `pipeline:` section seeds the "
                        "serving config (e.g. config/fast_serve.yaml)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--stereo-chunk-seconds", type=float, default=None)
    p.add_argument("--stereo-mid-exact", action="store_true")
    p.add_argument("--stereo-source-rate", action="store_true")
    _add_int8(p, "int8 serving: the conv stacks in int8 (auto-calibrates "
                 "on the first request or stream window)")
    p.add_argument("--max-queue", type=int, default=8,
                   help="pending HTTP restores before 503 backpressure")
    p.add_argument("--max-coalesce", type=int, default=4,
                   help="queued HTTP restores coalesced into one device "
                        "program (dynamic batching; 1 disables)")
    p.add_argument("--max-body-mb", type=float, default=512.0,
                   help="largest accepted HTTP request body")
    p.add_argument("--request-timeout", type=float, default=600.0,
                   help="504 for a queued restore not served within this")
    p.add_argument("--socket-timeout", type=float, default=120.0,
                   help="per-connection socket read/write window: bounds "
                        "stalled uploads, slow response readers, and "
                        "WebSocket sends to a peer that stopped reading")
    p.add_argument("--warmup", action="store_true",
                   help="run every serving shape before accepting traffic "
                        "(the kernels load and cuDNN picks its algorithms; "
                        "without it the first request of each chunk "
                        "bucket pays that)")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="shard the HTTP pipeline's chunk batch (and the "
                        "stream batch) over this many devices")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    return p


def _cmd_serve(args):
    import os
    import signal
    import threading

    from .config import load_config
    from .pipeline import (RestorationPipeline, RestorationServer,
                           StreamingRestorer, StreamServer)

    config = load_config(args.config).pipeline
    if args.dtype is not None:
        config.compute_dtype = args.dtype
    if args.stereo_chunk_seconds is not None:
        config.stereo_chunk_seconds = args.stereo_chunk_seconds
    if args.no_super_res:
        config.enable_super_resolution = False
    if args.stereo_mid_exact:
        config.stereo_mid_exact = True
    if args.stereo_source_rate:
        config.stereo_source_rate = True
    if args.int8:
        config.quantize_int8 = True
    scales = (args.int8_scales if args.int8_scales
              and os.path.exists(args.int8_scales) else None)
    # one mesh for both frontends
    mesh = _mesh(args)

    dn = None if args.no_denoise else args.denoiser
    sr_ck = None if args.no_super_res else args.super_res
    st = None if args.no_stereo else args.stereo
    pipe = RestorationPipeline.from_checkpoints(
        denoiser_path=dn, super_res_path=sr_ck, stereo_path=st,
        config=config, device=args.device)
    pipe.mesh = mesh
    if scales:
        pipe.load_int8_scales(scales)

    if args.warmup:
        print("warming up: running every serving shape...", flush=True)
        info = pipe.warmup(coalesce=args.max_coalesce)
        print(f"  pipeline: {info['programs']} programs "
              f"(chunk buckets {info['buckets']}) in "
              f"{info['seconds']:.1f}s", flush=True)

    http_srv = RestorationServer(
        pipe, host=args.host, port=args.port,
        max_queue=args.max_queue, max_coalesce=args.max_coalesce,
        max_body_bytes=int(args.max_body_mb * (1 << 20)),
        request_timeout=args.request_timeout,
        socket_timeout=args.socket_timeout, quiet=False)
    http_srv.start()
    print(f"HTTP serving on http://{http_srv.host}:{http_srv.port} "
          f"(POST /v1/restore, GET /healthz, GET /v1/stats)", flush=True)

    stream_srv = None
    if args.stream_port is not None:
        restorer = StreamingRestorer.from_checkpoints(
            denoiser_path=dn, super_res_path=sr_ck, stereo_path=st,
            batch=args.stream_slots,
            mid_exact=args.stereo_mid_exact,
            source_rate=args.stereo_source_rate,
            quantize_int8=args.int8, int8_scales=scales,
            mesh=mesh, lstm_impl=args.lstm_impl,
            compute_dtype=args.dtype or "float32", device=args.device)
        block = max(1, int(round(args.block_seconds * config.sample_rate)))
        if args.warmup:
            sinfo = restorer.warmup(block)
            print(f"  streaming: {sinfo['programs']} programs in "
                  f"{sinfo['seconds']:.1f}s", flush=True)
        stream_srv = StreamServer(restorer, host=args.host,
                                  port=args.stream_port, block=block,
                                  fmt=args.pcm,
                                  tick_seconds=args.tick_seconds,
                                  max_outbox_bytes=int(
                                      args.max_outbox_mb * (1 << 20)),
                                  sndbuf=(args.sndbuf_kb * 1024
                                          if args.sndbuf_kb else None),
                                  drain_stall_seconds=
                                  args.drain_stall_seconds)
        stream_srv.start()
        # one scrape covers both frontends: /v1/stats gains a "stream"
        # block and /metrics flattens it to mlar_stream_*
        http_srv.extra_stats = stream_srv.stats
        # browsers reach the same lockstep engine over WS /v1/stream
        http_srv.stream_addr = (stream_srv.host, stream_srv.port)
        print(f"PCM streaming on tcp://{stream_srv.host}:{stream_srv.port} "
              f"({args.stream_slots} slots, {args.pcm} @ "
              f"{config.sample_rate} Hz in, block {stream_srv.block}) and "
              f"ws://{http_srv.host}:{http_srv.port}/v1/stream", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        print("shutting down", flush=True)
        if stream_srv is not None:
            stream_srv.shutdown()
        http_srv.shutdown()
        _persist_int8_scales(args.int8_scales, pipe)
        if stream_srv is not None:
            # stream-only traffic calibrates the StreamingRestorer, not the
            # HTTP pipeline: persist whichever calibrated, so the next
            # start skips the f32 pass (the files are interchangeable;
            # _persist_int8_scales rewrites only on wider coverage)
            _persist_int8_scales(args.int8_scales, stream_srv.restorer)
    return 0


def _add_train(sub):
    p = sub.add_parser("train", help="train a model")
    p.add_argument("model", choices=["denoiser", "super_resolution",
                                     "stereo_separator"])
    p.add_argument("--config", default=None, help="YAML config overlay")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--chunk-duration", type=float, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--test-audio-dir", default=None)
    p.add_argument("--data-parallel", type=int, default=None,
                   help="size of the data-parallel axis; the port trains on "
                        "one device a process, so it must equal "
                        "--num-processes")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--mixed", action="store_true",
                   help="semi-supervised training on synthetic + real "
                        "degraded audio (requires --degraded-dir)")
    p.add_argument("--degraded-dir", default=None,
                   help="directory of real degraded recordings")
    p.add_argument("--adaptive", action="store_true",
                   help="fit artifact statistics to --degraded-dir recordings")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    # multi-process launch: run the same command once a rank; under
    # torchrun the three values come from its environment
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address host:port "
                        "(auto-detected under torchrun)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host world size")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's rank in the multi-host job")
    return p


def _cmd_train(args):
    from .config import load_config
    from .parallel import distributed as dist
    from .train.trainer import train_from_config

    # before any model or CUDA work; a no-op for one process
    dist.initialize(coordinator_address=args.coordinator,
                    num_processes=args.num_processes,
                    process_id=args.process_id, device=args.device)
    overrides = {"train": {"model": args.model}, "data": {}}
    for field, section in [
        ("batch_size", "train"), ("num_epochs", "train"),
        ("learning_rate", "train"), ("checkpoint_dir", "train"),
        ("test_audio_dir", "train"), ("data_parallel", "train"),
        ("data_dir", "data"), ("chunk_duration", "data"),
    ]:
        v = getattr(args, field)
        if v is not None:
            overrides[section][field] = v
    if args.mixed or args.adaptive:
        overrides["data"]["degraded_dir"] = args.degraded_dir
    cfg = load_config(args.config, overrides)
    dataset_kind = ("adaptive" if args.adaptive
                    else "mixed" if args.mixed else "standard")
    train_from_config(cfg, steps_per_epoch=args.steps_per_epoch,
                      device=args.device, dataset_kind=dataset_kind)
    return 0


def _add_analyze(sub):
    p = sub.add_parser("analyze", help="impulse analytics for a recording")
    p.add_argument("input")
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--plot", action="store_true")
    return p


def _cmd_analyze(args):
    from .audio.analyze import analyze_78rpm_recording

    analyze_78rpm_recording(args.input, sample_rate=args.sample_rate,
                            plot=args.plot)
    return 0


def _add_evaluate(sub):
    from . import evaluate

    p = sub.add_parser(
        "evaluate",
        help="objective quality metrics (SNR/SI-SDR/LSD) for checkpoints")
    return evaluate.add_arguments(p)


def _cmd_evaluate(args):
    from . import evaluate

    return evaluate.run(args)


def _add_export(sub):
    p = sub.add_parser(
        "export",
        help="export a checkpoint to an upstream-format .pth (loadable by "
             "the upstream PyTorch project)")
    p.add_argument("checkpoint",
                   help="a JAX .msgpack or the port's trainer .pth "
                        "(self-describing), or an upstream .pth")
    p.add_argument("output", help="output .pth path")
    p.add_argument("--model",
                   choices=["denoiser", "super_resolution",
                            "stereo_separator"],
                   default=None,
                   help="model family (read from self-describing "
                        "checkpoints; required for an upstream .pth)")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA-averaged weights (checkpoint must "
                        "have been trained with ema_decay > 0)")
    return p


def _fail(message: str) -> int:
    print(f"error: {message}", file=sys.stderr)
    return 2


def _cmd_export(args):
    """Write {"epoch", "model_state_dict"} in the upstream layout, from a
    JAX .msgpack (self-describing), the port's trainer .pth (also
    self-describing, with `model_state_dict` and `ema_params`) or an
    upstream .pth (`--model` names its family)."""
    from .compat import load_pth, save_pth, state_dict_from_jax
    from .train.checkpoints import load_checkpoint, load_msgpack

    src = str(args.checkpoint)
    if src.endswith(".pth"):
        ckpt = load_checkpoint(src)
        if not (isinstance(ckpt, dict) and "model_name" in ckpt):
            if args.model is None:
                return _fail("--model is required for .pth input (.pth "
                             "state_dicts are not self-describing)")
            if args.ema:
                return _fail("--ema needs a native .msgpack checkpoint "
                             "(reference .pth files carry no EMA weights)")
            ckpt = {"model_name": args.model, "model_state_dict":
                    load_pth(src), "epoch": 0}
        name = str(ckpt["model_name"])
        sd = dict(ckpt["model_state_dict"])
        ema = ckpt.get("ema_params")
    else:
        ckpt = load_msgpack(src)
        name = ckpt.get("model_name", args.model)
        if isinstance(name, bytes):
            name = name.decode()
        name = str(name) if name else args.model
        ema = ckpt.get("ema_params")
        sd = state_dict_from_jax(name, ckpt["params"], ckpt["model_state"])
        if ema is not None:
            ema = state_dict_from_jax(name, ema, ckpt["model_state"])
    if args.model and name != args.model:
        return _fail(f"checkpoint is for model {name!r}, not "
                     f"{args.model!r}")
    if args.ema:
        if ema is None:
            return _fail("checkpoint carries no ema_params (trained with "
                         "ema_decay == 0)")
        sd.update((k, v) for k, v in ema.items() if k in sd)
    save_pth(args.output, name, sd, epoch=int(ckpt.get("epoch", 0)))
    print(f"exported {name} -> {args.output}"
          + (" (EMA weights)" if args.ema else ""))
    return 0


def _add_acquire(sub):
    p = sub.add_parser("acquire",
                       help="download eligible stereo training data")
    p.add_argument("source", choices=["internetarchive", "freesound",
                                      "musopen"])
    p.add_argument("--output-dir", default="data/raw")
    p.add_argument("--max-files", type=int, default=50)
    p.add_argument("--freesound-api-key", default=None)
    return p


def _cmd_acquire(args) -> int:
    from .acquire import SCRAPERS, ScraperConfig

    cfg = ScraperConfig(output_dir=args.output_dir,
                        max_files_per_source=args.max_files)
    kwargs = {}
    if args.source == "freesound" and args.freesound_api_key:
        kwargs["api_key"] = args.freesound_api_key
    stats = SCRAPERS[args.source](cfg, **kwargs).run()
    print(f"{args.source}: searched={stats.searched} "
          f"eligible={stats.eligible} downloaded={stats.downloaded} "
          f"skipped={stats.skipped} failed={stats.failed}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ml_audio_restoration_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_restore(sub).set_defaults(func=_cmd_restore)
    _add_stream(sub).set_defaults(func=_cmd_stream)
    _add_serve(sub).set_defaults(func=_cmd_serve)
    _add_train(sub).set_defaults(func=_cmd_train)
    _add_analyze(sub).set_defaults(func=_cmd_analyze)
    _add_evaluate(sub).set_defaults(func=_cmd_evaluate)
    _add_export(sub).set_defaults(func=_cmd_export)
    _add_acquire(sub).set_defaults(func=_cmd_acquire)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
