"""Command-line interface of the port.

    python -m ml_audio_restoration_torch restore in.wav out.wav \
        --denoiser d.pth --super-res sr.pth --stereo st.pth [--device cuda]
    python -m ml_audio_restoration_torch restore in_dir/ out_dir/ \
        --config config/fast_serve.yaml [--coalesce 4]

    python -m ml_audio_restoration_torch stream a.wav b.wav \
        --output-dir streamed/ [--block-seconds 0.5]
    ffmpeg -i live.flac -f f32le -ac 1 -ar 22050 - | \
        python -m ml_audio_restoration_torch stream - --pcm f32le | \
        ffmpeg -f f32le -ac 2 -ar 44100 -i - restored.flac

    python -m ml_audio_restoration_torch train denoiser \
        --data-dir wavs/ [--steps-per-epoch N] [--device cuda]
    python -m ml_audio_restoration_torch train super_resolution \
        --data-dir wavs_44k/ --config config/super_resolution.yaml

`restore` restores one WAV file through the chain, or every WAV of a
directory (coalesced device batches); `stream` feeds recordings block by
block through the streaming restorer, one lockstep stream per input, or
raw mono PCM from stdin to stdout (`-`); `train` trains one model family
on a directory of WAVs: the denoiser on clean mono chunks degraded on the
device, super-resolution on 44.1 kHz chunks downsampled on the device, the
stereo separator on stereo chunks. All run on the card unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import sys


def _add_restore(sub):
    p = sub.add_parser("restore", help="restore one 78rpm recording (WAV)")
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
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="compute dtype")
    p.add_argument("--stereo-chunk-seconds", type=float, default=None,
                   help="internal stereo LSTM window in seconds")
    p.add_argument("--stereo-mid-exact", action="store_true",
                   help="rebuild L/R around the true mid (out = mid +/- "
                        "the predicted side)")
    p.add_argument("--stereo-source-rate", action="store_true",
                   help="run the stereo stage on the pre-super-res signal "
                        "and upsample only its side (implies mid-exact)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    return p


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
    if args.stereo_mid_exact:
        config.stereo_mid_exact = True
    if args.stereo_source_rate:
        config.stereo_source_rate = True
    pipe = RestorationPipeline.from_checkpoints(
        denoiser_path=None if args.no_denoise else args.denoiser,
        super_res_path=None if args.no_super_res else args.super_res,
        stereo_path=None if args.no_stereo else args.stereo,
        config=config, device=args.device)
    if os.path.isdir(args.input):
        results = pipe.restore_directory(args.input, args.output,
                                         coalesce=args.coalesce)
        for out, rate in results:
            print(f"restored -> {out} @ {rate} Hz")
        print(f"{len(results)} files restored")
    else:
        out, rate = pipe.restore_file(args.input, args.output)
        print(f"restored -> {out} @ {rate} Hz")
    return 0


def _add_stream(sub):
    p = sub.add_parser(
        "stream", help="block-fed (streaming) restore of recordings")
    p.add_argument("inputs", nargs="+",
                   help="input WAVs, each one lockstep stream of the "
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
        device=args.device)
    block = max(1, int(round(args.block_seconds * args.sample_rate)))
    if pipe:
        return _stream_pipe(args, restorer, block)

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
                   help="size of the data-parallel axis (1 only so far)")
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
    return p


def _cmd_train(args):
    from .config import load_config
    from .train.trainer import train_from_config

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ml_audio_restoration_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_restore(sub).set_defaults(func=_cmd_restore)
    _add_stream(sub).set_defaults(func=_cmd_stream)
    _add_train(sub).set_defaults(func=_cmd_train)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
