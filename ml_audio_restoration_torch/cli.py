"""Command-line interface of the port.

    python -m ml_audio_restoration_torch restore in.wav out.wav \
        --denoiser d.pth --super-res sr.pth --stereo st.pth [--device cuda]

    python -m ml_audio_restoration_torch train stereo_separator \
        --data-dir wavs/ [--steps-per-epoch N] [--device cuda]

`restore` restores one WAV file through the chain; `train` trains the
stereo separator on a directory of stereo WAVs. Both run on the card unless
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
    p.add_argument("--chunk-seconds", type=float, default=None)
    p.add_argument("--overlap-seconds", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    return p


def _cmd_restore(args):
    from .config import PipelineConfig
    from .pipeline import RestorationPipeline

    config = PipelineConfig()
    for flag, field in [("sample_rate", "sample_rate"),
                        ("chunk_seconds", "chunk_seconds"),
                        ("overlap_seconds", "overlap_seconds")]:
        v = getattr(args, flag)
        if v is not None:
            setattr(config, field, v)
    config.enable_super_resolution = not args.no_super_res
    config.whole_file = args.whole_file
    pipe = RestorationPipeline.from_checkpoints(
        denoiser_path=None if args.no_denoise else args.denoiser,
        super_res_path=None if args.no_super_res else args.super_res,
        stereo_path=None if args.no_stereo else args.stereo,
        config=config, device=args.device)
    out, rate = pipe.restore_file(args.input, args.output)
    print(f"restored -> {out} @ {rate} Hz")
    return 0


def _add_train(sub):
    p = sub.add_parser("train", help="train a model (stereo_separator so "
                                     "far)")
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
    cfg = load_config(args.config, overrides)
    train_from_config(cfg, steps_per_epoch=args.steps_per_epoch,
                      device=args.device)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ml_audio_restoration_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_restore(sub).set_defaults(func=_cmd_restore)
    _add_train(sub).set_defaults(func=_cmd_train)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
