"""Objective quality evaluation of trained checkpoints, counterpart of
ml_audio_restoration_tpu/evaluate.py:

- denoiser: SNR / SI-SDR / LSD / multi-scale spectral distance of
  restored-vs-clean against degraded-vs-clean, the degradation drawn from
  a CPU `torch.Generator` seeded `seed + i` for file i, so the card and
  the CPU degrade alike;
- super-resolution: LSD of the reconstructed 44.1 kHz audio vs the true
  high-rate signal, against linear-interpolation upsampling;
- stereo: correlation / width of the upmix vs the stereo target.

The metrics run on the pipeline's device. `*_rows` give one row a file,
`evaluate_*` their means.

    python -m ml_audio_restoration_torch.evaluate --eval-dir data/eval \
        --denoiser ckpt/best_model.msgpack [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .audio import find_audio_files, load_audio, normalize_audio
from .config import ArtifactConfig, PipelineConfig
from .data.artifacts import simulate_vinyl_artifacts
from .losses import lsd, multiscale_spectral_loss, si_sdr, snr, stereo_metrics
from .ops import interp_linear
from .pipeline import RestorationPipeline


def _mean_rows(rows, ndigits: int = 2) -> dict:
    """Each metric's mean over the per-file rows; {"num_files": 0} when the
    directory had no usable file."""
    if not rows:
        return {"num_files": 0}
    out = {k: round(float(np.mean([r[k] for r in rows])), ndigits)
           for k in rows[0]}
    out["num_files"] = len(rows)
    return out


def _clip(path, rate: int, seconds: float, mono: bool) -> np.ndarray:
    audio, _ = load_audio(path, rate, mono=mono)
    return np.asarray(normalize_audio(audio))[:, :int(seconds * rate)]


@torch.inference_mode()
def denoiser_rows(pipe: RestorationPipeline, files, sample_rate=22050,
                  seconds=8.0, seed=0,
                  artifact_cfg: ArtifactConfig | None = None) -> list:
    """One row a file: the metrics of the degraded and the restored audio
    against the clean audio."""
    rows = []
    for i, f in enumerate(files):
        clean = torch.from_numpy(_clip(f, sample_rate, seconds, True)).to(
            pipe.device)
        gen = torch.Generator().manual_seed(seed + i)
        degraded = simulate_vinyl_artifacts(gen, clean, sample_rate,
                                            artifact_cfg)
        restored, _ = pipe.restore(degraded, sample_rate)
        c, d, r = clean[0], degraded[0], restored[0, :clean.shape[1]]
        rows.append({
            "snr_degraded": float(snr(d, c)),
            "snr_restored": float(snr(r, c)),
            "sisdr_degraded": float(si_sdr(d, c)),
            "sisdr_restored": float(si_sdr(r, c)),
            "lsd_degraded": float(lsd(d, c)),
            "lsd_restored": float(lsd(r, c)),
            "spec_degraded": float(multiscale_spectral_loss(
                d[None, :, None], c[None, :, None])),
            "spec_restored": float(multiscale_spectral_loss(
                r[None, :, None], c[None, :, None])),
        })
    return rows


def evaluate_denoiser(pipe: RestorationPipeline, files, sample_rate=22050,
                      seconds=8.0, seed=0,
                      artifact_cfg: ArtifactConfig | None = None) -> dict:
    """Mean SNR / SI-SDR / LSD before and after restoration, and the
    improvements (from the unrounded means)."""
    rows = denoiser_rows(pipe, files, sample_rate, seconds, seed,
                         artifact_cfg)
    mean = _mean_rows(rows)
    if rows:
        mean["snr_improvement_db"] = round(
            float(np.mean([r["snr_restored"] - r["snr_degraded"]
                           for r in rows])), 2)
        mean["lsd_improvement_db"] = round(
            float(np.mean([r["lsd_degraded"] - r["lsd_restored"]
                           for r in rows])), 2)
    return mean


@torch.inference_mode()
def super_resolution_rows(pipe: RestorationPipeline, files, high_rate=44100,
                          seconds=8.0) -> list:
    """One row a file: LSD of the model's and of linear interpolation's
    reconstruction of the high-rate audio from its linear (align_corners=
    False) downsample, the reference's training pairing."""
    rows = []
    for f in files:
        high = torch.from_numpy(_clip(f, high_rate, seconds, True)).to(
            pipe.device)
        low = interp_linear(high[None], high.shape[1] // 2)[0]
        restored, _ = pipe.restore(low, high_rate // 2)
        baseline = interp_linear(low[None], high.shape[1])[0]
        rows.append({
            "lsd_model": float(lsd(restored[0, :high.shape[1]], high[0])),
            "lsd_linear": float(lsd(baseline[0], high[0])),
        })
    return rows


def evaluate_super_resolution(pipe: RestorationPipeline, files,
                              high_rate=44100, seconds=8.0) -> dict:
    """Mean LSD of the model against the linear-interpolation baseline."""
    return _mean_rows(super_resolution_rows(pipe, files, high_rate, seconds))


@torch.inference_mode()
def stereo_rows(pipe: RestorationPipeline, files, sample_rate=22050,
                seconds=8.0) -> list:
    """One row a true stereo file (mono files, and stereo ones whose
    channels agree to 1e-6, are skipped): correlation and width of the
    upmix of the channel mean against the target's."""
    rows = []
    for f in files:
        stereo = _clip(f, sample_rate, seconds, False)[:2]
        if stereo.shape[0] == 1 or np.allclose(stereo[0], stereo[1],
                                               atol=1e-6):
            continue
        mono = stereo.mean(axis=0, keepdims=True)
        upmix, _ = pipe.restore(mono, sample_rate)
        got = stereo_metrics(upmix[:, :stereo.shape[1]].T[None])
        want = stereo_metrics(torch.from_numpy(stereo.T[None]).to(
            pipe.device))
        rows.append({
            "correlation_upmix": float(got["correlation"]),
            "correlation_target": float(want["correlation"]),
            "width_upmix": float(got["width"]),
            "width_target": float(want["width"]),
        })
    return rows


def evaluate_stereo(pipe: RestorationPipeline, files, sample_rate=22050,
                    seconds=8.0) -> dict:
    """Mean correlation / width of the upmixes and their targets."""
    return _mean_rows(stereo_rows(pipe, files, sample_rate, seconds),
                      ndigits=3)


def add_arguments(p):
    """The flags of `python -m ml_audio_restoration_torch.evaluate` and of
    the CLI's `evaluate`."""
    p.add_argument("--eval-dir", required=True)
    p.add_argument("--denoiser", default=None)
    p.add_argument("--super-res", default=None)
    p.add_argument("--stereo", default=None)
    p.add_argument("--stereo-eval-dir", default=None)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    return p


def run(args) -> int:
    """Evaluate each checkpoint given and print the results as JSON."""
    files = find_audio_files(args.eval_dir)
    results = {}
    if args.denoiser:
        pipe = RestorationPipeline.from_checkpoints(
            denoiser_path=args.denoiser, config=PipelineConfig(),
            device=args.device)
        results["denoiser"] = evaluate_denoiser(pipe, files,
                                                seconds=args.seconds)
    if args.super_res:
        pipe = RestorationPipeline.from_checkpoints(
            super_res_path=args.super_res, config=PipelineConfig(),
            device=args.device)
        results["super_resolution"] = evaluate_super_resolution(
            pipe, files, seconds=args.seconds)
    if args.stereo:
        sfiles = find_audio_files(args.stereo_eval_dir or args.eval_dir)
        pipe = RestorationPipeline.from_checkpoints(
            stereo_path=args.stereo, config=PipelineConfig(),
            device=args.device)
        results["stereo"] = evaluate_stereo(pipe, sfiles,
                                            seconds=args.seconds)
    print(json.dumps(results, indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="evaluate trained checkpoints")
    return run(add_arguments(p).parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
