"""Impulse analytics for real 78rpm recordings, the port's copy of
ml_audio_restoration_tpu/audio/analyze.py (host-side numpy and scipy):

- detect_impulses_analytical: second-difference peaks above a percentile,
  at least 1 ms apart, with summary statistics (AdaptiveArtifactDataset
  fits the simulator's impulse rate and amplitude with it);
- analyze_frequency_content: impulse-window vs background spectra;
- analyze_78rpm_recording: both for one recording, optional plots
  (skipped without matplotlib);
- compare_synthetic_vs_real: the simulator's impulse statistics, on the
  caller's device, against a real recording's.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .io import load_audio


def detect_impulses_analytical(audio, sample_rate: int,
                               threshold_percentile: float = 99.5
                               ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """audio [C, T] (the first channel is used) or [T] -> (peak indices,
    amplitudes, stats): peaks of |second difference| above its
    `threshold_percentile` percentile, at least 1 ms apart."""
    from scipy import signal

    x = np.asarray(audio)
    if x.ndim > 1:
        x = x[0]

    d1 = np.diff(x, prepend=x[0])
    d2 = np.abs(np.diff(d1, prepend=d1[0]))

    threshold = np.percentile(d2, threshold_percentile)
    peaks, _ = signal.find_peaks(
        d2, height=threshold, distance=int(sample_rate * 0.001))
    amplitudes = d2[peaks]

    stats = {
        "num_impulses": int(len(peaks)),
        "impulses_per_second": len(peaks) / (len(x) / sample_rate),
        "mean_amplitude": (float(np.mean(amplitudes)) if len(amplitudes)
                           else 0.0),
        "median_amplitude": (float(np.median(amplitudes)) if len(amplitudes)
                             else 0.0),
        "max_amplitude": float(np.max(amplitudes)) if len(amplitudes) else 0.0,
        "std_amplitude": float(np.std(amplitudes)) if len(amplitudes) else 0.0,
        "threshold_used": float(threshold),
    }
    if len(peaks) > 1:
        intervals = np.diff(peaks) / sample_rate
        stats["mean_interval"] = float(np.mean(intervals))
        stats["median_interval"] = float(np.median(intervals))
        stats["min_interval"] = float(np.min(intervals))
    return peaks, amplitudes, stats


def analyze_frequency_content(audio, sample_rate: int,
                              impulse_locations: np.ndarray,
                              window_size: int = 512,
                              seed: int = 0) -> Dict:
    """Average spectra of impulse windows vs background windows."""
    x = np.asarray(audio)
    if x.ndim > 1:
        x = x[0]
    half = window_size // 2
    rng = np.random.default_rng(seed)

    impulse_windows = [
        x[loc - half:loc + half]
        for loc in impulse_locations if half < loc < len(x) - half
    ]
    if not impulse_windows:
        return {}

    safe = int(sample_rate * 0.01)
    background_windows = []
    for _ in range(len(impulse_windows)):
        for _attempt in range(1000):
            start = rng.integers(half, len(x) - half)
            if np.all(np.abs(impulse_locations - start) > safe):
                background_windows.append(x[start - half:start + half])
                break
    if not background_windows:
        return {}

    imp_fft = np.mean([np.abs(np.fft.rfft(w)) for w in impulse_windows],
                      axis=0)
    bg_fft = np.mean([np.abs(np.fft.rfft(w)) for w in background_windows],
                     axis=0)
    freqs = np.fft.rfftfreq(window_size, 1 / sample_rate)
    ratio = imp_fft / (bg_fft + 1e-8)
    return {
        "freqs": freqs,
        "impulse_spectrum": imp_fft,
        "background_spectrum": bg_fft,
        "energy_ratio": ratio,
        "high_freq_emphasis": float(np.mean(ratio[freqs > 2000])),
        "mid_freq_emphasis": float(
            np.mean(ratio[(freqs > 500) & (freqs < 2000)])),
    }


def analyze_78rpm_recording(audio_path, sample_rate: int = 22050,
                            plot: bool = False) -> Dict:
    """Impulse and frequency analysis of one recording, printed and
    returned."""
    print(f"\nAnalyzing: {audio_path}")
    audio, _ = load_audio(audio_path, sample_rate, mono=True)
    duration = audio.shape[-1] / sample_rate
    print(f"Duration: {duration:.2f} seconds")

    peaks, amplitudes, stats = detect_impulses_analytical(audio, sample_rate)
    print("\nImpulse statistics:")
    print(f"  total impulses: {stats['num_impulses']}")
    print(f"  impulses/second: {stats['impulses_per_second']:.2f}")
    print(f"  mean amplitude: {stats['mean_amplitude']:.6f}")
    print(f"  max amplitude: {stats['max_amplitude']:.6f}")
    if "mean_interval" in stats:
        print(f"  mean interval: {stats['mean_interval']:.3f}s")

    freq = analyze_frequency_content(audio, sample_rate, peaks)
    if freq:
        print("\nFrequency analysis:")
        print(f"  high-freq emphasis (>2kHz): "
              f"{freq['high_freq_emphasis']:.2f}x")
        print(f"  mid-freq emphasis (0.5-2kHz): "
              f"{freq['mid_freq_emphasis']:.2f}x")

    if plot and len(peaks):
        _plot_analysis(audio_path, audio, sample_rate, peaks, amplitudes,
                       stats, freq)

    return {
        "audio_path": str(audio_path),
        "duration": duration,
        "impulse_stats": stats,
        "frequency_analysis": freq,
        "peaks": peaks,
        "amplitudes": amplitudes,
    }


def _plot_analysis(audio_path, audio, sample_rate, peaks, amplitudes, stats,
                   freq):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plots")
        return

    x = np.asarray(audio)[0]
    fig, axes = plt.subplots(3, 1, figsize=(12, 10))
    t = np.arange(len(x)) / sample_rate
    axes[0].plot(t, x, alpha=0.7, linewidth=0.5)
    axes[0].scatter(peaks / sample_rate, x[peaks], color="red", s=10,
                    alpha=0.5, label="detected impulses")
    axes[0].set_title(f"Waveform with {len(peaks)} detected impulses")
    axes[0].legend()

    axes[1].hist(amplitudes, bins=50, alpha=0.7, edgecolor="black")
    axes[1].axvline(stats["mean_amplitude"], color="red", linestyle="--")
    axes[1].set_title("Impulse amplitude distribution")

    if freq:
        axes[2].semilogy(freq["freqs"], freq["impulse_spectrum"],
                         label="impulse", alpha=0.7)
        axes[2].semilogy(freq["freqs"], freq["background_spectrum"],
                         label="background", alpha=0.7)
        axes[2].set_title("Impulses vs background spectra")
        axes[2].legend()

    plt.tight_layout()
    out = (Path(audio_path).parent
           / f"{Path(audio_path).stem}_impulse_analysis.png")
    plt.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"plot saved: {out}")


def compare_synthetic_vs_real(real_audio_path, clean_audio,
                              sample_rate: int = 22050, seed: int = 0,
                              device="cuda") -> Dict:
    """The simulator's impulse statistics against a real recording's: the
    clean audio [C, T] is degraded on `device` with draws from a CPU
    generator seeded `seed`, so every device degrades alike."""
    import torch

    from ..data.artifacts import simulate_vinyl_artifacts
    from ..pipeline.restore import resolve_device

    real = analyze_78rpm_recording(real_audio_path, sample_rate, plot=False)
    clean = torch.as_tensor(np.asarray(clean_audio, np.float32)).to(
        resolve_device(device))
    synthetic = simulate_vinyl_artifacts(
        torch.Generator().manual_seed(seed), clean, sample_rate)
    _, _, synth_stats = detect_impulses_analytical(
        synthetic.cpu().numpy(), sample_rate)

    print("\nReal vs synthetic impulses/second: "
          f"{real['impulse_stats']['impulses_per_second']:.2f} vs "
          f"{synth_stats['impulses_per_second']:.2f}")
    return {"real": real, "synthetic": synth_stats}
