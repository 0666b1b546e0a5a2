"""The port's evaluate.py against the JAX package's, per file.

Both packages get the same narrow-width weights and FLAC files (two
recordings of 0.5 s; a mono one and the stereo ones for the stereo
evaluation). JAX draws its 78rpm degradation from `jax.random`, which a
`torch.Generator` cannot reproduce, so the port's simulator is patched to
return JAX's degraded array for file i (the port seeds file i's CPU
generator with seed + i; nothing in the JAX package changes). JAX's
per-file rows are read by patching its `_mean_rows`.

Bar: each per-file metric within 1e-3 of JAX's (dB for SNR, SI-SDR and
LSD; the spectral distance and the stereo correlation / width are
unitless), the chain's bar carried over to its metrics. Read here: up to
1.1e-4 (the linear baseline's LSD, whose log spectra weigh near-empty
bins), the rest 6e-5 or less.
"""
import json

import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu import evaluate as jev
from ml_audio_restoration_tpu.config import PipelineConfig as JaxConfig
from ml_audio_restoration_tpu.pipeline import RestorationPipeline as JaxPipe
from ml_audio_restoration_torch import cli
from ml_audio_restoration_torch import evaluate as ev
from ml_audio_restoration_torch.audio import save_audio
from ml_audio_restoration_torch.compat import save_pth, state_dict_from_jax
from ml_audio_restoration_torch.config import PipelineConfig
from ml_audio_restoration_torch.pipeline import RestorationPipeline
from test_torch_models import jax_model, port_model
from test_torch_pipeline import CHUNKED, SMALL

ROW_BAR = 1e-3
SECONDS = 0.5


@pytest.fixture(scope="module")
def stages():
    rng = np.random.default_rng(11)
    return {name: jax_model(name, i, rng, **cfg)[1]
            for i, (name, cfg) in enumerate(SMALL.items())}


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """FLACs at 44.1 kHz: two mono recordings, and a stereo directory of
    two true stereo files and one with equal channels (skipped)."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(2)
    t = np.arange(int(44100 * SECONDS)) / 44100
    for i in range(2):
        x = (0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t)
             + 0.05 * rng.normal(size=t.size)).astype(np.float32)
        save_audio(root / "mono" / f"m{i}.flac", x[None], 44100)
        side = 0.1 * rng.normal(size=t.size)
        save_audio(root / "stereo" / f"s{i}.flac",
                   np.stack([x + side, x - side]).astype(np.float32), 44100)
    save_audio(root / "stereo" / "z_dual_mono.flac",
               np.stack([x, x]).astype(np.float32), 44100)
    return root


def _pipes(stages, name):
    key = {"denoiser": "denoiser", "super_resolution": "super_resolution",
           "stereo_separator": "stereo"}[name]
    jax_pipe = JaxPipe(**{key: stages[name]}, config=JaxConfig(**CHUNKED))
    port = RestorationPipeline(**{key: port_model(name, *stages[name])},
                               config=PipelineConfig(**CHUNKED), device="cpu")
    return jax_pipe, port


def _jax_rows(monkeypatch, fn, *args, **kw):
    rows = []

    def capture(r, ndigits=2):
        rows.extend(r)
        return {}

    monkeypatch.setattr(jev, "_mean_rows", capture)
    fn(*args, **kw)
    monkeypatch.undo()
    return rows


def _assert_rows_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert abs(g[k] - w[k]) < ROW_BAR, (k, g[k], w[k])
            assert np.isfinite(g[k])


def test_denoiser_rows_match_jax(stages, eval_dirs, monkeypatch):
    files = sorted((eval_dirs / "mono").glob("*.flac"))
    jax_pipe, port = _pipes(stages, "denoiser")
    degraded = []
    real_sim = jev.simulate_vinyl_artifacts

    def keep(*args, **kw):
        degraded.append(np.asarray(real_sim(*args, **kw)))
        return degraded[-1]

    monkeypatch.setattr(jev, "simulate_vinyl_artifacts", keep)
    want = _jax_rows(monkeypatch, jev.evaluate_denoiser, jax_pipe, files,
                     seconds=SECONDS, seed=4)
    seeds = []

    def jax_draws(gen, clean, sample_rate, cfg=None):
        seeds.append(gen.initial_seed())
        assert gen.device.type == "cpu" and clean.shape == (1, 11025)
        return torch.from_numpy(degraded[gen.initial_seed() - 4].copy())

    monkeypatch.setattr(ev, "simulate_vinyl_artifacts", jax_draws)
    got = ev.denoiser_rows(port, files, seconds=SECONDS, seed=4)
    assert seeds == [4, 5]
    _assert_rows_close(got, want)
    mean = ev.evaluate_denoiser(port, files, seconds=SECONDS, seed=4)
    assert mean["num_files"] == 2 and "snr_improvement_db" in mean


def test_super_resolution_rows_match_jax(stages, eval_dirs, monkeypatch):
    files = sorted((eval_dirs / "mono").glob("*.flac"))
    jax_pipe, port = _pipes(stages, "super_resolution")
    want = _jax_rows(monkeypatch, jev.evaluate_super_resolution, jax_pipe,
                     files, seconds=SECONDS)
    _assert_rows_close(ev.super_resolution_rows(port, files,
                                                seconds=SECONDS), want)


def test_stereo_rows_match_jax(stages, eval_dirs, monkeypatch):
    files = sorted((eval_dirs / "stereo").glob("*.flac"))
    jax_pipe, port = _pipes(stages, "stereo_separator")
    want = _jax_rows(monkeypatch, jev.evaluate_stereo, jax_pipe, files,
                     seconds=SECONDS)
    got = ev.stereo_rows(port, files, seconds=SECONDS)
    assert len(got) == 2  # the dual-mono file is skipped
    _assert_rows_close(got, want)
    assert ev.evaluate_stereo(port, [])["num_files"] == 0


def test_cli_evaluate_on_the_cpu(stages, eval_dirs, tmp_path, capsys):
    """`evaluate` from .pth checkpoints over a FLAC directory prints the
    JAX package's keys."""
    paths = {name: save_pth(tmp_path / f"{name}.pth", name,
                            state_dict_from_jax(name, *stages[name]))
             for name in ("denoiser", "super_resolution")}
    rc = cli.main(["evaluate", "--eval-dir", str(eval_dirs / "mono"),
                   "--denoiser", str(paths["denoiser"]),
                   "--super-res", str(paths["super_resolution"]),
                   "--seconds", str(SECONDS), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and set(out) == {"denoiser", "super_resolution"}
    assert out["denoiser"]["num_files"] == 2
    assert set(out["super_resolution"]) == {"lsd_model", "lsd_linear",
                                            "num_files"}
