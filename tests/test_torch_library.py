"""The port's library functions that no entry point calls, against the JAX
package: `ops.istft` (both overlap-add branches, within 1e-6), the
transient mask and loss of losses/spectral.py (within 1e-5), and the small
helpers (`ops.chunk_signal`, `data.prepare_dataset`,
`MetricsLogger.add_scalars`, `WavInfo.duration`).

The transient loss's gradient is held within 1e-5 of its largest entry on
its time-domain terms (the MSE and the transient-weighted L1: alpha 0.5,
w 0.5, no spectral term). With its multi-scale log-magnitude term the
gradient weighs each STFT bin by 1/(|S| + 1e-5), so the f32 rounding of the
smallest bins, which the two packages' FFTs do not share, moves it: it is
held there as a relative L2 norm at 1.5e-3, about five times the reading
(8.7e-5 for one channel, 3.1e-4 for two).
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu import ops as jops
from ml_audio_restoration_tpu.audio import wav as jwav
from ml_audio_restoration_tpu.data import loader as jloader
from ml_audio_restoration_tpu.losses import spectral as jspec
from ml_audio_restoration_tpu.train.metrics import \
    MetricsLogger as JMetricsLogger
from ml_audio_restoration_torch import ops
from ml_audio_restoration_torch.audio import save_audio, wav
from ml_audio_restoration_torch.data import (
    DataLoader, RestorationDataset, prepare_dataset)
from ml_audio_restoration_torch.losses import (
    detect_transients, spectral, transient_spectral_loss)
from ml_audio_restoration_torch.train.metrics import MetricsLogger

SR = 22050


def _sig(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * 0.2


def _transient_sig(b, t, c=1, seed=0):
    """A quiet tone with a few clicks, [B, T, C]."""
    n = np.arange(t)[None, :, None] / SR
    x = 0.05 * np.sin(2 * np.pi * 440 * n) + _sig((b, t, c), seed) * 0.005
    rng = np.random.default_rng(seed + 1)
    for i in range(b):
        x[i, rng.integers(0, t, 3)] += 0.8
    return x.astype(np.float32)


# ------------------------------------------------------------------ istft
@pytest.mark.parametrize("n_fft,hop,custom_window", [
    (512, 128, False),    # hop divides n_fft: the shifted-add branch
    (2048, 512, False),
    (512, 200, False),    # the scatter branch
    (256, 64, True)])     # a given window takes the scatter branch too
def test_istft_matches_jax(n_fft, hop, custom_window):
    x = _sig((2, 6000))
    spec = np.asarray(jops.stft(jnp.asarray(x), n_fft, hop))
    window = (np.hanning(n_fft).astype(np.float32) + 0.1
              if custom_window else None)
    want = np.asarray(jops.istft(
        jnp.asarray(spec), n_fft, hop, length=6000,
        window=None if window is None else jnp.asarray(window)))
    got = ops.istft(torch.from_numpy(spec), n_fft, hop, length=6000,
                    window=None if window is None else torch.from_numpy(
                        window))
    # 1 + T // hop frames give back hop (T // hop) samples
    assert got.shape == want.shape == (2, hop * (6000 // hop))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6
    if not custom_window and n_fft % hop == 0:
        # the inverse of the port's own stft gives the signal back
        back = ops.istft(ops.stft(torch.from_numpy(x), n_fft, hop), n_fft,
                         hop, length=6000)
        n = back.shape[1]
        assert float((back - torch.from_numpy(x[:, :n])).abs().max()) < 1e-5


def test_istft_without_length_keeps_the_centre_crop():
    spec = np.asarray(jops.stft(jnp.asarray(_sig((1, 3000))), 512, 128))
    want = np.asarray(jops.istft(jnp.asarray(spec), 512, 128))
    got = ops.istft(torch.from_numpy(spec), 512, 128)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6


# -------------------------------------------------------- transient loss
@pytest.mark.parametrize("shape", [(3, 1001), (2, 4096), (1, 7)])
def test_quantile_equals_jnp_quantile(shape):
    x = np.abs(_sig(shape, 3))
    got = spectral._quantile(torch.from_numpy(x), 0.9)
    want = np.asarray(jnp.quantile(jnp.asarray(x), 0.9, axis=-1,
                                   keepdims=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantile_past_torch_quantiles_limit():
    """torch.quantile refuses more than 2^24 elements; the sort route reads
    the same linear interpolation at any length."""
    x = np.abs(_sig((1, (1 << 24) + 3), 4))
    got = spectral._quantile(torch.from_numpy(x), 0.9)
    want = np.asarray(jnp.quantile(jnp.asarray(x), 0.9, axis=-1,
                                   keepdims=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_detect_transients_matches_jax():
    x = _transient_sig(3, 5000)[:, :, 0]
    got = detect_transients(torch.from_numpy(x))
    want = np.asarray(jspec.detect_transients(jnp.asarray(x)))
    assert got.shape == x.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5
    assert float(want.min()) >= 0.0 and float(want.max()) == 1.0


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("alpha,weight", [(0.3, 0.3), (0.5, 0.5)])
def test_transient_spectral_loss_and_gradient_match_jax(channels, alpha,
                                                        weight):
    """(0.3, 0.3) is the default with its spectral term, (0.5, 0.5) the
    time-domain terms alone (module docstring)."""
    target = _transient_sig(2, 4096, channels, seed=5)
    out = target + _sig(target.shape, 6) * 0.3
    loss = jax.value_and_grad(
        lambda o, t: jspec.transient_spectral_loss(
            o, t, alpha=alpha, transient_weight=weight))
    want, want_g = loss(jnp.asarray(out), jnp.asarray(target))
    o = torch.from_numpy(out).requires_grad_()
    got = transient_spectral_loss(o, torch.from_numpy(target), alpha=alpha,
                                  transient_weight=weight)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    g, w = o.grad.numpy(), np.asarray(want_g)
    if alpha + weight == 1.0:
        assert float(np.abs(g - w).max()) <= 1e-5 * float(np.abs(w).max())
    else:
        assert np.linalg.norm(g - w) <= 1.5e-3 * np.linalg.norm(w)


# ----------------------------------------------------------------- helpers
@pytest.mark.parametrize("t,chunk,hop", [(1000, 300, 200), (300, 300, 100),
                                         (50, 300, 200), (1001, 256, 256)])
def test_chunk_signal_matches_jax(t, chunk, hop):
    x = _sig((2, t))
    got, n = ops.chunk_signal(torch.from_numpy(x), chunk, hop)
    want, jn = jops.chunk_signal(jnp.asarray(x), chunk, hop)
    assert n == jn == t
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prepare_dataset_builds_a_shuffling_loader(tmp_path):
    for i in range(3):
        save_audio(str(tmp_path / f"a{i}.wav"), _sig((1, 9000), i), SR)
    got = prepare_dataset(tmp_path, batch_size=2, num_workers=1,
                          chunk_duration=0.2)
    want = jloader.prepare_dataset(tmp_path, batch_size=2, num_workers=1,
                                   chunk_duration=0.2)
    assert isinstance(got, DataLoader)
    assert isinstance(got.dataset, RestorationDataset)
    assert got.shuffle and got.batch_size == want.batch_size == 2
    assert len(got.dataset) == len(want.dataset)
    batch = next(iter(got))
    assert batch["clean"].shape == (2, 1, int(0.2 * SR))


def test_metrics_logger_add_scalars_writes_jax_lines(tmp_path, monkeypatch):
    # no TensorBoard sink: its import pulls in TensorFlow where installed
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lines = {}
    for name, cls in (("port", MetricsLogger), ("jax", JMetricsLogger)):
        log = cls(tmp_path / name, "run")
        log.add_scalars({"a": 1.5, "b": np.float32(2.0)}, 7, prefix="Loss/")
        log.close()
        lines[name] = [{k: v for k, v in json.loads(line).items()
                        if k != "t"} for f in (tmp_path / name).rglob(
                            "*.jsonl") for line in f.read_text().splitlines()]
    assert lines["port"] == lines["jax"] == [
        {"tag": "Loss/a", "value": 1.5, "step": 7},
        {"tag": "Loss/b", "value": 2.0, "step": 7}]


def test_wav_info_duration(tmp_path):
    path = tmp_path / "x.wav"
    save_audio(str(path), _sig((2, 33075)), 44100)
    got = wav.wav_info(str(path))
    assert got.duration == jwav.wav_info(str(path)).duration == 0.75
