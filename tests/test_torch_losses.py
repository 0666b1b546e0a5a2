"""The port's STFT, losses and metrics against the JAX package's.

Inputs are drawn with numpy and handed to both. Bar: 1e-5 absolute on
values of order one (the losses, the window, the frames), and 1e-5 of the
largest magnitude for the complex STFT, whose bins reach ~1e2: the same f32
arithmetic summed in another order (pocketfft in both, but different
framing and reduction orders).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu import losses as JL
from ml_audio_restoration_torch import losses as TL

# the modules, not the `stft` functions both ops packages re-export
JS = importlib.import_module("ml_audio_restoration_tpu.ops.stft")
TS = importlib.import_module("ml_audio_restoration_torch.ops.stft")

BAR = 1e-5


def _close(got, want, bar=BAR, name=""):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=bar,
                               err_msg=name)


def _signals(rng, b=2, t=2048, c=2):
    """Two correlated stereo signals [B, T, C]: tones, noise, a click."""
    n = np.arange(t) / 22050
    base = (0.3 * np.sin(2 * np.pi * 330 * n)
            + 0.1 * rng.standard_normal((b, t)))
    out = np.stack([base * (1.0 - 0.3 * k) + 0.05 * rng.standard_normal(
        (b, t)) for k in range(c)], axis=-1)
    out[:, t // 3] += 0.5
    tgt = out + 0.05 * rng.standard_normal(out.shape)
    return out.astype(np.float32), tgt.astype(np.float32)


@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_hann_window_matches(n_fft):
    _close(TS.hann_window(n_fft), JS.hann_window(n_fft), 0.0)


@pytest.mark.parametrize("center", [True, False])
def test_frame_matches(rng, center):
    x = rng.standard_normal((2, 2000)).astype(np.float32)
    got = TS.frame(torch.from_numpy(x), 512, 128, center=center)
    want = JS.frame(jnp.asarray(x), 512, 128, center=center)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, 0.0)


@pytest.mark.parametrize("n_fft", [512, 2048])
def test_stft_matches(rng, n_fft):
    x = rng.standard_normal((2, 4000)).astype(np.float32) * 0.3
    got = TS.stft(torch.from_numpy(x), n_fft, n_fft // 4)
    want = np.asarray(JS.stft(jnp.asarray(x), n_fft, n_fft // 4))
    assert tuple(got.shape) == want.shape == (2, 1 + 4000 // (n_fft // 4),
                                              n_fft // 2 + 1)
    bar = BAR * max(1.0, float(np.abs(want).max()))
    _close(got.real, want.real, bar)
    _close(got.imag, want.imag, bar)
    _close(TS.stft_magnitude(torch.from_numpy(x), n_fft, n_fft // 4),
           JS.stft_magnitude(jnp.asarray(x), n_fft, n_fft // 4), bar)


STEREO_LOSSES = [
    ("spectral_clustering_loss", 1),
    ("temporal_consistency_loss", 1),
    ("decorrelation_loss", 1),
    ("low_frequency_centering_loss", 1),
    ("stereo_balance_loss", 2),
    ("stereo_stats_match_loss", 2),
    ("multiscale_spectral_loss", 2),
]


@pytest.mark.parametrize("name,nargs", STEREO_LOSSES,
                         ids=[n for n, _ in STEREO_LOSSES])
def test_stereo_losses_match(rng, name, nargs):
    out, tgt = _signals(rng)
    args = (out, tgt)[:nargs]
    got = getattr(TL, name)(*(torch.from_numpy(a) for a in args))
    want = getattr(JL, name)(*(jnp.asarray(a) for a in args))
    assert got.dtype == torch.float32
    _close(got, want, name=name)


def test_impulse_loss_matches(rng):
    out, tgt = _signals(rng, c=1)
    _close(TL.impulse_loss(torch.from_numpy(out), torch.from_numpy(tgt)),
           JL.impulse_loss(jnp.asarray(out), jnp.asarray(tgt)))


def test_temporal_consistency_short_input_is_zero():
    """T < window + hop gives fewer than two windows: the loss is 0, not
    the NaN of an empty mean (JAX losses/stereo.py:45-50)."""
    x = torch.full((2, 700, 2), 0.1)
    got = TL.temporal_consistency_loss(x)
    assert float(got) == 0.0
    assert float(JL.temporal_consistency_loss(jnp.asarray(x.numpy()))) == 0.0


def test_stereo_metrics_match(rng):
    out, _ = _signals(rng)
    got = TL.stereo_metrics(torch.from_numpy(out))
    want = JL.stereo_metrics(jnp.asarray(out))
    assert set(got) == set(want)
    for k in got:
        _close(got[k], want[k], name=k)


@pytest.mark.parametrize("name", ["snr", "si_sdr"])
def test_waveform_metrics_match(rng, name):
    out, tgt = _signals(rng)
    got = getattr(TL, name)(torch.from_numpy(out), torch.from_numpy(tgt),
                            axis=1)
    want = getattr(JL, name)(jnp.asarray(out), jnp.asarray(tgt), axis=1)
    # dB values of order 10: the bar is relative to them
    _close(got, want, BAR * 10, name)


def test_lsd_matches(rng):
    out, tgt = _signals(rng)
    got = TL.lsd(torch.from_numpy(out[..., 0]), torch.from_numpy(tgt[..., 0]))
    want = JL.lsd(jnp.asarray(out[..., 0]), jnp.asarray(tgt[..., 0]))
    _close(got, want, BAR * 10)


RESTORATION_CASES = {
    "mono": (1, {}),
    "stereo": (2, {}),
    "stereo_all_terms": (2, {"time_weight": 2.0, "si_sdr_weight": 0.01,
                             "balance_weight": 0.2,
                             "decorrelation_weight": 0.1,
                             "lf_centering_weight": 0.1,
                             "stats_match_weight": 0.1}),
}


@pytest.mark.parametrize("case", list(RESTORATION_CASES))
def test_restoration_loss_matches(rng, case):
    c, kw = RESTORATION_CASES[case]
    out, tgt = _signals(rng, c=c)
    total, parts = TL.restoration_loss(torch.from_numpy(out),
                                       torch.from_numpy(tgt), **kw)
    jtotal, jparts = JL.restoration_loss(jnp.asarray(out), jnp.asarray(tgt),
                                         **kw)
    assert set(parts) == set(jparts)
    for k in parts:
        _close(parts[k], jparts[k], BAR * max(1.0, abs(float(jparts[k]))), k)
    _close(total, jtotal, BAR * max(1.0, abs(float(jtotal))))


def test_reference_weights():
    assert (TL.SPECTRAL_WEIGHT, TL.IMPULSE_WEIGHT, TL.CLUSTERING_WEIGHT,
            TL.CONSISTENCY_WEIGHT) == (JL.SPECTRAL_WEIGHT, JL.IMPULSE_WEIGHT,
                                       JL.CLUSTERING_WEIGHT,
                                       JL.CONSISTENCY_WEIGHT)
    spectral = importlib.import_module("ml_audio_restoration_tpu.losses."
                                       "spectral")
    assert TL.FFT_SIZES == spectral.FFT_SIZES
    assert TL.LOG_EPS == spectral.LOG_EPS
