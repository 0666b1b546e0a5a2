"""78rpm artifact simulator, run on the device inside the train step.

Counterpart of ml_audio_restoration_tpu/data/artifacts.py. Each item of a
[B, C, T] batch gets, in this order:

1. surface noise     - Gaussian, level ~ U(0.015, 0.03)
2. pops              - Poisson-timed impulses (rate/s), amp ~ U(0.1, 0.5),
                       polarity -1 with p=0.45, exponential decay 1-3 ms
                       (amp-scaled), 3-8 kHz resonant ringing; shared by
                       the item's channels
3. crackle           - Gaussian noise through a zero-phase 2.5 kHz high-pass
4. rumble            - Gaussian noise through a zero-phase 100 Hz low-pass
5. bandwidth rolloff - zero-phase low-pass at U(6, 8) kHz on the whole mix

On the default FIR path (`filter_mode="fir"`) the zero-phase filters are
the truncated impulse responses of scipy's sosfiltfilt, designed on the
host once and cached as numpy: 257 taps for the crackle, 2,049 for the
rumble (both applied through an FFT), and a bank of 49 129-tap kernels over
the roll-off range, one picked per item by `ops.filters.bank_index` and
applied as a direct convolution. On the exact IIR path
(`filter_mode="iir"`) they are Butterworth sosfiltfilt itself
(ops.filters, the scans of csrc/iir_scan.cu on the card): crackle a
high-pass of order 4, rumble a low-pass of order 4, and the roll-off an
order-3 low-pass from `butter_bank`'s 49 cutoffs, picked per item by the
same `bank_index`, so one launch filters the batch's items each through
its own filter (six launches a degradation).

The JAX package draws from `jax.random` keys, which torch cannot
reproduce, so the simulator is split in two: `draw_artifacts` makes every
random quantity of a batch from a `torch.Generator` (on the generator's
device), and `apply_artifacts` is a deterministic function of the audio and
those draws. Fed the JAX package's own draws, `apply_artifacts` gives its
`simulate_batch` output, in either filter mode. The adaptive per-item
overrides (impulse rate, amplitude bound, noise level;
AdaptiveArtifactDataset) change only the draws.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ArtifactConfig
from ..ops.filters import (bank_index, butter_bank, butter_filtfilt,
                           sosfiltfilt)

ROLLOFF_BANK = 49    # grid points of the roll-off cutoff bank
FFT_ABOVE_TAPS = 192  # longer kernels are applied through an FFT
FILTER_MODES = ("fir", "iir")


# --------------------------------------------------------------------- FIR
@functools.lru_cache(maxsize=64)
def zero_phase_fir(order: int, cutoff_hz: float, sample_rate: float,
                   btype: str, numtaps: int):
    """Truncated impulse response of sosfiltfilt (symmetric, zero-phase),
    float32 numpy [numtaps]."""
    from scipy import signal as _sig

    wn = cutoff_hz / (sample_rate / 2.0)
    sos = _sig.butter(order, wn, btype=btype, output="sos")
    pad = 8 * numtaps
    delta = np.zeros(2 * pad + 1, np.float64)
    delta[pad] = 1.0
    h = _sig.sosfiltfilt(sos, delta)
    half = numtaps // 2
    kernel = h[pad - half:pad + half + 1]
    return np.asarray(kernel, np.float32)


@functools.lru_cache(maxsize=8)
def zero_phase_fir_bank(order: int, f_lo: float, f_hi: float,
                        sample_rate: float, btype: str, numtaps: int,
                        num: int = 33):
    """zero_phase_fir over a `num`-point linspace of cutoffs: [num, taps]."""
    return np.stack([
        zero_phase_fir(order, float(f), sample_rate, btype, numtaps)
        for f in np.linspace(f_lo, f_hi, num)
    ])


def _fir_same(x, kernel):
    """'same' convolution along the last axis of x [..., T] with a kernel
    [K]; a direct one also takes one kernel per item, [B, K] for x
    [B, C, T] (the roll-off bank).

    Kernels longer than 192 taps go through the frequency domain, with the
    JAX package's transform length (the next power of two >= T + K - 1) and
    centred slice; shorter ones are a direct convolution."""
    k = kernel.shape[-1]
    t = x.shape[-1]
    if k > FFT_ABOVE_TAPS:
        if k % 2 != 1 or kernel.dim() != 1:
            raise ValueError(f"the FFT branch takes one odd kernel, got "
                             f"{tuple(kernel.shape)}")
        n = 1 << max(t + k - 2, 1).bit_length()
        y = torch.fft.irfft(torch.fft.rfft(x, n) * torch.fft.rfft(kernel, n),
                            n)
        return y[..., k // 2:k // 2 + t].to(x.dtype)
    w = kernel.flip(-1)  # conv1d correlates: flip for a true convolution
    if kernel.dim() == 1:
        y = F.conv1d(x.reshape(-1, 1, t), w.view(1, 1, k), padding=k // 2)
        return y.reshape(x.shape)
    b, c = x.shape[0], x.shape[1]
    y = F.conv1d(x.reshape(1, b * c, t), w.repeat_interleave(c, 0)[:, None],
                 padding=k // 2, groups=b * c)
    return y.reshape(x.shape)


# --------------------------------------------------------------------- pops
def _template_len(sample_rate: int, cfg: ArtifactConfig) -> int:
    """Pop template length: the longest decay, 3 ms * (1 + amp bound)."""
    amp_bound = max(cfg.impulse_amplitude[1], 1.0)
    return int(math.ceil(sample_rate * 0.003 * (1.0 + amp_bound))) + 1


def _make_pops(draws, num_samples: int, sample_rate: int,
               cfg: ArtifactConfig):
    """Sum of each item's decaying impulses as a [B, T] track."""
    amps = draws["pop_amps"]  # [B, P]
    b, p = amps.shape
    dtype, dev = amps.dtype, amps.device
    tmpl_len = _template_len(sample_rate, cfg)
    num_pops = torch.clamp(draws["pop_count"], max=p)
    active = (torch.arange(p, device=dev) < num_pops[:, None]).to(dtype)

    n = torch.arange(tmpl_len, dtype=dtype, device=dev)  # [L]
    decay_time = draws["pop_decay"] * (1.0 + amps)
    decay_len = torch.floor(sample_rate * decay_time)  # [B, P]
    tau = sample_rate * decay_time * 0.3
    decay = torch.exp(-n / tau[..., None])  # [B, P, L]
    valid = (n < decay_len[..., None]).to(dtype)

    impulse = amps[..., None] * draws["pop_polarity"][..., None] * decay
    t = n / sample_rate
    resonance = (0.3 * torch.sin(2 * math.pi * draws["pop_freq"][..., None]
                                 * t) * decay)
    # ringing only where the decay spans more than 10 samples
    ring_on = (decay_len > 10).to(dtype)[..., None]
    impulse = impulse + resonance * amps[..., None] * 0.2 * ring_on
    impulse = impulse * valid * active[..., None]

    # Overlapping pops are summed without float atomics: each pop is written
    # into its own row (no two writes of a row share an index), then the
    # rows are summed. A scatter-add (index_add_, scatter_add_) would sum in
    # a different order from run to run on the card and break "two runs
    # from one seed are equal". At 2 s, 22.05 kHz, 10 pops/s and batch 16
    # the rows are 16 x 76 x 44,201 floats (215 MB), written and read once;
    # under the adaptive overrides' 50/s bound 16 x 316 x 44,201 (0.89 GB).
    idx = (draws["pop_locs"][..., None]
           + torch.arange(tmpl_len, device=dev))  # [B, P, L]
    rows = torch.zeros((b, p, num_samples + tmpl_len), dtype=dtype,
                       device=dev)
    rows.scatter_(2, idx, impulse)
    return rows[..., :num_samples].sum(dim=1)


# ---------------------------------------------------------------- simulator
ADAPTIVE_RATE_BOUND = 50.0  # pops/s: AdaptiveArtifactDataset's clip ceiling


def max_pops_for(num_samples: int, sample_rate: int, cfg: ArtifactConfig,
                 rate_bound: float | None = None) -> int:
    """The static pop bound: three times the expected count at
    `rate_bound` pops/s (default the config's rate), plus 16."""
    rate = cfg.impulse_rate if rate_bound is None else rate_bound
    return int(math.ceil(3.0 * (num_samples / sample_rate) * rate)) + 16


def draw_artifacts(generator: torch.Generator, shape, sample_rate: int,
                   cfg: ArtifactConfig | None = None, *,
                   dtype: torch.dtype = torch.float32,
                   overrides: dict | None = None,
                   max_pops: int | None = None) -> dict:
    """Every random quantity of a [B, C, T] batch's degradation, drawn from
    `generator` on its device: per item the noise levels, the surface,
    crackle and rumble noise [B, C, T], the Poisson pop count and, for
    `max_pops` pops (default max_pops_for(T)), their locations, amplitudes,
    polarities, decay draws (U(1, 3) ms before the amplitude scaling) and
    ringing frequencies, and the roll-off cutoff. The pop count is capped
    at `max_pops` where the pops are made, as JAX's
    `simulate_vinyl_artifacts(max_pops=)` caps it.

    `overrides` holds per-item [B] tensors, as JAX's
    `simulate_vinyl_artifacts(overrides=)` takes them: `impulse_rate` is
    the Poisson mean's rate (and the pop bound becomes 50/s),
    `impulse_amplitude_max` the amplitudes' upper end, clamped into
    [amp_lo + 1e-6, max(amp_hi, 1)], and `noise_level` n draws the surface
    level from U(0.5 n, 1.5 n) and the crackle's from U(0.3 n, 0.8 n)."""
    cfg = cfg or ArtifactConfig()
    ov = overrides or {}
    b, c, t = shape
    p = max_pops if max_pops is not None else max_pops_for(
        t, sample_rate, cfg,
        ADAPTIVE_RATE_BOUND if "impulse_rate" in ov else None)
    g, dev = generator, generator.device

    def unit(*size, kind=dtype):
        return torch.rand(size, generator=g, device=dev, dtype=kind)

    def uniform(lo, hi, *size, kind=dtype):
        return unit(*size, kind=kind) * (hi - lo) + lo

    def normal():
        return torch.randn((b, c, t), generator=g, device=dev, dtype=dtype)

    def item(key):
        return ov[key].to(device=dev, dtype=torch.float32)

    def level(key, lo, span):
        # JAX draws U(0, 1) * (span * n) + lo * n under a noise_level n
        if "noise_level" not in ov:
            return uniform(*getattr(cfg, key), b)
        n = item("noise_level").to(dtype)
        return unit(b) * (span * n) + lo * n

    duration = t / sample_rate
    expected = (duration * item("impulse_rate") if "impulse_rate" in ov
                else torch.full((b,), duration * cfg.impulse_rate,
                                dtype=torch.float32, device=dev))
    amp_lo, amp_hi = cfg.impulse_amplitude
    if "impulse_amplitude_max" in ov:
        amp_hi = torch.clamp(item("impulse_amplitude_max"), amp_lo + 1e-6,
                             max(amp_hi, 1.0)).to(dtype)[:, None]
    return {
        "surface_level": level("surface_noise_level", 0.5, 1.0),
        "surface": normal(),
        "pop_count": torch.poisson(expected, generator=g).long(),
        "pop_locs": torch.randint(0, t, (b, p), generator=g, device=dev),
        "pop_amps": uniform(amp_lo, amp_hi, b, p),
        "pop_polarity": torch.where(
            uniform(0.0, 1.0, b, p) < 0.45, -1.0, 1.0).to(dtype),
        "pop_decay": uniform(0.001, 0.003, b, p),
        "pop_freq": uniform(3000.0, 8000.0, b, p),
        "crackle_level": level("crackle_level", 0.3, 0.5),
        "crackle": normal(),
        "rumble_level": uniform(*cfg.rumble_level, b),
        "rumble": normal(),
        "rolloff_freq": uniform(*cfg.rolloff_freq, b, kind=torch.float32),
    }


def _check_filter_mode(filter_mode: str):
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"filter_mode must be one of {FILTER_MODES}, got "
                         f"{filter_mode!r}")


def apply_artifacts(audio, draws: dict, sample_rate: int,
                    cfg: ArtifactConfig | None = None, *,
                    filter_mode: str = "fir"):
    """Degrade clean audio [B, C, T] with the artifacts `draws` describe
    (draw_artifacts' keys, on audio's device) -> [B, C, T]. Deterministic:
    the same audio and draws give the same output. `filter_mode` "fir"
    filters with the truncated zero-phase FIR kernels, "iir" with
    Butterworth sosfiltfilt."""
    _check_filter_mode(filter_mode)
    cfg = cfg or ArtifactConfig()
    t = audio.shape[-1]
    iir = filter_mode == "iir"

    def scaled(noise, level):
        return draws[noise] * draws[level][:, None, None]

    def zero_phase(x, order, cutoff, btype, taps):
        if iir:
            return butter_filtfilt(x, order, cutoff, sample_rate, btype)
        kernel = torch.as_tensor(
            zero_phase_fir(order, cutoff, sample_rate, btype, taps),
            device=audio.device, dtype=audio.dtype)
        return _fir_same(x, kernel)

    out = audio + scaled("surface", "surface_level")
    out = out + _make_pops(draws, t, sample_rate, cfg)[:, None]
    out = out + zero_phase(scaled("crackle", "crackle_level"), 4, 2500.0,
                           "high", 257)
    if cfg.add_rumble:
        out = out + zero_phase(scaled("rumble", "rumble_level"), 4, 100.0,
                               "low", 2049)
    if cfg.add_rolloff:
        f_lo, f_hi = cfg.rolloff_freq
        idx = bank_index(ROLLOFF_BANK, draws["rolloff_freq"], f_lo,
                         f_hi).long()
        if iir:
            sos, zi = (torch.as_tensor(a, device=audio.device)[idx][:, None]
                       for a in butter_bank(3, f_lo, f_hi, sample_rate,
                                            "low", ROLLOFF_BANK))
            out = sosfiltfilt(sos, out, zi=zi)
        else:
            bank = torch.as_tensor(zero_phase_fir_bank(
                3, f_lo, f_hi, sample_rate, "low", 129, num=ROLLOFF_BANK),
                device=audio.device, dtype=audio.dtype)
            out = _fir_same(out, bank[idx])
    return out


def simulate_batch(generator: torch.Generator, batch, sample_rate: int,
                   cfg: ArtifactConfig | None = None, *,
                   filter_mode: str = "fir", overrides: dict | None = None,
                   max_pops: int | None = None):
    """Degrade a [B, C, T] batch with draws from `generator` (per-item
    `overrides` and the pop bound `max_pops` as draw_artifacts takes them).
    The draws are made on the generator's device and moved to the batch's,
    so a CPU generator gives the same degradation on any device."""
    _check_filter_mode(filter_mode)
    draws = draw_artifacts(generator, tuple(batch.shape), sample_rate, cfg,
                           dtype=batch.dtype, overrides=overrides,
                           max_pops=max_pops)
    draws = {k: v.to(batch.device) for k, v in draws.items()}
    return apply_artifacts(batch, draws, sample_rate, cfg,
                           filter_mode=filter_mode)


def simulate_vinyl_artifacts(generator: torch.Generator, audio,
                             sample_rate: int,
                             cfg: ArtifactConfig | None = None, **kwargs):
    """Degrade one item, [C, T] or [T] -> the same shape; `kwargs`
    (filter_mode, overrides, max_pops) as simulate_batch takes them."""
    squeeze = audio.dim() == 1
    batch = audio[None, None] if squeeze else audio[None]
    out = simulate_batch(generator, batch, sample_rate, cfg, **kwargs)[0]
    return out[0] if squeeze else out
