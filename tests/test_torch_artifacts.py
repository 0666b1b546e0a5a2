"""The port's 78rpm artifact simulator against the JAX package's.

JAX draws every random quantity from `jax.random` keys, which torch cannot
reproduce. `jax_draws` below rebuilds, for a key, exactly the draws JAX's
`simulate_batch` makes: it repeats its split tree (one key per item, eight
per item, six for the pops) and its `jax.random` calls, and hands the
values to the port's deterministic half, `apply_artifacts`. So the whole
simulator is held to `simulate_vinyl_artifacts` / `simulate_batch`
themselves, not only to their FIR pieces.

Bars:
- the host-designed FIR kernels, the roll-off bank, `bank_index` and
  `butter_sos`: exact (the same scipy and numpy calls);
- `_fir_same`, `_make_pops` and the whole simulator: 1e-5 max abs on audio
  at -20 dB RMS (observed ~1e-7: the two packages' FFTs, convolutions, exp
  and sin round differently in f32);
- the numpy/scipy helpers `add_noise` and `apply_highpass_filter`: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.audio import io as jio
from ml_audio_restoration_tpu.config import ArtifactConfig as JArtifactConfig
from ml_audio_restoration_tpu.data import artifacts as JA
from ml_audio_restoration_tpu.ops import filters as jfilters
from ml_audio_restoration_torch.audio import add_noise, apply_highpass_filter
from ml_audio_restoration_torch.config import ArtifactConfig
from ml_audio_restoration_torch.data import artifacts as PA
from ml_audio_restoration_torch.ops import filters

SR = 22050
SIM_BAR = 1e-5


# ------------------------------------------------------ JAX's own draws
def _jax_item_draws(key, c, t, sample_rate, cfg, max_pops):
    """simulate_vinyl_artifacts' draws for one item's key (its split tree
    and jax.random calls, artifacts.py:181-225 and _make_pops :100-128)."""
    (k_surf_lvl, k_surf, k_pops, k_crackle_lvl, k_crackle, k_rumble_lvl,
     k_rumble, k_rolloff) = jax.random.split(key, 8)
    k_n, k_loc, k_amp, k_pol, k_decay, k_freq = jax.random.split(k_pops, 6)
    f32 = jnp.float32

    def uniform(k, shape, lo, hi):
        return jax.random.uniform(k, shape, f32, lo, hi)

    expected = jnp.asarray((t / sample_rate) * cfg.impulse_rate, f32)
    p = (max_pops,)
    return {
        "surface_level": uniform(k_surf_lvl, (), *cfg.surface_noise_level),
        "surface": jax.random.normal(k_surf, (c, t), f32),
        "pop_count": jax.random.poisson(k_n, expected),
        "pop_locs": jax.random.randint(k_loc, p, 0, t),
        "pop_amps": uniform(k_amp, p, *cfg.impulse_amplitude),
        "pop_polarity": jnp.where(jax.random.uniform(k_pol, p) < 0.45,
                                  -1.0, 1.0).astype(f32),
        "pop_decay": uniform(k_decay, p, 0.001, 0.003),
        "pop_freq": uniform(k_freq, p, 3000.0, 8000.0),
        "crackle_level": uniform(k_crackle_lvl, (), *cfg.crackle_level),
        "crackle": jax.random.normal(k_crackle, (c, t), f32),
        "rumble_level": uniform(k_rumble_lvl, (), *cfg.rumble_level),
        "rumble": jax.random.normal(k_rumble, (c, t), f32),
        "rolloff_freq": uniform(k_rolloff, (), *cfg.rolloff_freq),
    }


def _stack(items):
    out = {k: torch.from_numpy(np.stack([np.asarray(it[k]) for it in items]))
           for k in items[0]}
    for k in ("pop_count", "pop_locs"):
        out[k] = out[k].long()
    return out


def jax_draws(key, shape, sample_rate=SR, cfg=None, max_pops=None):
    """The draws of JAX's simulate_batch(key, [B, C, T] batch, max_pops=),
    as the port's draw dict (torch tensors on the CPU): the pop draws are
    [B, max_pops] (default JAX's bound, max_pops_for(T)), and the Poisson
    count is left uncapped, as JAX draws it."""
    cfg = cfg or JArtifactConfig()
    b, c, t = shape
    if max_pops is None:
        max_pops = PA.max_pops_for(t, sample_rate, cfg)
    return _stack([_jax_item_draws(k, c, t, sample_rate, cfg, max_pops)
                   for k in jax.random.split(key, b)])


def clean_batch(b, c, t, seed=0):
    """Tones under noise at about -20 dB RMS, [B, C, T] float32."""
    rng = np.random.default_rng(seed)
    n = np.arange(t) / SR
    x = np.stack([[0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * n)
                   + 0.05 * rng.standard_normal(t) for _ in range(c)]
                  for _ in range(b)])
    return x.astype(np.float32)


def _dev(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ---------------------------------------------------------- host design
@pytest.mark.parametrize("design", [
    (4, 2500.0, SR, "high", 257), (4, 100.0, SR, "low", 2049),
    (3, 7000.0, SR, "low", 129), (4, 100.0, 44100, "low", 2049)])
def test_zero_phase_fir_equals_jax(design):
    got = PA.zero_phase_fir(*design)
    assert got.dtype == np.float32 and got.shape == (design[-1],)
    np.testing.assert_array_equal(got, JA.zero_phase_fir(*design))


def test_fir_bank_and_butter_sos_equal_jax():
    args = (3, 6000.0, 8000.0, SR, "low", 129)
    np.testing.assert_array_equal(PA.zero_phase_fir_bank(*args, num=49),
                                  JA.zero_phase_fir_bank(*args, num=49))
    for design in ((4, 2500.0, SR, "high"), (3, 6500.0, SR, "low")):
        for got, want in zip(filters.butter_sos(*design),
                             jfilters.butter_sos(*design)):
            np.testing.assert_array_equal(got, want)


def test_bank_index_equals_jax():
    """A grid finer than the bank's, both edges, values past them, and the
    exact half-way points (round half to even)."""
    lo, hi = 6000.0, 8000.0
    freqs = np.concatenate([
        np.linspace(5900.0, 8100.0, 2001),
        lo + (np.arange(48) + 0.5) * (hi - lo) / 48]).astype(np.float32)
    got = filters.bank_index(49, torch.from_numpy(freqs), lo, hi)
    want = jfilters.bank_index(49, jnp.asarray(freqs), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------- FIR
@pytest.mark.parametrize("taps", [129, 257, 2049])
@pytest.mark.parametrize("t", [3001, 4096])
def test_fir_same_matches_jax(taps, t):
    """Both branches: direct below 193 taps, FFT above, at odd and
    power-of-two lengths, on [B, C, T]; the direct one also with one kernel
    per item (the roll-off bank)."""
    kernel = PA.zero_phase_fir(4, 1000.0, SR, "low", taps)
    x = clean_batch(3, 2, t)
    want = np.stack([np.asarray(JA._fir_same(jnp.asarray(item),
                                             jnp.asarray(kernel)))
                     for item in x])
    got = PA._fir_same(torch.from_numpy(x), torch.from_numpy(kernel))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _dev(got.numpy(), want) <= SIM_BAR
    if taps > PA.FFT_ABOVE_TAPS:
        return
    bank = np.stack([PA.zero_phase_fir(3, f, SR, "low", taps)
                     for f in (6000.0, 7000.0, 8000.0)])
    want = np.stack([np.asarray(JA._fir_same(jnp.asarray(item),
                                             jnp.asarray(k)))
                     for item, k in zip(x, bank)])
    got = PA._fir_same(torch.from_numpy(x), torch.from_numpy(bank))
    assert _dev(got.numpy(), want) <= SIM_BAR


def test_fir_same_fft_branch_takes_one_odd_kernel():
    for kernel in (torch.zeros(256), torch.zeros(2, 257)):
        with pytest.raises(ValueError, match="one odd kernel"):
            PA._fir_same(torch.zeros(2, 1, 500), kernel)


# ------------------------------------------------------------------ pops
@pytest.mark.parametrize("t,rate", [(4001, 10.0), (2000, 45.0)])
def test_make_pops_matches_jax(t, rate):
    """The pop track from JAX's own draws, with many overlapping pops at
    the higher rate."""
    cfg = JArtifactConfig(impulse_rate=rate)
    key = jax.random.PRNGKey(4)
    max_pops = PA.max_pops_for(t, SR, cfg)
    keys = jax.random.split(key, 3)
    want = np.stack([np.asarray(JA._make_pops(k, t, SR, cfg, max_pops))
                     for k in keys])
    # _make_pops takes the 8-way split's third key in simulate_vinyl_
    # artifacts; here it is handed the key directly, so rebuild from it
    items = []
    for k in keys:
        k_n, k_loc, k_amp, k_pol, k_decay, k_freq = jax.random.split(k, 6)
        p = (max_pops,)
        items.append({
            "pop_count": jax.random.poisson(
                k_n, jnp.asarray(t / SR * rate, jnp.float32)),
            "pop_locs": jax.random.randint(k_loc, p, 0, t),
            "pop_amps": jax.random.uniform(k_amp, p, jnp.float32,
                                           *cfg.impulse_amplitude),
            "pop_polarity": jnp.where(jax.random.uniform(k_pol, p) < 0.45,
                                      -1.0, 1.0).astype(jnp.float32),
            "pop_decay": jax.random.uniform(k_decay, p, jnp.float32,
                                            0.001, 0.003),
            "pop_freq": jax.random.uniform(k_freq, p, jnp.float32,
                                           3000.0, 8000.0)})
    draws = _stack(items)
    assert int(draws["pop_count"].min()) > 0
    got = PA._make_pops(draws, t, SR, ArtifactConfig(impulse_rate=rate))
    assert got.shape == (3, t)
    assert _dev(got.numpy(), want) <= SIM_BAR
    assert float(np.abs(want).max()) > 0.05


# ------------------------------------------------------------- simulator
@pytest.mark.parametrize("shape,overrides", [
    ((3, 1, 4001), {}),
    ((2, 2, 3001), {}),
    ((2, 1, 2500), {"add_rumble": False}),
    ((2, 1, 2500), {"add_rolloff": False, "impulse_rate": 30.0}),
    ((2, 1, 3000), {"rolloff_freq": (5000.0, 7000.0),
                    "impulse_amplitude": (0.2, 1.5)})])
def test_simulate_batch_matches_jax(shape, overrides):
    key = jax.random.PRNGKey(sum(shape))
    x = clean_batch(*shape)
    jcfg = JArtifactConfig(**overrides)
    want = np.asarray(JA.simulate_batch(key, jnp.asarray(x), SR, jcfg))
    draws = jax_draws(key, shape, SR, jcfg)
    got = PA.apply_artifacts(torch.from_numpy(x), draws, SR,
                             ArtifactConfig(**overrides))
    assert got.shape == shape and got.dtype == torch.float32
    assert _dev(got.numpy(), want) <= SIM_BAR
    assert _dev(want, x) > 0.1  # it degraded


@pytest.mark.parametrize("cap", [1, 6])
def test_pop_cap_matches_jax(cap):
    """max_pops below the Poisson count (200 pops/s over 0.2 s, about 40):
    JAX's simulate_batch(max_pops=) on its own draws, and the port's
    draw_artifacts / simulate_batch / simulate_vinyl_artifacts taking the
    cap, which sizes the pop draws."""
    shape = (2, 1, 4410)
    overrides = {"impulse_rate": 200.0}
    key = jax.random.PRNGKey(21)
    x = clean_batch(*shape, seed=5)
    jcfg = JArtifactConfig(**overrides)
    want = np.asarray(JA.simulate_batch(key, jnp.asarray(x), SR, jcfg,
                                        max_pops=cap))
    draws = jax_draws(key, shape, SR, jcfg, max_pops=cap)
    assert draws["pop_amps"].shape == (2, cap)
    assert int(draws["pop_count"].min()) > cap
    cfg = ArtifactConfig(**overrides)
    got = PA.apply_artifacts(torch.from_numpy(x), draws, SR, cfg)
    assert _dev(got.numpy(), want) <= SIM_BAR
    uncapped = np.asarray(JA.simulate_batch(key, jnp.asarray(x), SR, jcfg))
    assert _dev(want, uncapped) > 0.05  # the cap took pops away

    mine = PA.draw_artifacts(torch.Generator().manual_seed(2), shape, SR,
                             cfg, max_pops=cap)
    for name in ("pop_locs", "pop_amps", "pop_polarity", "pop_decay",
                 "pop_freq"):
        assert mine[name].shape == (2, cap), name
    xt = torch.from_numpy(x)
    one = PA.simulate_batch(torch.Generator().manual_seed(2), xt, SR, cfg,
                            max_pops=cap)
    assert torch.equal(one, PA.apply_artifacts(xt, mine, SR, cfg))
    item = PA.simulate_vinyl_artifacts(torch.Generator().manual_seed(2),
                                       xt[0], SR, cfg, max_pops=cap)
    first = PA.draw_artifacts(torch.Generator().manual_seed(2),
                              (1,) + shape[1:], SR, cfg, max_pops=cap)
    assert torch.equal(item, PA.apply_artifacts(xt[:1], first, SR, cfg)[0])


@pytest.mark.parametrize("channels", [None, 1, 2])
def test_simulate_vinyl_artifacts_matches_jax(channels):
    """One item, [C, T] or [T]: JAX's item function against the port's
    deterministic half on that item's draws."""
    key = jax.random.PRNGKey(11)
    t = 3333
    x = clean_batch(1, channels or 1, t)[0]
    if channels is None:
        x = x[0]
    want = np.asarray(JA.simulate_vinyl_artifacts(key, jnp.asarray(x), SR))
    c = 1 if x.ndim == 1 else x.shape[0]
    cfg = JArtifactConfig()
    draws = _stack([_jax_item_draws(key, c, t, SR, cfg,
                                    PA.max_pops_for(t, SR, cfg))])
    got = PA.apply_artifacts(torch.from_numpy(x).reshape(1, c, t), draws,
                             SR)
    assert _dev(got.reshape(x.shape).numpy(), want) <= SIM_BAR
    g = torch.Generator().manual_seed(0)
    assert PA.simulate_vinyl_artifacts(
        g, torch.from_numpy(x), SR).shape == x.shape


def test_simulate_batch_is_draw_then_apply():
    """simulate_batch from a seeded generator equals apply_artifacts of
    draw_artifacts from the same seed, repeats exactly, and another seed
    gives another degradation."""
    x = torch.from_numpy(clean_batch(2, 1, 5000))
    one = PA.simulate_batch(torch.Generator().manual_seed(3), x, SR)
    again = PA.simulate_batch(torch.Generator().manual_seed(3), x, SR)
    draws = PA.draw_artifacts(torch.Generator().manual_seed(3), x.shape, SR)
    assert torch.equal(one, again)
    assert torch.equal(one, PA.apply_artifacts(x, draws, SR))
    other = PA.simulate_batch(torch.Generator().manual_seed(4), x, SR)
    assert float((one - other).abs().max()) > 1e-2


def test_draws_lie_in_their_ranges():
    cfg = ArtifactConfig()
    d = PA.draw_artifacts(torch.Generator().manual_seed(1), (64, 2, 44100),
                          SR, cfg)
    p = PA.max_pops_for(44100, SR, cfg)
    assert p == 76
    assert d["surface"].shape == d["crackle"].shape == (64, 2, 44100)
    assert d["pop_locs"].shape == (64, p)
    assert 0 <= int(d["pop_locs"].min()) and int(d["pop_locs"].max()) < 44100
    for key, (lo, hi) in (("surface_level", cfg.surface_noise_level),
                          ("crackle_level", cfg.crackle_level),
                          ("rumble_level", cfg.rumble_level),
                          ("rolloff_freq", cfg.rolloff_freq),
                          ("pop_amps", cfg.impulse_amplitude),
                          ("pop_decay", (0.001, 0.003)),
                          ("pop_freq", (3000.0, 8000.0))):
        assert lo <= float(d[key].min()) and float(d[key].max()) <= hi, key
    assert set(d["pop_polarity"].unique().tolist()) == {-1.0, 1.0}
    # Poisson with mean 20 pops per 2 s item
    assert 15 < float(d["pop_count"].float().mean()) < 25


def test_iir_filter_mode_raises():
    """"iir" is a filter mode since the IIR path was ported (held to JAX in
    tests/test_torch_iir.py); a mode that is neither "fir" nor "iir"
    raises in both entry points."""
    x = torch.zeros(1, 1, 1000)
    match = "filter_mode must be one of"
    with pytest.raises(ValueError, match=match):
        PA.simulate_batch(torch.Generator(), x, SR, filter_mode="butter")
    with pytest.raises(ValueError, match=match):
        PA.apply_artifacts(x, {}, SR, filter_mode="butter")


# --------------------------------------------------------- io helpers
def test_add_noise_and_highpass_equal_jax():
    x = clean_batch(1, 2, 3000)[0]
    np.testing.assert_array_equal(
        add_noise(x, 0.02, np.random.default_rng(5)),
        jio.add_noise(x, 0.02, np.random.default_rng(5)))
    for cutoff in (80.0, 300.0):
        np.testing.assert_array_equal(
            apply_highpass_filter(x, SR, cutoff),
            jio.apply_highpass_filter(x, SR, cutoff))
