"""The port's IIR filters (ops/filters.py over ops/iir.py) against the JAX
package's scans, on the CPU (the plain versions; the kernel of
csrc/iir_scan.cu is held to them on the card in tests/test_torch_cuda.py
and chip_smoke.py).

Bars: outputs within 1e-5 of the output's peak, gradients (of a weighted
sum of the output, in x and in the initial state) within 2e-5 of the
gradient's peak, against jax.grad through JAX's scans; the simulator's IIR
path on JAX's own draws within the degradation's 1e-5 (SIM_BAR); the host
designs exactly. Sizes are JAX's own filter tests' (500 to 4,000 samples).

One output bar does not hold, and the gap is measured: the 100 Hz rumble
low-pass at 22.05 kHz, whose poles lie within 0.03 of the unit circle. In
f32 each package's sosfilt output is 3.3e-5 of its peak from the float64
answer (the same coefficients and steps run in float64), and the two are
3.4e-5 apart: XLA fuses the step's multiply-adds, the port rounds each
operation as written, and the filter magnifies either rounding. (Its
sosfiltfilt: 1.2e-5 apart, each 3e-5 from float64.) So the rumble's output
is held to JAX at RUMBLE_BAR, 5e-5 of the peak, and to the float64 answer
no further than 1.1 times JAX's own distance from it. Its gradients hold
the 2e-5 bar: the adjoint walks run in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.config import ArtifactConfig as JArtifactConfig
from ml_audio_restoration_tpu.data import artifacts as JA
from ml_audio_restoration_tpu.ops import filters as jf
from ml_audio_restoration_torch.config import ArtifactConfig
from ml_audio_restoration_torch.data import artifacts as PA
from ml_audio_restoration_torch.ops import filters as pf
from ml_audio_restoration_torch.ops import iir
from test_torch_artifacts import SIM_BAR, SR, clean_batch, jax_draws

OUT_BAR = 1e-5
GRAD_BAR = 2e-5
RUMBLE_BAR = 5e-5   # the 100 Hz low-pass's output (module docstring)
# (order, cutoff, btype): the simulator's crackle, rumble and a roll-off
DESIGNS = [(4, 2500.0, "high"), (4, 100.0, "low"), (3, 7000.0, "low")]


def _signal(shape, seed=0):
    return np.random.default_rng(seed).normal(
        size=shape).astype(np.float32) * 0.3


def _close(got, want, bar):
    want = np.asarray(want)
    peak = float(np.abs(want).max())
    assert peak > 0
    dev = float(np.abs(np.asarray(got) - want).max())
    assert dev <= bar * peak, (dev, peak)


def _close_out(fn, jax_fn, design, *args):
    """fn(*args) in f32 against jax_fn at OUT_BAR, or for the rumble design
    at RUMBLE_BAR and against fn in float64 (module docstring)."""
    got = fn(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jax_fn(*(jnp.asarray(a) for a in args)))
    if design[1] != 100.0:
        return _close(got, want, OUT_BAR)
    _close(got, want, RUMBLE_BAR)
    exact = fn(*(torch.from_numpy(a.astype(np.float64)) for a in args))
    exact = exact.numpy()
    assert (np.abs(got - exact).max()
            <= 1.1 * np.abs(want - exact).max())


def _grads(port_fn, jax_fn, *args, seed=1):
    """Gradients of sum(w * f(*args)) for a random weight w, port (autograd
    through the scans' adjoint walks) and JAX (jax.grad), for every arg."""
    w = _signal(np.shape(port_fn(*(torch.from_numpy(a) for a in args))),
                seed)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    (port_fn(*targs) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * w),
                    argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    return [t.grad.numpy() for t in targs], [np.asarray(g) for g in want]


# ------------------------------------------------------------ host design
def test_designs_and_banks_equal_jax():
    for order, cutoff, btype in DESIGNS:
        for got, want in zip(pf.butter_coeffs(order, cutoff, SR, btype),
                             jf.butter_coeffs(order, cutoff, SR, btype)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(pf.butter_bank(3, 6000.0, 8000.0, SR, "low"),
                         jf.butter_bank(3, 6000.0, 8000.0, SR, "low")):
        np.testing.assert_array_equal(got, want)
    bank = pf.butter_bank(3, 6000.0, 8000.0, SR, "low")
    freqs = np.float32([6000.0, 6031.25, 7000.0, 7999.0, 8100.0])
    sos, zi = pf.bank_select(bank, torch.from_numpy(freqs), 6000.0, 8000.0)
    for f, s, z in zip(freqs, sos, zi):
        js, jz = jf.bank_select(bank, jnp.float32(f), 6000.0, 8000.0)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))


# ------------------------------------------------------------- the scans
@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("with_zi", [False, True])
def test_sosfilt_matches_jax(design, with_zi):
    sos, zi = jf.butter_sos(design[0], design[1], SR, design[2])
    x = _signal((2, 3, 1500))
    got = pf.sosfilt(sos, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    if with_zi:
        z = zi * _signal((2, 3, 1, 1), 2)
        _close_out(lambda a, b: pf.sosfilt(sos, a, b),
                   lambda a, b: jf.sosfilt(jnp.asarray(sos), a, b), design,
                   x, z)
    else:
        _close_out(lambda a: pf.sosfilt(sos, a),
                   lambda a: jf.sosfilt(jnp.asarray(sos), a), design, x)


@pytest.mark.parametrize("design", DESIGNS)
def test_sosfilt_gradients_match_jax(design):
    sos, zi = jf.butter_sos(design[0], design[1], SR, design[2])
    x = _signal((2, 800))
    z0 = np.broadcast_to(zi, (2,) + zi.shape) * _signal((2, 1, 1), 3)
    got, want = _grads(lambda a, z: pf.sosfilt(sos, a, z),
                       lambda a, z: jf.sosfilt(jnp.asarray(sos), a, z),
                       x, np.ascontiguousarray(z0))
    for g, w in zip(got, want):
        _close(g, w, GRAD_BAR)


def test_per_row_sos_matches_jax_vmap():
    """One filter a row (the roll-off bank's per-item pick) against JAX's
    vmap of sosfilt over items."""
    soss, zis = pf.butter_bank(3, 6000.0, 8000.0, SR, "low")
    pick = np.array([0, 17, 48])
    x = _signal((3, 2, 1000))
    got = pf.sosfilt(soss[pick][:, None], torch.from_numpy(x),
                     torch.from_numpy(zis[pick][:, None]))
    want = jax.vmap(jf.sosfilt)(jnp.asarray(soss[pick]), jnp.asarray(x),
                                jnp.asarray(zis[pick]))
    _close(got.numpy(), want, OUT_BAR)


@pytest.mark.parametrize("design", DESIGNS)
def test_sosfiltfilt_and_butter_filtfilt_match_jax(design):
    x = _signal((2, 4000))
    _close_out(lambda a: pf.butter_filtfilt(a, design[0], design[1], SR,
                                            design[2]),
               lambda a: jf.butter_filtfilt(a, design[0], design[1], SR,
                                            design[2]), design, x)
    got = pf.butter_filtfilt(torch.from_numpy(x), design[0], design[1], SR,
                             design[2])
    sos, zi = pf.butter_sos(design[0], design[1], SR, design[2])
    again = pf.sosfiltfilt(sos, torch.from_numpy(x), zi=zi)
    assert torch.equal(again, got)


@pytest.mark.parametrize("design", DESIGNS)
def test_sosfiltfilt_gradients_match_jax(design):
    sos, zi = jf.butter_sos(design[0], design[1], SR, design[2])
    got, want = _grads(
        lambda a: pf.sosfiltfilt(sos, a, zi=zi),
        lambda a: jf.sosfiltfilt(jnp.asarray(sos), a, zi=jnp.asarray(zi)),
        _signal((2, 1000)))
    _close(got[0], want[0], GRAD_BAR)


# (b, a) designs for direct form II: lfilter's own cutoffs stay where the
# transfer-function form is stable in f32
TF_DESIGNS = [(4, 0.2, "high"), (2, 0.05, "low"), (3, 0.6, "low")]


def _tf(design):
    from scipy import signal as sig

    b, a = sig.butter(design[0], design[1], btype=design[2])
    return b.astype(np.float32), a.astype(np.float32)


@pytest.mark.parametrize("design", TF_DESIGNS)
def test_lfilter_and_zi_match_jax(design):
    b, a = _tf(design)
    x = _signal((2, 500))
    zi = np.asarray(jf._lfilter_zi_jnp(jnp.asarray(b), jnp.asarray(a)))
    got_zi = pf.lfilter_zi(b, a)
    _close(got_zi.numpy(), zi, OUT_BAR)
    for z in (None, zi * _signal((2, 1), 4)):
        got = pf.lfilter(b, a, torch.from_numpy(x),
                         None if z is None else torch.from_numpy(z))
        want = jf.lfilter(jnp.asarray(b), jnp.asarray(a), jnp.asarray(x),
                          None if z is None else jnp.asarray(z))
        _close(got.numpy(), want, OUT_BAR)


@pytest.mark.parametrize("design", TF_DESIGNS)
def test_filtfilt_matches_jax_with_gradients(design):
    b, a = _tf(design)
    x = _signal((2, 1200))
    got = pf.filtfilt(b, a, torch.from_numpy(x))
    want = jf.filtfilt(jnp.asarray(b), jnp.asarray(a), jnp.asarray(x))
    _close(got.numpy(), want, OUT_BAR)
    g, w = _grads(lambda v: pf.filtfilt(b, a, v),
                  lambda v: jf.filtfilt(jnp.asarray(b), jnp.asarray(a), v),
                  x[:, :600])
    _close(g[0], w[0], GRAD_BAR)


def test_lfilter_gradients_match_jax():
    b, a = _tf(TF_DESIGNS[0])
    zi = np.asarray(jf._lfilter_zi_jnp(jnp.asarray(b), jnp.asarray(a)))
    got, want = _grads(
        lambda v, z: pf.lfilter(b, a, v, z),
        lambda v, z: jf.lfilter(jnp.asarray(b), jnp.asarray(a), v, z),
        _signal((2, 600)), np.ascontiguousarray(
            np.broadcast_to(zi, (2, 4)) * 0.5))
    for g, w in zip(got, want):
        _close(g, w, GRAD_BAR)


def test_adjoint_walks_are_the_plain_loops_gradients():
    """The plain adjoint walks against torch autograd through the plain
    forward loops, in float64 on per-row coefficients."""
    rng = np.random.default_rng(7)
    soss, zis = pf.butter_bank(3, 6000.0, 8000.0, SR, "low")
    sos = torch.from_numpy(soss[[3, 30]].astype(np.float64))
    x = torch.from_numpy(rng.normal(size=(2, 300)))
    zi = torch.from_numpy(zis[[3, 30]].astype(np.float64) * 0.7)
    gy = torch.from_numpy(rng.normal(size=(2, 300)))
    xs, zs = x.clone().requires_grad_(), zi.clone().requires_grad_()
    (iir.sos_scan_plain(xs, sos, zs) * gy).sum().backward()
    gx, gzi = iir.sos_adjoint_plain(gy, sos)
    torch.testing.assert_close(gx, xs.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gzi, zs.grad, rtol=1e-12, atol=1e-12)

    b, a = (torch.from_numpy(v.astype(np.float64)) for v in _tf((4, 0.3,
                                                                 "low")))
    ba = torch.cat([b, a]).expand(2, 10).contiguous()
    z0 = torch.from_numpy(rng.normal(size=(2, 4)))
    xs, zs = x.clone().requires_grad_(), z0.clone().requires_grad_()
    (iir.df2t_scan_plain(xs, ba, zs) * gy).sum().backward()
    gx, gzi = iir.df2t_adjoint_plain(gy, ba)
    torch.testing.assert_close(gx, xs.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gzi, zs.grad, rtol=1e-12, atol=1e-12)


def test_short_inputs_rejected_as_jax_rejects_them():
    x = torch.ones((1, 10))
    sos, zi = pf.butter_sos(4, 2500.0, 22050.0, "highpass")
    with pytest.raises(ValueError, match="padlen"):
        pf.sosfiltfilt(sos, x, zi=zi)
    b, a, _ = pf.butter_coeffs(4, 100.0, 22050.0, "lowpass")
    with pytest.raises(ValueError, match="padlen"):
        pf.filtfilt(b, a, x)
    with pytest.raises(ValueError, match="zi"):
        pf.sosfiltfilt(sos, torch.ones((1, 100)))


def test_coefficients_take_no_gradient():
    sos, zi = pf.butter_sos(4, 2500.0, SR, "high")
    with pytest.raises(ValueError, match="coefficients"):
        pf.sosfilt(torch.from_numpy(sos).requires_grad_(), torch.ones(1, 50))


# -------------------------------------------------------------- simulator
@pytest.mark.parametrize("shape,overrides", [
    ((2, 1, 3001), {}),
    ((2, 2, 2500), {"rolloff_freq": (5000.0, 7000.0)}),
    ((1, 1, 2500), {"add_rumble": False})])
def test_simulate_batch_iir_matches_jax(shape, overrides):
    key = jax.random.PRNGKey(sum(shape) + 1)
    x = clean_batch(*shape, seed=3)
    jcfg = JArtifactConfig(**overrides)
    want = np.asarray(JA.simulate_batch(key, jnp.asarray(x), SR, jcfg,
                                        filter_mode="iir"))
    draws = jax_draws(key, shape, SR, jcfg)
    got = PA.apply_artifacts(torch.from_numpy(x), draws, SR,
                             ArtifactConfig(**overrides), filter_mode="iir")
    assert got.shape == shape and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= SIM_BAR
    fir = PA.apply_artifacts(torch.from_numpy(x), draws, SR,
                             ArtifactConfig(**overrides))
    # the FIR kernels are truncated responses: another degradation
    assert float((fir - got).abs().max()) > 1e-3


def test_simulate_batch_iir_runs_six_walks():
    """simulate_batch(filter_mode="iir") is draw then apply, and runs its
    filters as six forward walks (three zero-phase filters, two walks
    each) with no Python loop beyond them."""
    x = torch.from_numpy(clean_batch(2, 1, 2000))
    calls = []
    real = iir._sos_forward

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    iir._sos_forward, saved = counting, iir._sos_forward
    try:
        one = PA.simulate_batch(torch.Generator().manual_seed(3), x, SR,
                                filter_mode="iir")
    finally:
        iir._sos_forward = saved
    draws = PA.draw_artifacts(torch.Generator().manual_seed(3), x.shape, SR)
    assert torch.equal(one, PA.apply_artifacts(x, draws, SR,
                                               filter_mode="iir"))
    assert calls == [(2, 2030)] * 6
