"""The port's LSTM against the JAX package's.

`lstm_recurrence_plain` is held against the JAX scan and against the
Pallas kernel run in interpret mode (as tests/test_ops.py runs it) at 1e-6
in f32: the same per-step arithmetic, summed in another order. bf16 gates
compare at 1e-2: both sides round h to bf16 before the product, but a
different f32 summation order can flip one bf16 rounding, and the
recurrence carries it forward. The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py there, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ml_audio_restoration_tpu.ops.lstm import (
    lstm as jax_lstm, lstm_recurrence_scan, stacked_lstm as jax_stacked_lstm)
from ml_audio_restoration_tpu.ops.pallas.lstm import lstm_recurrence_pallas
from ml_audio_restoration_torch.ops import lstm as L


def _inputs(rng, t, b, h, carry=True):
    gates = (rng.normal(size=(t, b, 4 * h)) * 0.3).astype(np.float32)
    w_hh = (rng.normal(size=(h, 4 * h)) * 0.2).astype(np.float32)
    if carry:
        h0, c0 = ((rng.normal(size=(b, h)) * 0.3).astype(np.float32)
                  for _ in range(2))
    else:
        h0 = c0 = np.zeros((b, h), np.float32)
    return gates, w_hh, h0, c0


def _plain(gates, w_hh, h0, c0):
    return [a.float().numpy() for a in L.lstm_recurrence_plain(
        *(torch.from_numpy(a) for a in (gates, w_hh, h0, c0)))]


@pytest.mark.parametrize("t,b,h", [(301, 5, 8), (64, 3, 16), (1, 2, 8)])
def test_plain_matches_scan(rng, t, b, h):
    gates, w_hh, h0, c0 = _inputs(rng, t, b, h)
    want, (wh, wc) = lstm_recurrence_scan(
        jnp.asarray(gates), jnp.asarray(w_hh),
        carry=(jnp.asarray(h0), jnp.asarray(c0)), return_carry=True,
        time_major=True)
    out, hf, cf = _plain(gates, w_hh, h0, c0)
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(hf, np.asarray(wh), atol=1e-6)
    np.testing.assert_allclose(cf, np.asarray(wc), atol=1e-6)


@pytest.mark.parametrize("t,b,carry", [(150, 3, True), (77, 9, False)])
def test_plain_matches_pallas_interpret(rng, t, b, carry):
    """Odd T (padded to the kernel's block grid, carry taken at the true
    last step) and B not a multiple of 8."""
    gates, w_hh, h0, c0 = _inputs(rng, t, b, 8, carry)
    want, (wh, wc) = lstm_recurrence_pallas(
        jnp.asarray(gates), jnp.asarray(w_hh),
        (jnp.asarray(h0), jnp.asarray(c0)), block_t=64, time_major=True,
        interpret=True)
    out, hf, cf = _plain(gates, w_hh, h0, c0)
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(hf, np.asarray(wh), atol=1e-6)
    np.testing.assert_allclose(cf, np.asarray(wc), atol=1e-6)


def test_two_halves_carry_continuity(rng):
    """Two halves with the carry threaded through equal one run."""
    gates, w_hh, h0, c0 = _inputs(rng, 201, 3, 8)
    out, hf, cf = _plain(gates, w_hh, h0, c0)
    a, ha, ca = _plain(gates[:90], w_hh, h0, c0)
    z, hz, cz = _plain(gates[90:], w_hh, ha, ca)
    np.testing.assert_allclose(np.concatenate([a, z], axis=1), out,
                               atol=1e-6)
    np.testing.assert_allclose(hz, hf, atol=1e-6)
    np.testing.assert_allclose(cz, cf, atol=1e-6)
    want = lstm_recurrence_scan(
        jnp.asarray(gates), jnp.asarray(w_hh),
        carry=(jnp.asarray(h0), jnp.asarray(c0)), time_major=True)
    np.testing.assert_allclose(np.concatenate([a, z], axis=1),
                               np.asarray(want), atol=1e-6)


def test_bf16_time_major_gates(rng):
    """bf16 gates and W_hh: bf16 output, f32 carry, against the Pallas
    kernel's own bf16 arithmetic (interpret mode) and the f32 scan."""
    gates, w_hh, h0, c0 = _inputs(rng, 150, 3, 8, carry=False)
    tg = torch.from_numpy(gates).bfloat16()
    tw = torch.from_numpy(w_hh).bfloat16()
    out, hf, cf = L.lstm_recurrence_plain(tg, tw, torch.from_numpy(h0),
                                          torch.from_numpy(c0))
    assert out.dtype == torch.bfloat16 and hf.dtype == torch.float32
    want, (wh, wc) = lstm_recurrence_pallas(
        jnp.asarray(gates).astype(jnp.bfloat16),
        jnp.asarray(w_hh).astype(jnp.bfloat16), time_major=True,
        interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want).astype(np.float32), atol=1e-2)
    np.testing.assert_allclose(hf.numpy(), np.asarray(wh), atol=1e-2)
    np.testing.assert_allclose(cf.numpy(), np.asarray(wc), atol=1e-2)
    f32 = lstm_recurrence_scan(jnp.asarray(gates), jnp.asarray(w_hh),
                               time_major=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(f32),
                               atol=0.05)


def _params(rng, c, h):
    return {"w_ih": (rng.normal(size=(c, 4 * h)) * 0.2).astype(np.float32),
            "w_hh": (rng.normal(size=(h, 4 * h)) * 0.2).astype(np.float32),
            "b_ih": (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32),
            "b_hh": (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32)}


def _t(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def test_lstm_matches_jax(rng):
    """Projection + recurrence, with a carry in and out (1e-5: the
    projection GEMM sums over C in another order)."""
    x = rng.normal(size=(3, 97, 12)).astype(np.float32)
    p = _params(rng, 12, 16)
    h0, c0 = ((rng.normal(size=(3, 16)) * 0.3).astype(np.float32)
              for _ in range(2))
    want, (wh, wc) = jax_lstm(jnp.asarray(x), _j(p), impl="scan",
                              carry=(jnp.asarray(h0), jnp.asarray(c0)),
                              return_carry=True)
    got, (gh, gc) = L.lstm(torch.from_numpy(x), _t(p),
                           carry=(torch.from_numpy(h0), torch.from_numpy(c0)),
                           return_carry=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5)


def test_stacked_lstm_matches_jax(rng):
    x = rng.normal(size=(2, 60, 12)).astype(np.float32)
    layers = [_params(rng, 12, 8), _params(rng, 8, 8)]
    want, wcar = jax_stacked_lstm(jnp.asarray(x), [_j(p) for p in layers],
                                  return_carries=True, impl="scan")
    got, gcar = L.stacked_lstm(torch.from_numpy(x), [_t(p) for p in layers],
                               return_carries=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for (gh, gc), (wh, wc) in zip(gcar, wcar):
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-5)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5)


def test_cpu_tensor_takes_plain_path(rng):
    """A CPU tensor never reaches the kernel: the launch count stays put."""
    gates, w_hh, h0, c0 = _inputs(rng, 20, 2, 8)
    before = L.launch_count
    got = L.lstm_recurrence(*(torch.from_numpy(a)
                              for a in (gates, w_hh, h0, c0)))
    want = _plain(gates, w_hh, h0, c0)
    assert L.launch_count == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_plain_recurrence_hook_restores_state():
    assert not L._force_plain
    with L.plain_recurrence():
        assert L._force_plain
    assert not L._force_plain

