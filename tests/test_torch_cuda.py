"""The port's CUDA kernels and training step on a card, against their plain
versions. Every test here needs a CUDA card and skips without one.

This file imports nothing of JAX (the card's machine has none), so it runs
there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Bars: K1 1e-5 in f32 and 1e-2 in bf16 (a summation-order change can flip
one bf16 rounding of h, which the recurrence carries); K2 1e-5; K3 2e-5 on
dgx, dh0 and dc0 (the bar JAX holds its Pallas backward to) and 1e-4 of its
largest entry on dW_hh (a sum over T*B outer products); a train step
on the smooth loss terms 1e-4 (chip_smoke.py's bar; the reference loss's
log-magnitude terms are ill-conditioned in f32, PERF.md).
"""
import contextlib

import numpy as np
import pytest
import torch

from ml_audio_restoration_torch.config import TrainConfig
from ml_audio_restoration_torch.models import StereoSeparator, init_params
from ml_audio_restoration_torch.ops import lstm as L
from ml_audio_restoration_torch.train.trainer import Trainer


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# every H the kernels take, at an odd T with B not a multiple of 8 and at
# one step of one row
SHAPES = [(t, b, h) for h in (16, 32, 64) for t, b in ((301, 5), (1, 1))]


def _inputs(t, b, h, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    gates = (rng.normal(size=(t, b, 4 * h)) * scale).astype(np.float32)
    w_hh = (rng.normal(size=(h, 4 * h)) * 0.2).astype(np.float32)
    h0, c0 = ((rng.normal(size=(b, h)) * 0.3).astype(np.float32)
              for _ in range(2))
    dout = (rng.normal(size=(t, b, h)) * 0.1).astype(np.float32)
    dhf, dcf = ((rng.normal(size=(b, h)) * 0.1).astype(np.float32)
                for _ in range(2))
    return [torch.from_numpy(a) for a in (gates, w_hh, h0, c0)], [
        torch.from_numpy(a) for a in (dout, dhf, dcf)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_inference_kernel_matches_plain(card, dtype, tol, t, b, h):
    """K1 with a random carry in."""
    args, _ = _inputs(t, b, h)
    args = [a.to(card) for a in args]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    before = L.launch_count
    got = L.lstm_recurrence(*args)
    assert L.launch_count == before + 1
    want = L.lstm_recurrence_plain(*args)
    assert got[0].dtype == dtype
    for g, w in zip(got, want):
        assert float((g.float() - w.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h", SHAPES)
def test_train_kernels_match_plain(card, t, b, h):
    """K2 and K3 (walk and dW_hh pass) with a random carry in and random
    cotangents."""
    args, cots = _inputs(t, b, h, seed=1)
    gates, w_hh, h0, c0 = (a.to(card) for a in args)
    dout, dhf, dcf = (a.to(card) for a in cots)
    before = (L.train_fwd_launch_count, L.train_bwd_launch_count)
    k = L._lstm_train_fwd_cuda(gates, w_hh, h0, c0)
    p = L.lstm_recurrence_train_plain(gates, w_hh, h0, c0)
    for x, y in zip(k, p):
        assert float((x - y).abs().max()) <= 1e-5
    kb = L._lstm_train_bwd_cuda(p[3], p[4], p[0], h0, c0, w_hh, dout, dhf,
                                dcf)
    pb = L.lstm_recurrence_bwd_plain(p[3], p[4], p[0], h0, c0, w_hh, dout,
                                     dhf, dcf)
    for i in (0, 2, 3):  # dgx, dh0, dc0
        assert float((kb[i] - pb[i]).abs().max()) <= 2e-5
    assert float((kb[1] - pb[1]).abs().max()) <= 1e-4 * float(
        pb[1].abs().max())
    assert (L.train_fwd_launch_count, L.train_bwd_launch_count) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [16, 32, 64])
def test_kernels_saturated_gates(card, h):
    """Gates of magnitude ~60 push every activation into saturation, where
    the kernels' exp overflows: K1's and K2's outputs and K3's gradients
    are finite and equal the plain versions'."""
    args, cots = _inputs(301, 5, h, seed=2, scale=60.0)
    gates, w_hh, h0, c0 = (a.to(card) for a in args)
    dout, dhf, dcf = (a.to(card) for a in cots)
    got = L._lstm_recurrence_cuda(gates, w_hh, h0, c0)
    want = L.lstm_recurrence_plain(gates, w_hh, h0, c0)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-5
    got = L._lstm_train_fwd_cuda(gates, w_hh, h0, c0)
    want = L.lstm_recurrence_train_plain(gates, w_hh, h0, c0)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-5
    out, _, _, acts, cseq = want
    res = (acts, cseq, out, h0, c0, w_hh, dout, dhf, dcf)
    kb = L._lstm_train_bwd_cuda(*res)
    pb = L.lstm_recurrence_bwd_plain(*res)
    for i, (x, y) in enumerate(zip(kb, pb)):
        assert bool(torch.isfinite(x).all())
        tol = 1e-4 * float(y.abs().max()) if i == 1 else 2e-5
        assert float((x - y).abs().max()) <= tol


@pytest.mark.cuda
def test_train_forward_repeats_bit_for_bit(card):
    """A fixed summation order: two K2 runs on the same inputs are equal."""
    args, _ = _inputs(1001, 13, 64, seed=4)
    args = [a.to(card) for a in args]
    first, second = L._lstm_train_fwd_cuda(*args), L._lstm_train_fwd_cuda(
        *args)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_train_backward_repeats_bit_for_bit(card):
    """No float atomics: two K3 runs on the same inputs are equal."""
    args, cots = _inputs(1001, 13, 64, seed=3)
    gates, w_hh, h0, c0 = (a.to(card) for a in args)
    dout, dhf, dcf = (a.to(card) for a in cots)
    out, _, _, acts, cseq = L.lstm_recurrence_train_plain(gates, w_hh, h0,
                                                          c0)
    res = (acts, cseq, out, h0, c0, w_hh, dout, dhf, dcf)
    first, second = L._lstm_train_bwd_cuda(*res), L._lstm_train_bwd_cuda(*res)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_train_step_matches_plain(card):
    """A train step runs K2/K3 once each and matches the step through the
    plain recurrence on the smooth loss terms."""
    base = init_params(StereoSeparator(base_channels=8, lstm_hidden=16),
                       torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    batch = {"stereo": (0.3 * rng.standard_normal((2, 2, 4096))).astype(
        np.float32)}
    config = TrainConfig(model="stereo_separator", spectral_weight=0.0,
                         clustering_weight=0.0, max_grad_norm=1.0)
    runs = []
    for plain in (False, True):
        tr = Trainer("stereo_separator", init_params(
            StereoSeparator(base_channels=8, lstm_hidden=16),
            torch.Generator().manual_seed(0)), [],
            pairing="mono_target_stereo", config=config, device=card)
        tr.model.load_state_dict(base.state_dict())
        before = (L.train_fwd_launch_count, L.train_bwd_launch_count)
        with L.plain_recurrence() if plain else contextlib.nullcontext():
            loss = float(tr._train_step(batch)["loss"])
        launched = (L.train_fwd_launch_count - before[0],
                    L.train_bwd_launch_count - before[1])
        assert launched == ((0, 0) if plain else (1, 1))
        runs.append((loss, [p.grad for p in tr.model.parameters()]))
    (lk, gk), (lp, gp) = runs
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    scale = max(float(g.abs().max()) for g in gp)
    assert max(float((a - b).abs().max()) for a, b in zip(gk, gp)) \
        <= 1e-4 * scale
