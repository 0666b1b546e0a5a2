"""The port's CUDA kernels and training step on a card, against their plain
versions. Every test here needs a CUDA card and skips without one.

This file imports nothing of JAX (the card's machine has none), so it runs
there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Bars: K1 1e-5 in f32 and 1e-2 in bf16 (a summation-order change can flip one
bf16 rounding of h, which the recurrence carries), also at the serving shapes
(0.25 s stereo windows of a 120 s restore, T=11,024 B=640; a streaming
lookahead run, T=1,031 B=16 from a carry) and through one streaming feed (1e-4,
the chain's kernel-vs-plain bar); K2 1e-5; K3 2e-5 on dgx, dh0 and dc0 (the bar
JAX holds its Pallas backward to) and 1e-4 of its largest entry on dW_hh (a sum
over T*B outer products); a train step on the smooth loss terms 1e-4
(chip_smoke.py's bar; the reference loss's log-magnitude terms are
ill-conditioned in f32, PERF.md). K2 with bf16 gates and K3 also at the stereo
fast-train preset's shape (T=11,025 B=64, config/stereo_fast_train.yaml), two
seeded bf16 runs of each family equal bit for bit, and the f32 training LSTM
(`LSTMTrain`) equal bit for bit to the fused-bias projection and
`LSTMRecurrenceTrain`. The conv-net families: the 78rpm degradation 1e-5
against the CPU on the same draws, and two seeded runs equal bit for bit.
"""
import contextlib

import numpy as np
import pytest
import torch

from ml_audio_restoration_torch.config import TrainConfig
from ml_audio_restoration_torch.models import (
    AudioDenoiser, AudioSuperResolution, StereoSeparator, init_params)
from ml_audio_restoration_torch.ops import lstm as L
from ml_audio_restoration_torch.pipeline import StreamingRestorer
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
@pytest.mark.parametrize("t,b,carry,dtype,tol", [
    (11024, 640, False, torch.bfloat16, 1e-2),
    (11024, 640, False, torch.float32, 1e-5),
    (1031, 16, True, torch.float32, 1e-5),
    (1031, 16, True, torch.bfloat16, 1e-2)])
def test_inference_kernel_at_serving_shapes(card, t, b, carry, dtype, tol):
    """K1 at the sub-chunked restore's shape (640 rows: more than one CTA
    an SM) and at a streaming lookahead run's (short, odd T, a carry in)."""
    args, _ = _inputs(t, b, 64, seed=5)
    gates, w_hh, h0, c0 = (a.to(card) for a in args)
    if not carry:
        h0, c0 = torch.zeros_like(h0), torch.zeros_like(c0)
    gates, w_hh = gates.to(dtype), w_hh.to(dtype)
    got = L._lstm_recurrence_cuda(gates, w_hh, h0, c0)
    want = L.lstm_recurrence_plain(gates, w_hh, h0, c0)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        assert float((g.float() - w.float()).abs().max()) <= tol
    res = L.recurrence_resources(64, dtype)
    assert res["ctas_per_sm"] >= 1 and res["regs_per_thread"] > 0


@pytest.mark.cuda
def test_streaming_feed_kernel_matches_plain(card):
    """Two feeds of 4 streams at full width: the second feed (a carry in,
    the lookahead run) through K1 equals it through the plain recurrence,
    with two K1 launches a feed."""
    gen = torch.Generator().manual_seed(3)
    models = [init_params(m, gen) for m in (
        AudioDenoiser(), AudioSuperResolution(), StereoSeparator())]
    rng = np.random.default_rng(4)
    blocks = (rng.normal(size=(2, 4, 4000)) * 0.1).astype(np.float32)
    outs = []
    for plain in (False, True):
        s = StreamingRestorer(*models, batch=4, device=card)
        with L.plain_recurrence() if plain else contextlib.nullcontext():
            s.feed(blocks[0])
            before = L.launch_count
            outs.append(s.feed(blocks[1]))
            launched = L.launch_count - before
        assert launched == (0 if plain else 2)
    assert outs[0].shape == (4, 2, 2 * 4000)
    assert float(np.abs(outs[0] - outs[1]).max()) <= 1e-4


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
def test_train_kernels_at_the_fast_train_shape(card):
    """K2 on bf16 gates and K3 at T=11,025 B=64 H=64: T % 8 == 1, so the
    8-step cp.async blocks end in a partial block of one step."""
    t, b, h = 11025, 64, 64
    args, cots = _inputs(t, b, h, seed=3)
    gates, w_hh, h0, c0 = (a.to(card) for a in args)
    gates = gates.bfloat16()
    dout, dhf, dcf = (a.to(card) for a in cots)
    k = L._lstm_train_fwd_cuda(gates, w_hh, h0, c0)
    p = L.lstm_recurrence_train_plain(gates, w_hh, h0, c0)
    assert all(x.dtype == torch.float32 for x in k)
    for x, y in zip(k, p):
        assert float((x - y).abs().max()) <= 1e-5
    kb = L._lstm_train_bwd_cuda(p[3], p[4], p[0], h0, c0, w_hh, dout, dhf,
                                dcf)
    pb = L.lstm_recurrence_bwd_plain(p[3], p[4], p[0], h0, c0, w_hh, dout,
                                     dhf, dcf)
    for i in (0, 2, 3):
        assert float((kb[i] - pb[i]).abs().max()) <= 2e-5
    assert float((kb[1] - pb[1]).abs().max()) <= 1e-4 * float(
        pb[1].abs().max())


@pytest.mark.cuda
def test_f32_training_lstm_matches_the_fused_projection(card):
    """f32 `lstm` under grad (LSTMTrain: the projection as a product plus
    the bias, K2, K3, the projection's backward) gives the output and
    gradients of the fused-bias `addmm` and LSTMRecurrenceTrain, bit for
    bit, at the stereo net's LSTM (C=128, H=64) over T=2,048 B=16."""
    t, b, c, h = 2048, 16, 128, 64
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32))
    params = {k: torch.from_numpy((rng.normal(size=s) * 0.1).astype(
        np.float32)) for k, s in (("w_ih", (c, 4 * h)), ("w_hh", (h, 4 * h)),
                                   ("b_ih", (4 * h,)), ("b_hh", (4 * h,)))}
    dy = torch.from_numpy(rng.normal(size=(b, t, h)).astype(np.float32))

    def run(route):
        tp = {k: v.to(card).requires_grad_() for k, v in params.items()}
        tx = x.to(card).requires_grad_()
        if route == "lstm":
            y = L.lstm(tx, tp)
        else:
            gates = torch.addmm(tp["b_ih"] + tp["b_hh"],
                                tx.transpose(0, 1).reshape(t * b, c),
                                tp["w_ih"]).view(t, b, -1)
            h0 = torch.zeros(b, h, device=card)
            y = L.LSTMRecurrenceTrain.apply(gates, tp["w_hh"], h0,
                                            h0)[0].transpose(0, 1)
        (y * dy.to(card)).sum().backward()
        return [y.detach(), tx.grad] + [tp[k].grad for k in params]

    for a, b_ in zip(run("lstm"), run("composition")):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("name,pairing,key,model", [
    ("stereo_separator", "mono_target_stereo", "stereo",
     lambda: StereoSeparator(base_channels=8, lstm_hidden=16)),
    ("denoiser", "degrade", "clean", AudioDenoiser),
    ("super_resolution", "downsample", "high", AudioSuperResolution)])
def test_bf16_runs_repeat_bit_for_bit(card, name, pairing, key, model):
    """Two seeded 2-step bf16 runs on the card are equal bit for bit (the
    stereo net's through K2/K3 with bf16 gates, once each a step), and
    parameters, Adam state and BN statistics stay f32."""
    rng = np.random.default_rng(4)
    ch = 2 if key == "stereo" else 1
    batch = {key: (0.3 * rng.standard_normal((2, ch, 4096))).astype(
        np.float32)}
    config = TrainConfig(model=name, compute_dtype="bfloat16",
                         learning_rate=1e-3, ema_decay=0.9)
    runs = []
    for _ in range(2):
        tr = Trainer(name, init_params(model(),
                                       torch.Generator().manual_seed(0)),
                     [], pairing=pairing, config=config, device=card)
        before = (L.train_fwd_launch_count, L.train_bwd_launch_count)
        losses = [float(tr._train_step(batch, tr._seeded(2, i))["loss"])
                  for i in range(2)]
        launched = (L.train_fwd_launch_count - before[0],
                    L.train_bwd_launch_count - before[1])
        assert launched == ((2, 2) if name == "stereo_separator"
                            else (0, 0))
        runs.append((losses, tr.model.state_dict(), tr.ema_params))
        assert all(v.dtype != torch.bfloat16
                   for v in tr.model.state_dict().values())
        for st in tr.optimizer.state.values():
            assert st["exp_avg"].dtype == torch.float32
    assert runs[0][0] == runs[1][0] and np.isfinite(runs[0][0]).all()
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    assert all(torch.equal(v, runs[1][2][k]) for k, v in runs[0][2].items())


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


# ------------------------------------------------- conv-net training
def _mono(b, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 1, t))
    return (0.1 * x / np.sqrt(np.mean(x ** 2))).astype(np.float32)


@pytest.mark.cuda
def test_degradation_matches_cpu_and_repeats(card):
    """The 78rpm simulator on the card against the CPU on the same draws
    (1e-5, chip_smoke.py's bar), bit for bit on a rerun, and a CPU
    generator gives the card the CPU's degradation."""
    from ml_audio_restoration_torch.data import artifacts as A

    clean = torch.from_numpy(_mono(4, 22050, 0))
    draws = A.draw_artifacts(torch.Generator().manual_seed(0), clean.shape,
                             22050)
    want = A.apply_artifacts(clean, draws, 22050)
    on_card = {k: v.to(card) for k, v in draws.items()}
    got = A.apply_artifacts(clean.to(card), on_card, 22050)
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    assert torch.equal(got, A.apply_artifacts(clean.to(card), on_card,
                                              22050))
    via = A.simulate_batch(torch.Generator().manual_seed(0), clean.to(card),
                           22050)
    assert float((via.cpu() - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name,pairing,key", [
    ("denoiser", "degrade", "clean"),
    ("super_resolution", "downsample", "high")])
def test_convnet_runs_repeat_bit_for_bit(card, name, pairing, key):
    """Two 3-step runs from one seed on the card are equal bit for bit,
    the degradation drawn on the card included; the step matches the CPU's
    on the smooth terms (1e-4 relative loss)."""
    model_cls = AudioDenoiser if name == "denoiser" else AudioSuperResolution
    batch = {key: _mono(4, 4096, 1)}
    config = TrainConfig(model=name, spectral_weight=0.0, learning_rate=1e-3)
    runs = []
    for _ in range(2):
        tr = Trainer(name, init_params(model_cls(),
                                       torch.Generator().manual_seed(0)),
                     [], pairing=pairing, config=config, device=card)
        losses = [float(tr._train_step(batch, tr._seeded(2, i))["loss"])
                  for i in range(3)]
        runs.append((losses, tr.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    losses = []
    for device in (card, "cpu"):
        tr = Trainer(name, init_params(model_cls(),
                                       torch.Generator().manual_seed(0)),
                     [], pairing=pairing, config=config, device=device)
        losses.append(float(tr._train_step(
            batch, torch.Generator().manual_seed(5))["loss"]))
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
