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
Files: a FLAC corpus through the C++ batch reader feeding a card step, equal
to its WAV twin bit for bit, and a `.msgpack` pipeline on the card equal to
its `.pth` twin bit for bit. int8: csrc/int8_conv.cu against its plain
version bit for bit over the int8 layers' geometries and every epilogue,
and an int8 restore on the card (bit for bit its plain-conv twin, within a
quarter of its int8-vs-f32 deviation of the CPU on the same scales).
IIR scans: csrc/iir_scan.cu's forward and adjoint walks bit for bit their
plain versions (biquad cascades of 1 to 4 sections, direct form II of order
1 to 8, f32 and f64, one filter a row), and simulate_batch(filter_mode=
"iir") on the card within 1e-5 of the CPU on the same draws, in six
forward launches.
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


# ------------------------------------------------- files: FLAC, .msgpack
@pytest.mark.cuda
def test_native_batch_reader_feeds_a_card_step(card, tmp_path):
    """A FLAC corpus read by the C++ batch reader (RestorationDataset's
    `getitems`, two threads) feeds a denoiser step on the card; the same
    audio as 16-bit WAV gives the same batch and the same loss, bit for
    bit."""
    from ml_audio_restoration_torch.audio import save_audio
    from ml_audio_restoration_torch.data import DataLoader, RestorationDataset

    for i in range(4):
        x = _mono(1, 6000 + 500 * i, i)[0]
        for ext in ("wav", "flac"):
            save_audio(tmp_path / ext / f"f{i}.{ext}", x, 22050)
    config = TrainConfig(model="denoiser", spectral_weight=0.0)
    batches, losses = [], []
    for ext in ("wav", "flac"):
        ds = RestorationDataset(tmp_path / ext, chunk_duration=0.2, seed=1)
        batch = next(iter(DataLoader(ds, 4, seed=2, num_workers=2)))
        tr = Trainer("denoiser", init_params(
            AudioDenoiser(features=(8, 16)),
            torch.Generator().manual_seed(0)), [], pairing="degrade",
            config=config, device=card)
        losses.append(float(tr._train_step(batch, tr._seeded(0, 0))["loss"]))
        batches.append(batch["clean"])
    assert np.array_equal(batches[0], batches[1])
    assert losses[0] == losses[1] and np.isfinite(losses[0])


@pytest.mark.cuda
def test_msgpack_pipeline_equals_its_pth_twin_on_the_card(card, tmp_path):
    """A pipeline from `.msgpack` files (the port's writer, the JAX
    package's layout) restores on the card through K1 bit for bit like the
    pipeline from the same weights' `.pth` files."""
    from ml_audio_restoration_torch.compat import (
        jax_from_state_dict, msgpack, save_pth)
    from ml_audio_restoration_torch.config import PipelineConfig
    from ml_audio_restoration_torch.pipeline import RestorationPipeline

    models = {"denoiser": AudioDenoiser(features=(8, 16)),
              "super_resolution": AudioSuperResolution(
                  base_channels=8, num_residual_blocks=2),
              "stereo_separator": StereoSeparator(base_channels=8,
                                                  lstm_hidden=16)}
    files = {"msgpack": [], "pth": []}
    for i, (name, model) in enumerate(models.items()):
        sd = init_params(model, torch.Generator().manual_seed(i)).state_dict()
        params, state = jax_from_state_dict(name, sd)
        path = tmp_path / f"{name}.msgpack"
        path.write_bytes(msgpack.dumps({"params": params,
                                        "model_state": state,
                                        "model_name": name}))
        files["msgpack"].append(path)
        files["pth"].append(save_pth(tmp_path / f"{name}.pth", name, sd))
    audio = _mono(1, 30000, 3)[0]
    outs = []
    for kind in ("msgpack", "pth"):
        pipe = RestorationPipeline.from_checkpoints(
            *files[kind], config=PipelineConfig(chunk_seconds=0.5),
            device=card)
        L.reset_launch_count()
        out, rate = pipe.restore(audio, 22050)
        assert L.launch_count == 1 and rate == 44100
        outs.append(out)
    assert outs[0].shape == (2, 60000) and torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])


# (n, t_in, cin, cout, kp, stride, lhs dilation, pad lo, pad hi): the int8
# layers' geometries (raising stems, r=4 and r=8 convs, the exits under
# lhs dilation 2/4/8 with Cout 1, the stereo decoders' stride 2, the
# full-scope r=1 dilated taps) and edges (a negative pad, Cout 3 and 70,
# Cin 12, several row tiles, lhs dilation 3, phases with no tap, a length
# off the dilation's grid); then the edges of the wgmma and stem paths:
# Cout 256 and 200 (an N tile not a power of two), Cin 256 and 64 (the
# 128- and 64-byte swizzles), T_out one past and one short of a 128-row
# tile, stride 2 with an odd T_in, stems with kp 6 and 10 and T_in off the
# stride, rows for more than one wave of CTAs, and a stream feed's length
# at B = 16
INT8_GEOMETRIES = [
    (2, 40, 1, 128, 7, 4, 1, 3, 0), (2, 10, 128, 128, 3, 1, 1, 1, 1),
    (2, 10, 128, 1, 6, 1, 4, 3, 2), (1, 7, 256, 1, 14, 1, 8, 10, 14),
    (2, 9, 64, 32, 3, 1, 1, 1, 1), (2, 13, 64, 256, 7, 2, 1, 3, 1),
    (2, 11, 128, 1, 8, 1, 2, 4, 3), (2, 12, 128, 128, 17, 1, 1, 8, 8),
    (2, 9, 128, 128, 3, 1, 2, 1, 1), (2, 21, 32, 64, 3, 1, 1, -1, 2),
    (1, 5, 4, 3, 2, 1, 1, 0, -1), (3, 70, 12, 70, 5, 2, 1, 2, 2),
    (1, 300, 16, 65, 3, 1, 1, 1, 1), (1, 600, 8, 1, 3, 1, 1, 1, 1),
    (2, 9, 12, 64, 5, 1, 3, 2, 1), (2, 13, 32, 70, 2, 1, 4, 1, 3),
    (1, 17, 16, 1, 7, 1, 3, -2, 5), (3, 30, 64, 128, 9, 1, 4, 5, 0),
    (2, 300, 128, 256, 3, 1, 1, 1, 1), (2, 140, 64, 200, 3, 1, 1, 1, 1),
    (2, 50, 256, 128, 5, 1, 1, 2, 2), (2, 50, 64, 64, 5, 1, 1, 2, 2),
    (1, 129, 128, 64, 3, 1, 1, 1, 1), (1, 127, 128, 64, 3, 1, 1, 1, 1),
    (2, 301, 64, 256, 8, 2, 1, 3, 3), (2, 1001, 1, 128, 6, 4, 1, 1, 1),
    (2, 1003, 1, 128, 10, 4, 1, 3, 3), (8, 11025, 128, 128, 3, 1, 1, 1, 1),
    (16, 12568, 1, 128, 6, 4, 1, 1, 1), (16, 3142, 128, 128, 3, 1, 1, 1, 1)]
# (add, activation, output): f32 / s8 residuals, leaky-ReLU, s8 / f32 / bf16
INT8_EPILOGUES = [(None, None, "s8"), ("f32", "lrelu", "s8"),
                  ("s8", "lrelu", "f32"), (None, "lrelu", "bf16"),
                  ("s8", None, "s8"), ("f32", None, "f32")]


def _int8_case(card, geo, epi, seed):
    from ml_audio_restoration_torch.ops import int8_conv as ic

    n, t_in, cin, cout, kp, stride, dil, lo, hi = geo
    add, act, out = epi
    g = torch.Generator(device=card).manual_seed(seed)
    ints = lambda *s: torch.randint(-127, 128, s, generator=g,  # noqa: E731
                                    device=card).to(torch.int8)
    uni = lambda lo_, hi_, *s: lo_ + (hi_ - lo_) * torch.rand(  # noqa: E731
        s, generator=g, device=card)
    weight = ic.Int8Weight(ints(kp, cin, cout), uni(1e-5, 1e-3, cout),
                           torch.randn(cout, generator=g, device=card))
    t_out = ic.out_length(t_in, kp, stride, dil, (lo, hi))
    kw = dict(stride=stride, lhs_dilation=dil, padding=(lo, hi), act=act)
    if add == "f32":
        kw["add"] = torch.randn((n, t_out, cout), generator=g, device=card)
    elif add == "s8":
        kw["add"], kw["add_scale"] = ints(n, t_out, cout), uni(1e-3, 1e-2,
                                                               cout)
    if out == "s8":
        kw["out_inv"] = 1.0 / uni(1e-3, 3e-2, cout)
    else:
        kw["out_dtype"] = torch.bfloat16 if out == "bf16" else torch.float32
    return ints(n, t_in, cin), weight, kw


@pytest.mark.cuda
@pytest.mark.parametrize("geo", INT8_GEOMETRIES)
def test_int8_conv_kernel_matches_plain(card, geo):
    """csrc/int8_conv.cu against its plain version, bit for bit: the int32
    accumulation is exact and the epilogue the same IEEE f32 operations."""
    from ml_audio_restoration_torch.ops import int8_conv as ic

    n, t_in, cin, cout, kp, stride, dil, lo, hi = geo
    path = ic.plan((n, t_in, cin), (kp, cin, cout), stride, dil,
                   (lo, hi)).path
    assert path == ("wgmma" if cin % 16 == 0 else "stem" if cin == 1
                    else "generic")
    for i, epi in enumerate(INT8_EPILOGUES):
        x, weight, kw = _int8_case(card, geo, epi, seed=i)
        ic.reset_launch_count()
        got = ic.int8_conv(x, weight, **kw)
        assert ic.launch_count == 1
        assert ic.launch_count_by_path == {**dict.fromkeys(ic.PATHS, 0),
                                           path: 1}
        want = ic.int8_conv_plain(x, weight, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int8) if got.dtype == torch.int8
                           else got.float(), want.view(torch.int8)
                           if want.dtype == torch.int8 else want.float()), \
            (geo, epi)


@pytest.mark.cuda
def test_int8_restore_on_the_card(card):
    """An int8 restore on the card: K1 once, the int8 kernel at every int8
    layer, equal bit for bit to the same restore through the plain int8
    conv, and within a quarter of its own int8-vs-f32 deviation of the CPU
    on the same scales."""
    from ml_audio_restoration_torch.config import PipelineConfig
    from ml_audio_restoration_torch.ops import int8_conv as ic
    from ml_audio_restoration_torch.pipeline import RestorationPipeline

    def models():
        gen = torch.Generator().manual_seed(7)
        return [init_params(m, gen).eval() for m in (
            AudioDenoiser(features=(8, 16, 32)),
            AudioSuperResolution(base_channels=8, num_residual_blocks=2),
            StereoSeparator(base_channels=8, lstm_hidden=16))]

    cfg = PipelineConfig(chunk_seconds=4400 / 22050, quantize_int8=True)
    audio = _mono(1, 22050, 5)[0]
    pipe = RestorationPipeline(*models(), config=cfg, device=card)
    pipe.calibrate_int8(audio)
    L.reset_launch_count()
    ic.reset_launch_count()
    out, rate = pipe.restore(audio)
    assert L.launch_count == 1 and ic.launch_count > 0 and rate == 44100
    # at these widths the three stems take the stem path, td2 (Cin 8) the
    # generic one and the 27 other layers (Cin 16-64) wgmma
    assert ic.launch_count_by_path == {"wgmma": 27, "stem": 3, "generic": 1}
    with ic.plain_int8_conv():
        plain, _ = pipe.restore(audio)
    assert torch.equal(out, plain)
    f32, _ = RestorationPipeline(*models(), config=PipelineConfig(
        chunk_seconds=cfg.chunk_seconds), device=card).restore(audio)
    cpu = RestorationPipeline(*models(), config=cfg, device="cpu")
    cpu._int8_scales = pipe._int8_scales
    cpu_out, _ = cpu.restore(audio)
    dev = float((out - f32).abs().max())
    assert dev > 0
    assert float((out.cpu() - cpu_out).abs().max()) <= 0.25 * dev


def _serving_models(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [init_params(m, gen).eval() for m in (
        AudioDenoiser(), AudioSuperResolution(), StereoSeparator())]


def _tone(seconds, f0=330.0, rate=22050):
    t = np.arange(int(seconds * rate)) / rate
    return (0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)[None]


@pytest.mark.cuda
def test_server_restore_on_the_card(card):
    """A RestorationServer over a pipeline on the card answers a request
    bit for bit equal to restore + normalize_audio, with one K1 launch."""
    from ml_audio_restoration_torch.audio import encode_wav, normalize_audio
    from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                     RestorationServer)
    from ml_audio_restoration_torch.pipeline.server import restore_over_http

    pipe = RestorationPipeline(*_serving_models(), device=card)
    x = _tone(4.0)
    body = encode_wav(x[0][:, None], 22050, subtype="FLOAT")
    with RestorationServer(pipe, request_timeout=120,
                           socket_timeout=60) as srv:
        restore_over_http(srv.host, srv.port, body, subtype="FLOAT",
                          timeout=120)
        torch.cuda.synchronize()
        L.reset_launch_count()
        got, rate = restore_over_http(srv.host, srv.port, body,
                                      subtype="FLOAT", timeout=120)
        assert L.launch_count == 1
    want, _ = pipe.restore(np.asarray(normalize_audio(x)), 22050)
    want = np.asarray(normalize_audio(want.cpu().numpy()), np.float32)
    assert rate == 44100
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_server_copy_is_not_held_by_the_next_program(card):
    """The worker launches request i, queues its copy to pinned host memory
    with an event behind it, and launches request i+1 without waiting for
    the device. A handler waiting on request i's event is released while
    request i+1's program still runs; a copy started on the handler
    thread after the worker moved on would queue behind that program."""
    from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                     RestorationServer)

    pipe = RestorationPipeline(*_serving_models(), device=card)
    x = _tone(60.0)
    srv = RestorationServer(pipe)  # never started: the worker by hand
    try:
        warm = srv._job(x, 22050)  # as a handler makes it: pinned buffers
        srv._run_jobs([warm])  # allocator and cuDNN at this shape
        warm.copied.synchronize()
        first, second = srv._job(x, 22050), srv._job(_tone(60.0, 440.0),
                                                     22050)
        srv._run_jobs([first])
        srv._run_jobs([second])
        launched = torch.cuda.Event()
        launched.record()
        # the worker returned from both without synchronizing: the first
        # program is still running
        assert not first.copied.query()
        first.copied.synchronize()  # the handler's wait
        assert not launched.query()  # the second program has not ended
        assert first.out is first.host_out and first.out.is_pinned()
        second.copied.synchronize()
        want, _ = pipe.restore(x, 22050)
        assert torch.equal(first.out, want.cpu())
    finally:
        srv._httpd.server_close()


# ----------------------------------------------------------- IIR scans
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,size", [("sos", n) for n in (1, 2, 3, 4)]
                         + [("df2t", n) for n in (1, 2, 4, 8)])
def test_iir_scan_kernel_matches_plain(card, kind, size, dtype):
    from scipy import signal as sig

    from ml_audio_restoration_torch.ops import iir

    rows, t = 5, 1001
    rng = np.random.default_rng(size)
    x = torch.from_numpy(rng.normal(size=(rows, t))).to(dtype)
    gy = torch.from_numpy(rng.normal(size=(rows, t))).to(dtype)
    cut = rng.uniform(0.05, 0.6, rows)
    if kind == "sos":
        coef = torch.from_numpy(np.stack([sig.butter(
            2 * size, c, output="sos") for c in cut])).to(dtype)
        zi = torch.from_numpy(rng.normal(size=(rows, size, 2))).to(dtype)
        fwd, adj = iir._sos_forward, iir._sos_adjoint
    else:
        coef = torch.from_numpy(np.stack([np.concatenate(sig.butter(
            size, c)) for c in cut])).to(dtype)
        zi = torch.from_numpy(rng.normal(size=(rows, size))).to(dtype)
        fwd, adj = iir._df2t_forward, iir._df2t_adjoint
    iir.reset_launch_count()
    y = fwd(*(a.to(card) for a in (x, coef, zi)))
    gx, gzi = adj(gy.to(card), coef.to(card))
    assert (iir.launch_count, iir.adjoint_launch_count) == (1, 1)
    assert torch.equal(y.cpu(), fwd(x, coef, zi))
    want_gx, want_gzi = adj(gy, coef)
    assert torch.equal(gx.cpu(), want_gx)
    assert torch.equal(gzi.cpu(), want_gzi)


@pytest.mark.cuda
def test_iir_simulate_batch_on_the_card(card):
    from ml_audio_restoration_torch.data import artifacts as A
    from ml_audio_restoration_torch.ops import iir

    rng = np.random.default_rng(3)
    clean = torch.from_numpy(
        (rng.normal(size=(4, 1, 22050)) * 0.1).astype(np.float32))
    iir.reset_launch_count()
    got = A.simulate_batch(torch.Generator().manual_seed(5), clean.to(card),
                           22050, filter_mode="iir")
    assert iir.launch_count == 6
    want = A.simulate_batch(torch.Generator().manual_seed(5), clean, 22050,
                            filter_mode="iir")
    assert float((got.cpu() - want).abs().max()) <= 1e-5
