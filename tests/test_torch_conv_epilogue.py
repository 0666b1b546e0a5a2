"""The eval convolutions' epilogue (ops/conv.py over csrc/conv_epilogue.cu).

On the CPU: the plain epilogue rounds as ATen's separate ops do (the cuDNN
backend's in-place bias add after the unbiased conv, the residual add,
F.leaky_relu), exactly, in f32 and bf16, with and without a residual, at
T = 1, odd T, T not a multiple of 4 and B = 1; and the routed convs give
exactly today's numbers there (ATen's conv with its bias: on the CPU ATen
folds the bias into the conv's sum, so the CPU never takes the epilogue).
The route takes the epilogue only where no gradient is wanted.

On the card (skipped without one): the kernel bit for bit ATen's ops at
the stereo model's layer shapes, an SR shape and a stream window's; a
restore of a side and a stream feed bit for bit the same under
`aten_epilogue()`; the kernel's launches in one forward of each model
counted from its layer lists (models.epilogue_convs: every conv but the
denoiser's sigmoid head, 17 for the stereo model, held on the CPU against
the convs the eval forward routes); an input transposed from [B, T, C],
whose output cuDNN lays out with C innermost, bit for bit ATen's; one
launch a conv in the trainer's validation step and none in a training
step; and a CUDA tensor the
kernel does not take raising. This file imports nothing of JAX, so it
runs on the card's machine without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_conv_epilogue.py -q
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ml_audio_restoration_torch.config import TrainConfig
from ml_audio_restoration_torch.models import (
    AudioDenoiser, AudioSuperResolution, StereoSeparator, epilogue_convs,
    init_params)
from ml_audio_restoration_torch.ops import conv as C


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tensors(shape, cout, dtype, seed, transposed=False, device="cpu"):
    """x [B, Cin, T], a conv weight for `cout` outputs, its bias."""
    g = torch.Generator().manual_seed(seed)
    b, cin, _ = shape
    x = torch.randn(shape, generator=g)
    w_shape = (cin, cout, 4) if transposed else (cout, cin, 3)
    w = torch.randn(w_shape, generator=g) * 0.3
    bias = torch.randn(cout, generator=g)
    return [a.to(device, dtype) for a in (x, w, bias)]


def _conv(x, w, b, transposed):
    if transposed:
        return F.conv_transpose1d(x, w, b, stride=2, padding=1)
    return F.conv1d(x, w, b, padding=1)


# (B, Cin, T, Cout): T = 1, odd T, T % 4 = 2, B = 1
CPU_SHAPES = [(2, 3, 1, 5), (1, 4, 37, 6), (3, 5, 1002, 8), (1, 1, 2049, 4)]


@pytest.mark.parametrize("shape", CPU_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("lrelu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_epilogue_rounds_as_aten(dtype, lrelu, residual, transposed,
                                       shape):
    bsz, cin, t, cout = shape
    x, w, b = _tensors((bsz, cin, t), cout, dtype, seed=t + cin,
                       transposed=transposed)
    y = _conv(x, w, None, transposed)
    r = torch.randn(y.shape, generator=torch.Generator().manual_seed(7)
                    ).to(dtype) if residual else None
    # ATen's ops as the cuDNN backend runs them: the unbiased conv, its
    # bias added in place, then the residual add and F.leaky_relu
    want = y.clone().add_(b.view(1, -1, 1))
    if residual:
        want = want + r
    if lrelu:
        want = F.leaky_relu(want, 0.2)
    got = C.conv_epilogue(y.clone(), b, r, lrelu=lrelu)
    assert got.dtype == dtype and torch.equal(got, want)
    # and the routed conv on the CPU: today's numbers, the conv with bias
    before = C.epilogue_launch_count
    if transposed:
        routed = C.conv_transpose1d_epilogue(x, w, b, lrelu=lrelu, stride=2,
                                             padding=1)
        today = F.conv_transpose1d(x, w, b, stride=2, padding=1)
    else:
        routed = C.conv1d_epilogue(x, w, b, residual=r, lrelu=lrelu,
                                   padding=1)
        today = F.conv1d(x, w, b, padding=1)
        today = today + r if residual else today
    today = F.leaky_relu(today, 0.2) if lrelu else today
    assert torch.equal(routed, today)
    assert C.epilogue_launch_count == before


@pytest.mark.parametrize("grad_mode,requires,wanted", [
    (False, False, False), (False, True, False), (True, False, False),
    (True, True, True)])
def test_route_takes_the_epilogue_only_without_gradients(
        grad_mode, requires, wanted):
    """A gradient is wanted only in grad mode with an input requiring grad;
    only then, or on a CPU tensor, or inside aten_epilogue(), does the
    route leave the kernel."""
    x, w, b = _tensors((1, 2, 8), 3, torch.float32, seed=0)
    w.requires_grad_(requires)
    with torch.set_grad_enabled(grad_mode):
        assert C._grad_wanted(x, w, b, None) is wanted
        assert C._takes_epilogue(x, w, b, None) is False   # a CPU tensor
    assert not C._force_aten
    with C.aten_epilogue():
        assert C._force_aten
    assert not C._force_aten


def test_eval_models_keep_autograd_under_grad():
    """An eval forward whose input wants a gradient runs ATen's ops and
    back-propagates, as before."""
    model = init_params(AudioSuperResolution(base_channels=8),
                        torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 1, 64, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    model(x).square().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert float(x.grad.abs().max()) > 0


# ----------------------------------------------------------------- card
def _aten(y, b, r, lrelu):
    want = y.clone().add_(b.view(1, -1, 1))
    if r is not None:
        want = want + r
    return F.leaky_relu(want, 0.2) if lrelu else want


# (B, C, T, residual, lrelu): the stereo layers at a 44-row slab (the
# stem's 32 and the dilated blocks' 64 / 128 channels with LeakyReLU, the
# final conv's one channel without), an SR residual block's conv2 (32
# channels at 44,100 with the block's input added), the SR's
# reconstruction (one channel and the interpolated input), and a stream
# window of 16 rows at an odd length
CARD_SHAPES = [(44, 32, 88200, False, True), (44, 64, 88200, False, True),
               (44, 128, 88200, False, True), (44, 1, 88200, False, False),
               (44, 32, 44100, True, False), (44, 1, 88200, True, False),
               (16, 64, 12_561, False, True), (16, 1, 25_122, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,c,t,residual,lrelu", CARD_SHAPES)
def test_kernel_equals_aten(card, dtype, bsz, c, t, residual, lrelu):
    g = torch.Generator(device=card).manual_seed(c + t)
    y = torch.randn((bsz, c, t), device=card, generator=g).to(dtype)
    b = torch.randn(c, device=card, generator=g).to(dtype)
    r = torch.randn((bsz, c, t), device=card, generator=g).to(dtype) \
        if residual else None
    want = _aten(y, b, r, lrelu)
    before = C.epilogue_launch_count
    got = C.conv_epilogue(y, b, r, lrelu=lrelu)
    torch.cuda.synchronize()
    assert C.epilogue_launch_count == before + 1
    assert got.data_ptr() == y.data_ptr() and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 3, 5, 37, 1003, 4097, 8193])
def test_kernel_equals_aten_at_the_edges(card, t):
    """Rows shorter than a vector, rows that start off 16 bytes, spans
    one past a block's vectors, in f32 and bf16, with every epilogue."""
    for dtype in (torch.float32, torch.bfloat16):
        for residual in (False, True):
            for lrelu in (False, True):
                g = torch.Generator(device=card).manual_seed(t)
                y = torch.randn((3, 5, t), device=card, generator=g).to(dtype)
                b = torch.randn(5, device=card, generator=g).to(dtype)
                r = torch.randn_like(y) if residual else None
                want = _aten(y, b, r, lrelu)
                assert torch.equal(C.conv_epilogue(y, b, r, lrelu=lrelu),
                                   want)


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channels_last_input_equals_aten(card, dtype, cin):
    """An input laid out [B, T, C] and transposed, as the trainer's forward
    hands its batch over: cuDNN returns such an input's output with C
    innermost, which the route copies to NCW before the kernel; the values
    are ATen's bit for bit, the residual in that layout too."""
    g = torch.Generator().manual_seed(cin)
    x = torch.randn((3, 1001, cin), generator=g).to(card, dtype)
    w = (torch.randn((32, cin, 7), generator=g) * 0.3).to(card, dtype)
    b = torch.randn(32, generator=g).to(card, dtype)
    r = torch.randn((3, 1001, 32), generator=g).to(card, dtype)
    x, r = x.transpose(1, 2), r.transpose(1, 2)
    with torch.inference_mode():
        before = C.epilogue_launch_count
        got = C.conv1d_epilogue(x, w, b, residual=r, lrelu=True, padding=3)
        assert C.epilogue_launch_count == before + 1
        with C.aten_epilogue():
            want = C.conv1d_epilogue(x, w, b, residual=r, lrelu=True,
                                     padding=3)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_cannot_take(card):
    y = torch.zeros((2, 4, 16), device=card)
    b = torch.zeros(4, device=card)
    with pytest.raises(TypeError):
        C.conv_epilogue(y.double(), b.double())
    with pytest.raises(ValueError):
        C.conv_epilogue(y.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(ValueError):
        C.conv_epilogue(y, torch.zeros(3, device=card))
    with pytest.raises(ValueError):
        C.conv_epilogue(y, b, torch.zeros((2, 4, 15), device=card))
    with pytest.raises(ValueError):   # contiguous, 4 bytes off 16
        C.conv_epilogue(torch.zeros(17, device=card)[1:].view(1, 1, 16),
                        b[:1])


def _models(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [init_params(m, gen) for m in (
        AudioDenoiser(), AudioSuperResolution(), StereoSeparator())]


@pytest.mark.parametrize("index,convs", [(0, 20), (1, 13), (2, 17)])
def test_epilogue_convs_are_the_eval_forward_convs(monkeypatch, index,
                                                    convs):
    """models.epilogue_convs reads off the module tree what the eval
    forward routes: on the CPU every routed conv passes the ATen form once
    with its output channels and LeakyReLU, and the counts are the layer
    lists' (denoiser 20: all but the sigmoid head; SR 13; stereo 9 encoder
    + 8 decoder convs)."""
    from collections import Counter

    model = _models()[index].eval()
    seen = []
    aten = C._aten_epilogue

    def record(y, residual, lrelu):
        seen.append((y.shape[1], lrelu))
        return aten(y, residual, lrelu)

    monkeypatch.setattr(C, "_aten_epilogue", record)
    with torch.inference_mode():
        model(torch.randn((1, 1, 2048), generator=torch.Generator()
                          .manual_seed(index)))
    assert len(epilogue_convs(model)) == convs
    assert Counter(seen) == Counter(epilogue_convs(model))


@pytest.mark.cuda
def test_launches_per_forward(card):
    dn, sr, st = (m.to(card).eval() for m in _models())
    x = torch.randn((2, 1, 8000), device=card)
    for model in (dn, sr, st):
        C.reset_epilogue_launch_count()
        with torch.inference_mode():
            model(x)
        assert C.epilogue_launch_count == len(epilogue_convs(model)), model
        C.reset_epilogue_launch_count()
        with torch.inference_mode(), C.aten_epilogue():
            model(x)
        assert C.epilogue_launch_count == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_of_a_side_equals_aten(card, dtype):
    """A 155 s side, the restore cell's shortest, through the default
    restore (slabs of 2 s chunks), bit for bit ATen's epilogue, with one
    launch a conv of each stage a program (one K1 walk a program)."""
    from ml_audio_restoration_torch.config import PipelineConfig
    from ml_audio_restoration_torch.ops import lstm as L
    from ml_audio_restoration_torch.pipeline import RestorationPipeline

    models = _models()
    pipe = RestorationPipeline(*models, PipelineConfig(compute_dtype=dtype),
                               device=card)
    rng = np.random.default_rng(3)
    side = (0.1 * rng.standard_normal((1, 155 * 22050))).astype(np.float32)
    C.reset_epilogue_launch_count()
    L.reset_launch_count()
    got, rate = pipe.restore(side, 22050)
    launched, programs = C.epilogue_launch_count, L.launch_count
    with C.aten_epilogue():
        want, _ = pipe.restore(side, 22050)
    assert programs >= 2 and launched == programs * sum(
        len(epilogue_convs(m)) for m in models)
    assert rate == 44100 and torch.equal(got, want)


@pytest.mark.cuda
def test_stream_feed_equals_aten(card):
    from ml_audio_restoration_torch.pipeline import StreamingRestorer

    models = _models(seed=3)
    rng = np.random.default_rng(4)
    blocks = (rng.normal(size=(2, 4, 11025)) * 0.1).astype(np.float32)
    outs = []
    for aten in (False, True):
        s = StreamingRestorer(*models, batch=4, device=card)
        with C.aten_epilogue() if aten else contextlib.nullcontext():
            s.feed(blocks[0])
            before = C.epilogue_launch_count
            outs.append(s.feed(blocks[1]))
            launched = C.epilogue_launch_count - before
        assert (launched == 0) if aten else (launched > 0)
    np.testing.assert_array_equal(outs[0], outs[1])


def _trainer(card, name, pairing, key):
    """A trainer of `name` on the card and a batch of 2 x 4,096 samples."""
    from ml_audio_restoration_torch.train.trainer import Trainer

    cls = {"stereo_separator": StereoSeparator, "denoiser": AudioDenoiser,
           "super_resolution": AudioSuperResolution}[name]
    rng = np.random.default_rng(2)
    shape = (2, 2, 4096) if key == "stereo" else (2, 1, 4096)
    batch = {key: (0.1 * rng.standard_normal(shape)).astype(np.float32)}
    tr = Trainer(name, init_params(cls(), torch.Generator().manual_seed(0)),
                 [], pairing=pairing,
                 config=TrainConfig(model=name, spectral_weight=0.0),
                 device=card)
    return tr, batch


TRAINERS = [("stereo_separator", "mono_target_stereo", "stereo"),
            ("denoiser", "degrade", "clean"),
            ("super_resolution", "downsample", "high")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,pairing,key", TRAINERS)
def test_validation_step_takes_the_kernel(card, name, pairing, key):
    """The trainer's validation forward runs with no gradient on the
    trainer's transposed [B, T, C] batch: one launch a routed conv."""
    tr, batch = _trainer(card, name, pairing, key)
    C.reset_epilogue_launch_count()
    loss = float(tr._eval_step(batch)["loss"])
    assert np.isfinite(loss)
    assert C.epilogue_launch_count == len(epilogue_convs(tr.model))


@pytest.mark.cuda
@pytest.mark.parametrize("name,pairing,key", TRAINERS)
def test_no_launch_in_a_training_step(card, name, pairing, key):
    tr, batch = _trainer(card, name, pairing, key)
    C.reset_epilogue_launch_count()
    loss = float(tr._train_step(batch)["loss"])
    assert np.isfinite(loss) and C.epilogue_launch_count == 0
