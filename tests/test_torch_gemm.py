"""BS-RoFormer's linears on the TF32x3 GEMM (ops/gemm.py over
csrc/tf32x3_gemm.cu).

On the CPU: the model's forward is bit for bit what the modules computed
before the route (F.linear a layer, nn.GELU, the residual adds after the
blocks) in float32 and bf16 and under grad; the route takes the kernel
only for a CUDA tensor with no gradient wanted; the TF32 split's algebra
(hi has TF32's 10 fraction bits, rounded to nearest with ties away, and
hi + lo is x within 2^-21); the plain three-product version within 4x a
one-pass float32 product's error against float64, where the one-product
form fails that bound; the weights' parts made again after
`load_state_dict` and not carried by a copy.

On the card (skipped without one): the kernel within 8x of float32
`torch.matmul`'s error (TF32 off) against float64 at the enhance cell's
four (K, N) shapes with ragged M, over 3 seeds, where one-pass TF32
fails that line; each epilogue form against ATen's route; a whole
enhancer forward against ATen's route, both against float64; 4 launches
a transformer (96 a forward at the ep_317 widths); bf16 and grad on
ATen; and what the kernel does not take raising. This file imports
nothing of JAX, so it runs on the card's machine without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gemm.py -q
"""
import contextlib
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ml_audio_restoration_torch.models import BSRoformer
from ml_audio_restoration_torch.models import bs_roformer as BR
from ml_audio_restoration_torch.ops import gemm as G

# the enhance cell's (K, N): to_qkv with to_gates, to_out, the
# feed-forward's two linears
CELL_SHAPES = [(512, 1544), (512, 512), (512, 2048), (2048, 512)]
# a small model: dims multiples of 4, as the kernel's K must be
WIDTHS = dict(stereo=True, dim_head=16, heads=2,
              freqs_per_bands=(2, 2, 2, 4, 4, 4, 7, 8), stft_n_fft=64,
              stft_hop_length=10, stft_win_length=64, stft_normalized=False)
EP_317 = dict(depth=12, stereo=True, num_stems=1, time_transformer_depth=1,
              freq_transformer_depth=1, dim_head=64, heads=8,
              freqs_per_bands=(2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8
              + (48,) * 8 + (128, 129), mask_estimator_depth=2,
              stft_n_fft=2048, stft_hop_length=441, stft_win_length=2048,
              stft_normalized=False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@contextlib.contextmanager
def full_f32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _seed(model, seed=0):
    """Linear weights and biases U(+-1/sqrt(fan_in)), RMSNorm gammas
    U(0.5, 1.5) (the benchmark's seeding)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                bound = m.in_features ** -0.5
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1)
                                * bound)
            elif isinstance(getattr(m, "gamma", None), nn.Parameter):
                m.gamma.copy_(torch.rand(m.gamma.shape, generator=gen) + 0.5)
    return model.eval()


def _model(seed=0, dim=32, depth=2, **kw):
    return _seed(BSRoformer(dim, depth=depth, time_transformer_depth=1,
                            freq_transformer_depth=1, **dict(WIDTHS, **kw)),
                 seed)


# --------------------------------------- the forward before the route
def _attention_before(self, x):
    b, n, _ = x.shape
    h, d = self.heads, self.dim_head
    x = self.norm(x)
    qkv = self.to_qkv(x).view(b, n, 3, h, d)
    table = self.rotary_embed.table(n)[:, None, None]
    q, k = BR.rope(qkv[:, :, :2], table).unbind(2)
    out = BR.attention(q.transpose(1, 2), k.transpose(1, 2),
                       qkv[:, :, 2].transpose(1, 2))
    gates = torch.sigmoid(self.to_gates(x))
    out = out.transpose(1, 2) * gates[..., None]
    return self.to_out(out.reshape(b, n, h * d))


def _transformer_before(self, x):
    for attn, ff in self.layers:
        x = _attention_before(attn, x) + x
        x = ff.net(x) + x
    return x


@pytest.mark.parametrize("dtype,grad", [
    (torch.float32, False), (torch.bfloat16, False), (torch.float32, True)],
    ids=["f32", "bf16", "f32_grad"])
def test_cpu_forward_is_the_forward_before_the_route(monkeypatch, dtype,
                                                     grad):
    model = _model().to(dtype)
    x = torch.randn(2, 2, 397, generator=torch.Generator().manual_seed(1))
    x = x.to(dtype).requires_grad_(grad)
    before = G.gemm_launch_count
    with torch.set_grad_enabled(grad):
        got = model(x)
        with monkeypatch.context() as m:
            m.setattr(BR.Transformer, "forward", _transformer_before)
            want = model(x)
    assert G.gemm_launch_count == before
    assert torch.equal(got, want)
    if grad:
        got.square().sum().backward()
        assert x.grad is not None and float(x.grad.abs().max()) > 0


@pytest.mark.parametrize("grad_mode,requires,wanted", [
    (False, False, False), (False, True, False), (True, False, False),
    (True, True, True)])
def test_route_takes_the_kernel_only_on_the_card_without_gradients(
        grad_mode, requires, wanted):
    """A gradient is wanted only in grad mode with a tensor requiring grad;
    a CPU tensor never takes the kernel, and aten_linear() holds the route
    on ATen's ops."""
    layer = nn.Linear(8, 4)
    layer.weight.requires_grad_(requires)
    x = torch.randn(3, 8)
    with torch.set_grad_enabled(grad_mode):
        assert G._grad_wanted([x, None, layer.weight]) is wanted
        assert G._takes_kernel(x, (layer,), None) is False
    assert not G._force_aten
    with G.aten_linear():
        assert G._force_aten
    assert not G._force_aten


def test_linear_on_the_cpu_is_atens():
    gen = torch.Generator().manual_seed(0)
    a, b, c = nn.Linear(12, 8), nn.Linear(12, 4, bias=False), nn.Linear(8, 12)
    x = torch.randn(5, 3, 12, generator=gen)
    r = torch.randn(5, 3, 12, generator=gen)
    with torch.no_grad():
        ya, yb = G.linear(x, a, b)
        assert torch.equal(ya, a(x)) and torch.equal(yb, b(x))
        assert torch.equal(G.linear(ya, c, gelu=True), F.gelu(c(ya)))
        assert torch.equal(G.linear(ya, c, residual=r), c(ya) + r)
    with pytest.raises(ValueError, match="one layer"):
        G.linear(x, a, b, gelu=True)


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """Round float32 to 10 fraction bits, to nearest, ties away from zero,
    through float64 arithmetic on the significand."""
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    q = np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5) / 2 ** 11
    return np.ldexp(q, e).astype(np.float32)


def test_tf32_split_algebra():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000)
         * 10.0 ** rng.uniform(-30, 30, 100_000)).astype(np.float32)
    # ties: exactly half a TF32 unit above a TF32 value, either sign
    ties = (np.arange(1, 1001, dtype=np.uint32) << 13) | 0x3F800000 | 0x1000
    x = np.concatenate([x, ties.view(np.float32), -ties.view(np.float32),
                        [0.0, -0.0, 1.0, -2.5]]).astype(np.float32)
    hi, lo = G.tf32_split(torch.from_numpy(x))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy(), _tf32_rna(x))
    # ties round away from zero
    n = len(ties)
    assert (np.abs(hi.numpy()[-4 - 2 * n:-4]) > np.abs(x[-4 - 2 * n:-4])).all()
    err = np.abs((hi.double() + lo.double()).numpy() - x.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x)).all()


def _errors(x, w, y):
    """max |y - x w^T| against float64."""
    return float((y.double() - x.double() @ w.double().T).abs().max())


@pytest.mark.parametrize("k,n", CELL_SHAPES)
def test_plain_three_products_hold_float32_error(k, n):
    """The plain version's error against float64 within 4x a one-pass
    float32 product's; one TF32 product (x_hi w_hi) fails that bound."""
    gen = torch.Generator().manual_seed(k + n)
    x = torch.randn(96, k, generator=gen)
    if k == 2048:  # the second linear reads GELU's output
        x = F.gelu(x)
    w = (torch.rand(n, k, generator=gen) * 2 - 1) * k ** -0.5
    w_hi, w_lo = G.tf32_split(w)
    one_pass = _errors(x, w, x @ w.T)
    assert _errors(x, w, G.gemm_plain(x, w_hi, w_lo)) <= 4 * one_pass
    planted = G.tf32_round(x) @ w_hi.T
    assert _errors(x, w, planted) > 4 * one_pass


def test_gemm_on_the_cpu_is_the_plain_version():
    gen = torch.Generator().manual_seed(3)
    x, w = torch.randn(7, 16, generator=gen), torch.randn(6, 16, generator=gen)
    b, r = torch.randn(6, generator=gen), torch.randn(7, 6, generator=gen)
    w_hi, w_lo = G.tf32_split(w)
    assert torch.equal(G.gemm(x, w_hi, w_lo, b, r, gelu=True),
                       G.gemm_plain(x, w_hi, w_lo, b, r, gelu=True))


def test_split_weights_made_again_after_load_state_dict():
    attn = _model().layers[0][0].layers[0][0]
    layers = (attn.to_qkv, attn.to_gates)
    parts = G.split_weights(layers)
    assert G.split_weights(layers) is parts  # kept
    w = torch.cat([attn.to_qkv.weight, attn.to_gates.weight])
    assert torch.equal(parts[0][:98], G.tf32_split(w)[0])
    assert torch.equal(parts[1][:98], G.tf32_split(w)[1])
    assert torch.equal(parts[2][:attn.to_qkv.out_features],
                       torch.zeros(attn.to_qkv.out_features))
    assert torch.equal(parts[2][attn.to_qkv.out_features:][:2],
                       attn.to_gates.bias)
    # 96 + 2 rows padded to 100: each output row starts on 16 bytes
    assert parts[0].shape == (100, 32) and not parts[0][98:].any()
    assert not parts[1][98:].any() and not parts[2][98:].any()
    state = _model(seed=5).layers[0][0].layers[0][0].state_dict()
    attn.load_state_dict(state)
    again = G.split_weights(layers)
    assert again is not parts
    w = torch.cat([state["to_qkv.weight"], state["to_gates.weight"]])
    want_hi, want_lo = G.tf32_split(w)
    assert torch.equal(again[0][:98], want_hi)
    assert torch.equal(again[1][:98], want_lo)
    assert torch.equal(again[2][attn.to_qkv.out_features:][:2],
                       state["to_gates.bias"])
    # an in-place change of one weight, and a copy of the module
    with torch.no_grad():
        attn.to_gates.weight.mul_(2)
    assert G.split_weights(layers) is not again
    assert getattr(copy.deepcopy(attn.to_qkv), "_tf32x3_split") is None


# ----------------------------------------------------------------- card
def _operands(k, n, m, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device)
    if k == 2048:
        x = F.gelu(x)
    w = (torch.rand((n, k), generator=gen, device=device) * 2 - 1) * k ** -0.5
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,n", CELL_SHAPES)
def test_kernel_holds_float32_error(card, k, n, seed):
    """Max error against float64 within 8x float32 torch.matmul's (TF32
    off), M ragged; one-pass TF32 lies far above that line."""
    x, w = _operands(k, n, 4_999, seed, card)
    w_hi, w_lo = G.tf32_split(w)
    with full_f32():
        library = _errors(x, w, x @ w.T)
        got = _errors(x, w, G.gemm(x, w_hi, w_lo))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = _errors(x, w, x @ w.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert got <= 8 * library, (got, library)
    assert tf32 > 8 * library, (tf32, library)


def _against_f64(got, want, want64):
    """(kernel's, ATen's) max error against the float64 result."""
    return (float((got.double() - want64).abs().max()),
            float((want.double() - want64).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["qkv_gates", "residual", "gelu",
                                  "bias_residual"])
def test_epilogue_forms_against_aten(card, form):
    """Each form the model uses, the kernel's route against ATen's on the
    same card, both against float64: within 8x ATen's error."""
    gen = torch.Generator().manual_seed(11)
    m = 3 * 1777  # ragged
    if form == "qkv_gates":
        layers = (nn.Linear(512, 1536, bias=False), nn.Linear(512, 8))
    elif form == "bias_residual":
        layers = (nn.Linear(2048, 512),)
    else:
        layers = (nn.Linear(512, 512 if form == "residual" else 2048,
                            bias=form == "gelu"),)
    layers = tuple(_seed(layer, 3).to(card) for layer in layers)
    k = layers[0].in_features
    x = torch.randn((3, m // 3, k), generator=gen).to(card)
    kw = {}
    if form == "gelu":
        kw["gelu"] = True
    elif form != "qkv_gates":
        kw["residual"] = torch.randn((3, m // 3, 512), generator=gen).to(card)
    with torch.no_grad(), full_f32():
        before = G.gemm_launch_count
        got = G.linear(x, *layers, **kw)
        assert G.gemm_launch_count == before + 1
        with G.aten_linear():
            want = G.linear(x, *layers, **kw)
        assert G.gemm_launch_count == before + 1
        double = [copy.deepcopy(layer).double() for layer in layers]
        want64 = G.linear(x.double(), *double, **{
            key: v.double() if torch.is_tensor(v) else v
            for key, v in kw.items()})
    if form != "qkv_gates":
        got, want, want64 = (got,), (want,), (want64,)
    for a, b, c in zip(got, want, want64):
        assert a.shape == b.shape
        err, aten = _against_f64(a, b, c)
        assert err <= 8 * aten + 1e-7, (err, aten)


@pytest.mark.cuda
def test_enhancer_forward_against_aten(card):
    """A whole forward at dim 128 on the kernel's route against ATen's,
    both against the float64 forward: within 4x ATen's error."""
    model = _model(dim=128).to(card)
    x = torch.randn((2, 2, 4000), generator=torch.Generator().manual_seed(2)
                    ).to(card)
    with torch.no_grad(), full_f32():
        G.reset_gemm_launch_count()
        got = model(x)
        launches = G.gemm_launch_count
        with G.aten_linear():
            want = model(x)
        # float64 on the CPU: the card's fused attention takes no float64
        want64 = copy.deepcopy(model).double().cpu()(x.double().cpu())
    assert launches == 4 * 4  # 4 transformers
    want64 = want64.to(card)
    peak = float(want64.abs().max())
    err, aten = _against_f64(got, want, want64)
    assert err <= 4 * aten + 1e-7 * peak, (err, aten, peak)


@pytest.mark.cuda
def test_launches_per_ep_317_forward(card):
    """4 launches a transformer: 96 a forward of the ep_317 widths."""
    model = _seed(BSRoformer(512, **EP_317)).to(card)
    x = torch.randn((1, 2, 22_050), device=card)
    with torch.inference_mode(), full_f32():
        G.reset_gemm_launch_count()
        model(x)
    assert G.gemm_launch_count == 96


@pytest.mark.cuda
def test_bf16_and_grad_take_aten(card):
    model = _model().to(card)
    x = torch.randn((1, 2, 2000), device=card)
    before = G.gemm_launch_count
    with torch.no_grad():
        copy.deepcopy(model).bfloat16()(x.bfloat16())
    model(x.requires_grad_(True)).sum().backward()
    assert G.gemm_launch_count == before


@pytest.mark.cuda
def test_kernel_raises_on_what_it_cannot_take(card):
    x, w = _operands(512, 64, 100, 0, card)
    w_hi, w_lo = G.tf32_split(w)
    with pytest.raises(TypeError):
        G.gemm(x.double(), w_hi, w_lo)
    with pytest.raises(ValueError, match="multiples of 4"):
        G.gemm(x[:, :510].contiguous(), w_hi[:, :510].contiguous(),
               w_lo[:, :510].contiguous())
    with pytest.raises(ValueError, match="multiples of 4"):
        G.gemm(x, w_hi[:62].contiguous(), w_lo[:62].contiguous())
    with pytest.raises(ValueError, match="residual"):
        G.gemm(x, w_hi, w_lo, residual=torch.zeros((100, 63), device=card))
