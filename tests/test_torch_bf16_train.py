"""bf16 AMP training of the port against the JAX package's.

`TrainConfig.compute_dtype="bfloat16"`: each forward runs on bf16 casts of
the f32 parameters and a bf16 input, the BN running statistics stay f32,
the output is cast to f32 before the loss, and parameters, Adam state and
EMA stay f32. The JAX reference is its TPU route: the stereo step through
`lstm_impl="pallas_train"` (the fused Pallas forward and backward) and
validation through `"pallas"`, both in interpret mode (the `pallas`
fixture patches the wrappers; nothing in the JAX package changes). On the
CPU the JAX Trainer would take the scan, whose bf16 state is bf16.

Bars:
- the LSTM's bf16 gradient contract, pinned from `jax.grad` through
  JAX's `lstm`: dx, dW_ih and dW_hh are bf16 values (dgx is rounded to
  bf16 before the projection's products, which sum in f32 and round once;
  dW_hh is K3's f32 sum rounded), held to one bf16 step (2**-8) of the
  largest entry (read: equal, and 9e-9 for dx); the bias gradients are
  f32 sums of the unrounded dgx, held to 1e-5 of the largest entry (read
  2.6e-7, f32 summation order). The route before this contract (the
  engine rounding dgx to bf16 at the recurrence, the bias fused into the
  bf16 projection) reads 4.4e-3 on the biases and 5.1e-3 on dW_ih;
- a bf16 step and a bf16 validation of each family: the loss and the
  gradients (relative L2) within twice JAX's own bf16-vs-f32 deviation on
  the same inputs (two bf16 roundings of one f32 function, each within D
  of it, lie within 2D of each other; the bar of the bf16 serving tests).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_audio_restoration_tpu.ops.pallas.lstm as pallas_lstm
from ml_audio_restoration_tpu.config import TrainConfig as JTrainConfig
from ml_audio_restoration_tpu.data.loader import DataLoader as JDataLoader
from ml_audio_restoration_tpu.losses import \
    restoration_loss as jrestoration_loss
from ml_audio_restoration_tpu.train.trainer import Trainer as JTrainer
from ml_audio_restoration_torch.compat import state_dict_from_jax
from ml_audio_restoration_torch.config import TrainConfig
from ml_audio_restoration_torch.data import DataLoader
from ml_audio_restoration_torch.models import cast_params
from ml_audio_restoration_torch.ops import lstm as L
from ml_audio_restoration_torch.train.trainer import Trainer
from test_torch_models import jax_model, port_model
from test_torch_pipeline import SMALL

jax_lstm = importlib.import_module("ml_audio_restoration_tpu.ops.lstm").lstm

BF16_STEP = 2.0 ** -8   # one bf16 step, relative to the largest entry
BIAS_BAR = 1e-5         # f32 sums in another order
B, T = 2, 2048
GAIN = 4.0              # RMS ~0.35 (test_torch_convnet_train.py's GAIN)
# family -> (pairing, batch key, time steps of that key)
FAMILIES = {"stereo_separator": ("mono_target_stereo", "stereo", T),
            "denoiser": ("identity", "clean", T),
            "super_resolution": ("downsample", "high", T)}


@pytest.fixture
def pallas(monkeypatch):
    """JAX's TPU recurrences on the CPU: every Pallas wrapper in interpret
    mode (ops/lstm.py imports them at call time)."""
    for name in ("lstm_recurrence_pallas", "lstm_recurrence_pallas_train",
                 "lstm_recurrence_pallas_bwd"):
        monkeypatch.setattr(pallas_lstm, name, functools.partial(
            getattr(pallas_lstm, name), interpret=True))


# ------------------------------------------------ the gradient contract
def _lstm_case(h, seed=0, b=3, t=40, c=12):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, c)) * 0.8).astype(np.float32)
    params = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
              for k, s in (("w_ih", (c, 4 * h)), ("w_hh", (h, 4 * h)),
                           ("b_ih", (4 * h,)), ("b_hh", (4 * h,)))}
    dy = rng.standard_normal((b, t, h)).astype(np.float32)
    return x, params, dy


def _jax_lstm_grads(x, params, dy):
    """JAX's gradients of <lstm(x_bf16, params_bf16), dy> for the f32
    params and x, through impl='pallas_train'."""
    def f(p, xx):
        pc = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
        y = jax_lstm(xx.astype(jnp.bfloat16), pc, impl="pallas_train")
        return jnp.sum(y.astype(jnp.float32) * dy)

    gp, gx = jax.grad(f, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)}


def _port_lstm_grads(x, params, dy, route):
    """The port's gradients for f32 params and a bf16 leaf x. `route`:
    'fixed' is ops.lstm.lstm; 'parent' is the route before the contract,
    the bias fused into a bf16 projection of bf16 copies and the engine
    rounding dgx to bf16 at LSTMRecurrenceTrain."""
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x).bfloat16().requires_grad_()
    if route == "fixed":
        y = L.lstm(tx, tp)
    else:
        pc = {k: v.bfloat16() for k, v in tp.items()}
        b, t, c = tx.shape
        gates = torch.addmm(pc["b_ih"] + pc["b_hh"],
                            tx.transpose(0, 1).reshape(t * b, c),
                            pc["w_ih"]).view(t, b, -1)
        h0 = torch.zeros(b, pc["w_hh"].shape[0])
        out, _, _ = L.LSTMRecurrenceTrain.apply(gates, pc["w_hh"], h0, h0)
        y = out.transpose(0, 1).bfloat16()
    (y.float() * torch.from_numpy(dy)).sum().backward()
    return {**{k: v.grad for k, v in tp.items()}, "x": tx.grad}


def _rel_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("h", [16, 32])
def test_bf16_lstm_gradients_match_jax(pallas, h):
    """dx in bf16 (x's dtype), dW_ih and dW_hh bf16 values handed to the
    f32 weights, the bias gradients unrounded f32 sums; each against
    JAX's."""
    x, params, dy = _lstm_case(h)
    want = _jax_lstm_grads(x, params, dy)
    got = _port_lstm_grads(x, params, dy, "fixed")
    assert got["x"].dtype == torch.bfloat16
    for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        assert got[name].dtype == torch.float32, name
    for name in ("w_ih", "w_hh"):
        g = got[name]
        assert torch.equal(g, g.bfloat16().float()), f"{name} not rounded"
    for name in ("b_ih", "b_hh"):
        g = got[name]
        assert not torch.equal(g, g.bfloat16().float()), f"{name} rounded"
    for name in ("x", "w_ih", "w_hh"):
        assert _rel_max(got[name].float().numpy(), want[name]) <= \
            BF16_STEP, name
    for name in ("b_ih", "b_hh"):
        assert _rel_max(got[name].numpy(), want[name]) <= BIAS_BAR, name


def test_parent_bf16_route_is_further_from_jax(pallas):
    """The route this contract replaced fails the bars where the fixed
    one holds them."""
    x, params, dy = _lstm_case(16, seed=3)
    want = _jax_lstm_grads(x, params, dy)
    fixed = _port_lstm_grads(x, params, dy, "fixed")
    parent = _port_lstm_grads(x, params, dy, "parent")
    for name in ("b_ih", "b_hh"):
        f = _rel_max(fixed[name].numpy(), want[name])
        p = _rel_max(parent[name].numpy(), want[name])
        assert f <= BIAS_BAR < p and 100 * f < p, (name, f, p)
    f = _rel_max(fixed["w_ih"].numpy(), want["w_ih"])
    p = _rel_max(parent["w_ih"].numpy(), want["w_ih"])
    assert f < p and p > BF16_STEP, (f, p)


def test_f32_lstm_route_is_unchanged():
    """In f32, `lstm` under grad (LSTMTrain, which owns the projection)
    gives the output and gradients of the route before the bf16 contract,
    the fused-bias projection and LSTMRecurrenceTrain, bit for bit."""
    x, params, dy = _lstm_case(16, seed=4)

    def grads(route):
        tp = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        tx = torch.tensor(x, requires_grad=True)
        if route == "lstm":
            y = L.lstm(tx, tp)
        else:
            b, t, c = tx.shape
            gates = torch.addmm(tp["b_ih"] + tp["b_hh"],
                                tx.transpose(0, 1).reshape(t * b, c),
                                tp["w_ih"]).view(t, b, -1)
            h0 = torch.zeros(b, 16)
            out, _, _ = L.LSTMRecurrenceTrain.apply(gates, tp["w_hh"], h0,
                                                    h0)
            y = out.transpose(0, 1)
        (y * torch.from_numpy(dy)).sum().backward()
        return [y.detach(), tx.grad] + [tp[k].grad for k in params]

    for a, b in zip(grads("lstm"), grads("composition")):
        assert torch.equal(a, b)


def test_cast_params_leaves_buffers_and_lstm_weights():
    _, (params, state) = jax_model("stereo_separator", 0,
                                   np.random.default_rng(0),
                                   **SMALL["stereo_separator"])
    model = port_model("stereo_separator", params, state)
    cast = cast_params(model, torch.bfloat16)
    names = {n for n, _ in model.named_parameters()}
    assert set(cast) == names  # no buffers
    for n, v in cast.items():
        want = torch.float32 if n.startswith("lstm.") else torch.bfloat16
        assert v.dtype == want, n
    # the casts are differentiable: gradients reach the f32 parameters
    sum(v.float().sum() for v in cast.values()).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())


# --------------------------------------------------------- train steps
def _batch(name, seed=0):
    rng = np.random.default_rng(seed)
    pairing, key, t = FAMILIES[name]
    c = 2 if key == "stereo" else 1
    n = np.arange(t) / 22050
    x = np.stack([[0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * n)
                   + 0.05 * rng.standard_normal(t) for _ in range(c)]
                  for _ in range(B)]) * GAIN
    return {key: x.astype(np.float32)}


class _Toy:
    def __init__(self, name):
        self.name = name
        self.pairing = FAMILIES[name][0]

    def __len__(self):
        return B

    def __getitem__(self, i):
        key = FAMILIES[self.name][1]
        return {key: _batch(self.name)[key][i]}


def _weights(name, seed=0):
    return jax_model(name, seed, np.random.default_rng(seed),
                     **SMALL[name])[1]


def _cfg(cls, name, dtype, **kw):
    return cls(model=name, learning_rate=1e-3, compute_dtype=dtype, **kw)


def _jax_trainer(name, params, state, dtype, **kw):
    """JAX's Trainer at `dtype` on its TPU route (lstm_impl 'pallas': the
    fused train kernels under grad)."""
    loader = JDataLoader(_Toy(name), batch_size=B, num_workers=1, seed=0)
    jtr = JTrainer(name, params, state, loader, None,
                   config=_cfg(JTrainConfig, name, dtype, lstm_impl="pallas",
                               **kw),
                   pairing=FAMILIES[name][0])
    if name == "stereo_separator":
        assert jtr._apply_kwargs == {"lstm_impl": "pallas_train"}
    return jtr


def _jax_inputs(jtr, name, seed=0):
    batch = {k: jnp.asarray(v) for k, v in _batch(name, seed).items()}
    return (batch, *jtr._derive(batch, jax.random.PRNGKey(0)))


def _trainer(name, params, state, dtype="bfloat16", **kw):
    loader = DataLoader(_Toy(name), batch_size=B, seed=0)
    return Trainer(name, port_model(name, params, state), loader, loader,
                   config=_cfg(TrainConfig, name, dtype, **kw),
                   device="cpu")


def _flat(sd, names):
    return np.concatenate([np.asarray(sd[n], np.float64).ravel()
                           for n in names])


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / np.linalg.norm(b))


# the smooth loss terms (test_torch_train.py's SMOOTH): the log-magnitude
# spectral and clustering terms weigh each STFT bin by 1/(|S| + 1e-5), and
# in bf16 their gradient is rounding noise (JAX's own bf16 gradient of the
# reference loss is 1.2-1.3 relative L2 from its f32 one)
SMOOTH = {"stereo_separator": {"spectral_weight": 0.0,
                               "clustering_weight": 0.0},
          "denoiser": {"spectral_weight": 0.0},
          "super_resolution": {"spectral_weight": 0.0}}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_bf16_step_gradients_match_jax(pallas, name):
    """One bf16 step's gradients (the smooth terms) within twice JAX's own
    bf16-vs-f32 deviation (relative L2 over all parameters); the update
    leaves parameters, Adam state, EMA and BN statistics in f32."""
    params, state = _weights(name)
    want = {}
    for dtype in ("bfloat16", "float32"):
        jtr = _jax_trainer(name, params, state, dtype, **SMOOTH[name])
        batch, inputs, targets = _jax_inputs(jtr, name)
        _, grads = jax.value_and_grad(jtr._loss, has_aux=True)(
            params, state, inputs, targets, batch, jax.random.PRNGKey(1),
            True)
        want[dtype] = state_dict_from_jax(name, grads, state)
    tr = _trainer(name, params, state, ema_decay=0.9, **SMOOTH[name])
    inputs, targets = tr._derive(_batch(name))
    tr.model.train()
    loss, _ = tr._loss(inputs, targets)
    loss.backward()
    names = [n for n, _ in tr.model.named_parameters()]
    got = _flat({n: p.grad.numpy() for n, p in tr.model.named_parameters()},
                names)
    j16, j32 = _flat(want["bfloat16"], names), _flat(want["float32"], names)
    assert _rel_l2(got, j16) <= 2 * _rel_l2(j16, j32)

    tr._update()
    for p in tr.model.parameters():
        assert p.dtype == torch.float32
    for st in tr.optimizer.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in tr.ema_params.values())
    assert all(b.dtype == torch.float32 for b in tr.model.buffers()
               if b.is_floating_point())


def _jax_forward_loss(name, params, state, dtype, seed, train):
    """JAX's forward and loss at `dtype` on the TPU route: the train
    forward through pallas_train, the validation forward through 'pallas'
    (params cast, model_state f32)."""
    jtr = _jax_trainer(name, params, state, dtype, **SMOOTH[name])
    _, inputs, targets = _jax_inputs(jtr, name, seed)
    dt = jnp.dtype(dtype)
    kw = ({"lstm_impl": "pallas_train" if train else "pallas"}
          if name == "stereo_separator" else {})
    out, _ = jtr.module.apply(
        jax.tree_util.tree_map(lambda x: x.astype(dt), params), state,
        inputs.astype(dt), train=train, **kw)
    out = out.astype(jnp.float32)
    c = jtr.cfg
    total, _ = jrestoration_loss(
        out, targets, time_weight=c.time_weight,
        si_sdr_weight=c.si_sdr_weight, spectral_weight=c.spectral_weight,
        impulse_weight=c.impulse_weight,
        clustering_weight=c.clustering_weight,
        consistency_weight=c.consistency_weight)
    return np.asarray(out), float(total)


@pytest.mark.parametrize("train", [True, False], ids=["step", "validation"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_bf16_forward_and_loss_match_jax(pallas, monkeypatch, name, train):
    """The bf16 train forward (a step) and eval forward (validation, on the
    f32 BN statistics folded into the cast weights; K1 on bf16 gates for
    the stereo net) over three weight draws: each output within twice
    JAX's own bf16-vs-f32 deviation (relative L2), and the loss of the
    smooth terms on average too (one scalar can sit near JAX's f32 loss by
    chance). The log-magnitude spectral term is left out as in the
    gradient test: a bf16 output's rounding lifts the smallest STFT bins,
    and the port, which rounds after every elementwise op where XLA's
    CPU fusions keep f32 between them, moves that term further (the
    denoiser's: up to 2.6e-3 from f32, JAX's 1.6e-3, on outputs 0.033 and
    0.034 from f32)."""
    calls = []
    real = L.lstm_recurrence_plain
    monkeypatch.setattr(L, "lstm_recurrence_plain",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    port_dev, jax_dev = [], []
    for seed in range(3):
        params, state = _weights(name, seed)
        out16, loss16 = _jax_forward_loss(name, params, state, "bfloat16",
                                          seed, train)
        out32, loss32 = _jax_forward_loss(name, params, state, "float32",
                                          seed, train)
        tr = _trainer(name, params, state, **SMOOTH[name])
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        inputs, targets = tr._derive(_batch(name, seed))
        tr.model.train(train)
        # a step's forward under grad (K2's route), validation's without
        with torch.enable_grad() if train else torch.no_grad():
            loss, (_, out) = tr._loss(
                inputs, targets, None if train else tr.eval_state())
        out = out.detach()
        assert out.dtype == torch.float32
        assert _rel_l2(out.numpy(), out16) <= 2 * _rel_l2(out16, out32)
        port_dev.append(abs(float(loss) - loss16))
        jax_dev.append(abs(loss16 - loss32))
        after = tr.model.state_dict()
        for k, v in after.items():
            assert v.dtype == before[k].dtype, k
            if not train:
                assert torch.equal(v, before[k]), k
    assert np.mean(port_dev) <= 2 * np.mean(jax_dev)
    want = [] if train or name != "stereo_separator" else [torch.bfloat16]
    assert calls == want * 3


def test_bf16_stereo_step_runs_the_training_recurrence(monkeypatch):
    """The bf16 stereo step takes K2 and K3's plain versions once each on
    bf16 gates; validation takes K1's."""
    calls = []
    for fn in ("lstm_recurrence_plain", "lstm_recurrence_train_plain",
               "lstm_recurrence_bwd_plain"):
        real = getattr(L, fn)
        monkeypatch.setattr(L, fn, lambda *a, _n=fn, _r=real:
                            calls.append((_n, a[0].dtype)) or _r(*a))
    tr = _trainer("stereo_separator", *_weights("stereo_separator"))
    tr._train_step(_batch("stereo_separator"))
    assert calls == [("lstm_recurrence_train_plain", torch.bfloat16),
                     ("lstm_recurrence_bwd_plain", torch.float32)]
    calls.clear()
    tr.validate()
    assert calls == [("lstm_recurrence_plain", torch.bfloat16)]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_two_seeded_bf16_runs_are_equal(name):
    params, state = _weights(name)
    runs = []
    for _ in range(2):
        tr = _trainer(name, params, state, ema_decay=0.9)
        losses = [float(tr._train_step(_batch(name, seed=i))["loss"])
                  for i in range(2)]
        runs.append((losses, tr.model.state_dict(), tr.ema_params))
    (la, sa, ea), (lb, sb, eb) = runs
    assert la == lb
    assert all(torch.equal(v, sb[k]) for k, v in sa.items())
    assert all(torch.equal(v, eb[k]) for k, v in ea.items())


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        _trainer("denoiser", *_weights("denoiser"), dtype="float16")
