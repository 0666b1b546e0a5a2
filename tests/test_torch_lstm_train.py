"""The port's training recurrence (K2 forward, K3 backward) against the JAX
package's.

`lstm_recurrence_train_plain` is held against the Pallas forward-train
kernel and `lstm_recurrence_bwd_plain` against the Pallas backward kernel,
both run in interpret mode as tests/test_ops.py runs them, at T=150 with
block_t=64 (T not a block multiple, so the Pallas side pads and must take
the carry and seed the cotangents at the true last step). Bars: forward
1e-6 (same per-step f32 arithmetic, summed in another order); backward
2e-5, the bar tests/test_ops.py holds the Pallas backward to against the
scan VJP. The CUDA kernels themselves run only on a card
(tests/test_torch_cuda.py there, and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.ops.lstm import lstm as jax_lstm
from ml_audio_restoration_tpu.ops.lstm import lstm_recurrence_scan
from ml_audio_restoration_tpu.ops.pallas.lstm import (
    lstm_recurrence_pallas_bwd, lstm_recurrence_pallas_train)
from ml_audio_restoration_torch.ops import lstm as L

FWD_BAR = 1e-6
BWD_BAR = 2e-5


def _inputs(rng, t, b, h):
    gates = (rng.normal(size=(t, b, 4 * h)) * 0.5).astype(np.float32)
    w_hh = (rng.normal(size=(h, 4 * h)) * 0.2).astype(np.float32)
    h0, c0 = ((rng.normal(size=(b, h)) * 0.3).astype(np.float32)
              for _ in range(2))
    return gates, w_hh, h0, c0


def _cotangents(rng, t, b, h):
    dout = (rng.normal(size=(t, b, h)) * 0.1).astype(np.float32)
    dhf, dcf = ((rng.normal(size=(b, h)) * 0.1).astype(np.float32)
                for _ in range(2))
    return dout, dhf, dcf


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _pallas(gates, w_hh, h0, c0, dout, dhf, dcf):
    (out, (hf, cf)), res = lstm_recurrence_pallas_train(
        jnp.asarray(gates), jnp.asarray(w_hh),
        (jnp.asarray(h0), jnp.asarray(c0)), block_t=64, time_major=True,
        interpret=True)
    t, b = gates.shape[:2]
    fwd = {"out": np.asarray(out).transpose(1, 0, 2), "hf": np.asarray(hf),
           "cf": np.asarray(cf), "acts": np.asarray(res[0])[:t, :b],
           "cseq": np.asarray(res[1])[:t, :b]}
    dgx, dw, dh0, dc0 = lstm_recurrence_pallas_bwd(
        res, jnp.asarray(w_hh), jnp.asarray(dout.transpose(1, 0, 2)),
        (jnp.asarray(dhf), jnp.asarray(dcf)), dgx_time_major=True,
        interpret=True)
    bwd = {"dgx": np.asarray(dgx), "dw": np.asarray(dw),
           "dh0": np.asarray(dh0), "dc0": np.asarray(dc0)}
    return fwd, bwd


@pytest.mark.parametrize("t,b,h", [(150, 3, 8), (64, 2, 16)])
def test_train_plain_matches_pallas_interpret(rng, t, b, h):
    gates, w_hh, h0, c0 = _inputs(rng, t, b, h)
    dout, dhf, dcf = _cotangents(rng, t, b, h)
    want_f, want_b = _pallas(gates, w_hh, h0, c0, dout, dhf, dcf)

    out, hf, cf, acts, cseq = L.lstm_recurrence_train_plain(
        *_t(gates, w_hh, h0, c0))
    got_f = {"out": out, "hf": hf, "cf": cf, "acts": acts, "cseq": cseq}
    for k, v in got_f.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_allclose(v.numpy(), want_f[k], atol=FWD_BAR,
                                   err_msg=k)

    dgx, dw, dh0, dc0 = L.lstm_recurrence_bwd_plain(
        acts, cseq, out, *_t(h0, c0, w_hh, dout, dhf, dcf))
    got_b = {"dgx": dgx, "dw": dw, "dh0": dh0, "dc0": dc0}
    for k, v in got_b.items():
        np.testing.assert_allclose(v.numpy(), want_b[k], atol=BWD_BAR,
                                   err_msg=k)


def test_train_forward_bf16_gates(rng):
    """bf16 gates: upcast on load, h not rounded, every output f32 -- the
    Pallas forward-train kernel's contract."""
    gates, w_hh, h0, c0 = _inputs(rng, 150, 3, 8)
    gb = torch.from_numpy(gates).bfloat16()
    out, hf, cf, acts, cseq = L.lstm_recurrence_train_plain(
        gb, *_t(w_hh, h0, c0))
    assert all(x.dtype == torch.float32 for x in (out, hf, cf, acts, cseq))
    (want, (wh, wc)), _ = lstm_recurrence_pallas_train(
        jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w_hh), (jnp.asarray(h0), jnp.asarray(c0)), block_t=64,
        time_major=True, interpret=True)
    np.testing.assert_allclose(out.numpy().transpose(1, 0, 2),
                               np.asarray(want), atol=FWD_BAR)
    np.testing.assert_allclose(hf.numpy(), np.asarray(wh), atol=FWD_BAR)
    np.testing.assert_allclose(cf.numpy(), np.asarray(wc), atol=FWD_BAR)


def test_train_forward_equals_inference_in_f32(rng):
    """In f32 the training forward is the inference recurrence."""
    gates, w_hh, h0, c0 = _inputs(rng, 90, 2, 8)
    out, hf, cf, _, _ = L.lstm_recurrence_train_plain(*_t(gates, w_hh, h0,
                                                          c0))
    ref, rh, rc = L.lstm_recurrence_plain(*_t(gates, w_hh, h0, c0))
    torch.testing.assert_close(out.transpose(0, 1), ref, rtol=0, atol=0)
    torch.testing.assert_close(hf, rh, rtol=0, atol=0)
    torch.testing.assert_close(cf, rc, rtol=0, atol=0)


def test_gradcheck_float64(rng):
    """The Function's analytic backward (plain K3) against finite
    differences of its forward (plain K2), in float64."""
    t, b, h = 7, 2, 4
    gates, w_hh, h0, c0 = _inputs(rng, t, b, h)
    args = [torch.from_numpy(a).double().requires_grad_()
            for a in (gates, w_hh, h0, c0)]
    assert torch.autograd.gradcheck(L.LSTMRecurrenceTrain.apply, args,
                                    eps=1e-6, atol=1e-6, rtol=1e-5)


def test_grad_through_lstm_matches_jax_vjp(rng, monkeypatch):
    """The repaired fault: a gradient through ops.lstm.lstm with inputs
    that require grad runs LSTMRecurrenceTrain (K3's plain version on the
    CPU) and equals the JAX VJP of the scan within 2e-5."""
    calls = []
    real = L.lstm_recurrence_bwd_plain

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(L, "lstm_recurrence_bwd_plain", spy)
    b, t, c, h = 3, 150, 6, 8
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    p = {"w_ih": (rng.normal(size=(c, 4 * h)) * 0.3).astype(np.float32),
         "w_hh": (rng.normal(size=(h, 4 * h)) * 0.2).astype(np.float32),
         "b_ih": (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32),
         "b_hh": (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32)}
    ct = (rng.normal(size=(b, t, h)) * 0.1).astype(np.float32)

    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    y = L.lstm(tx, tp)
    grads = torch.autograd.grad(y, [tx] + list(tp.values()),
                                torch.from_numpy(ct))
    assert calls == [1]

    def f(x, p):
        return jax_lstm(x, p, impl="scan")

    _, vjp = jax.vjp(f, jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in p.items()})
    jx, jp = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jx),
                               atol=BWD_BAR)
    for g, k in zip(grads[1:], tp):
        np.testing.assert_allclose(g.numpy(), np.asarray(jp[k]),
                                   atol=BWD_BAR, err_msg=k)


def test_carry_cotangents_match_scan_vjp(rng):
    """Cotangents on the final carry (dhf, dcf) and gradients into the
    initial carry (dh0, dc0), through lstm_recurrence, against the scan."""
    t, b, h = 40, 2, 8
    gates, w_hh, h0, c0 = _inputs(rng, t, b, h)
    dout, dhf, dcf = _cotangents(rng, t, b, h)
    args = [torch.from_numpy(a).requires_grad_()
            for a in (gates, w_hh, h0, c0)]
    out, hf, cf = L.lstm_recurrence(*args)
    assert out.dtype == torch.float32 and out.shape == (b, t, h)
    grads = torch.autograd.grad(
        (out, hf, cf), args,
        _t(dout.transpose(1, 0, 2).copy(), dhf, dcf))

    def f(g, w, h, c):
        ys, (hf, cf) = lstm_recurrence_scan(g, w, carry=(h, c),
                                            return_carry=True,
                                            time_major=True)
        return ys, hf, cf

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (gates, w_hh, h0, c0)))
    want = vjp((jnp.asarray(dout.transpose(1, 0, 2)), jnp.asarray(dhf),
                jnp.asarray(dcf)))
    for g, w, name in zip(grads, want, ("dgx", "dw", "dh0", "dc0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_BAR,
                                   err_msg=name)


def test_no_grad_takes_inference_route(rng):
    """Without grad the recurrence stays on the inference route (out in
    the gates' dtype, K1's plain version), and no count moves on a CPU
    tensor."""
    gates, w_hh, h0, c0 = _inputs(rng, 20, 2, 8)
    gb = torch.from_numpy(gates).bfloat16().requires_grad_()
    counts = (L.launch_count, L.train_fwd_launch_count,
              L.train_bwd_launch_count)
    with torch.no_grad():
        out, _, _ = L.lstm_recurrence(gb, *_t(w_hh, h0, c0))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 20, 8)
    out, _, _ = L.lstm_recurrence(gb, *_t(w_hh, h0, c0))
    assert out.dtype == torch.float32  # the train route
    out.sum().backward()
    assert gb.grad is not None and gb.grad.dtype == torch.bfloat16
    assert counts == (L.launch_count, L.train_fwd_launch_count,
                      L.train_bwd_launch_count)


def test_reset_launch_count_clears_all(monkeypatch):
    monkeypatch.setattr(L, "launch_count", 3)
    monkeypatch.setattr(L, "train_fwd_launch_count", 2)
    monkeypatch.setattr(L, "train_bwd_launch_count", 1)
    L.reset_launch_count()
    assert (L.launch_count, L.train_fwd_launch_count,
            L.train_bwd_launch_count) == (0, 0, 0)


# ------------------------------------------- K3's wrapper, without a card
def _bwd_args(t=9, b=3, h=16):
    rng = np.random.default_rng(5)
    shapes = {"acts": (t, b, 4 * h), "cseq": (t, b, h), "out": (t, b, h),
              "h0": (b, h), "c0": (b, h), "w_hh": (h, 4 * h),
              "dout": (t, b, h), "dhf": (b, h), "dcf": (b, h)}
    return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for k, s in shapes.items()}


@pytest.fixture
def fake_launch(monkeypatch):
    """The kernel loader and the launcher replaced: no nvcc and no card.
    Returns the list of (kernel, n_ptrs, n_ints, ints) launched."""
    launched = []

    class Lib:
        def __getattr__(self, name):
            return name

    monkeypatch.setattr(L._build, "load", lambda name: Lib())
    monkeypatch.setattr(
        L, "_launch", lambda kernel, fn, n_ptrs, n_ints, args, dev:
        launched.append((kernel, fn, n_ptrs, n_ints, args[n_ptrs:])))
    return launched


def _call_bwd(a):
    return L._lstm_train_bwd_cuda(a["acts"], a["cseq"], a["out"], a["h0"],
                                  a["c0"], a["w_hh"], a["dout"], a["dhf"],
                                  a["dcf"])


@pytest.mark.parametrize("bad", [
    ("acts", lambda x: x[:, :, :-4]), ("cseq", lambda x: x[:-1]),
    ("out", lambda x: x[:, :2]), ("h0", lambda x: x[:, :-1]),
    ("dout", lambda x: x[1:]), ("dcf", lambda x: x[:2]),
    ("w_hh", lambda x: x.T.contiguous()),
    ("dhf", lambda x: x.double()), ("out", lambda x: x.bfloat16()),
    ("c0", lambda x: torch.empty(x.shape, device="meta")),
    ("acts", lambda x: torch.zeros(x.shape[:2] + (32,)))])
def test_train_bwd_wrapper_raises_before_launch(fake_launch, bad):
    """Shape, dtype and device checks (and an unsupported H: gates width 32
    is H = 8) raise before either of K3's launches, and the count stays."""
    a = _bwd_args()
    name, change = bad
    a[name] = change(a[name])
    before = L.train_bwd_launch_count
    with pytest.raises((ValueError, TypeError)):
        _call_bwd(a)
    assert fake_launch == [] and L.train_bwd_launch_count == before


@pytest.mark.parametrize("t,b,h", [(9, 3, 16), (1, 1, 64), (700, 5, 32)])
def test_train_bwd_wrapper_launches_walk_then_dw_pass(fake_launch, t, b, h):
    """One call: the walk, then the dW_hh pass over its dgx with the
    split-K plan of T*B rows, and the count moves by one."""
    before = L.train_bwd_launch_count
    dgx, dw, dh0, dc0 = _call_bwd(_bwd_args(t, b, h))
    assert L.train_bwd_launch_count == before + 1
    splits, per = L._dw_splits(t * b)
    assert fake_launch == [
        ("lstm_train_bwd", "lstm_train_bwd", 10, 3, [t, b, h]),
        ("lstm_train_dw", "lstm_train_dw", 5, 5, [t, b, h, splits, per])]
    assert (dgx.shape, dw.shape, dh0.shape, dc0.shape) == (
        (t, b, 4 * h), (h, 4 * h), (b, h), (b, h))
    assert all(x.dtype == torch.float32 for x in (dgx, dw, dh0, dc0))


@pytest.mark.parametrize("rows", [0, 1, 15, 16, 1024, 1025, 16 * 2768,
                                  705600, 10 ** 7])
def test_dw_splits_cover_the_rows(rows):
    """Splits of a multiple of the 16-row stage, at most 256, none empty,
    covering every row once."""
    splits, per = L._dw_splits(rows)
    assert per % 16 == 0 and 1 <= splits <= 256
    assert splits * per >= rows
    assert rows == 0 and splits == 1 or (splits - 1) * per < rows


@pytest.mark.parametrize("t,b,h", [(150, 3, 8), (300, 7, 16)])
def test_dw_pass_decomposition_matches_plain(rng, t, b, h):
    """The dW_hh pass's arithmetic on the CPU: rows k = t*B + b pair
    h0[b] (k < B) or out[k - B] with dgx[k]; each split sums its rows, and
    the splits are added in split order. It equals the plain backward's
    dW_hh within 1e-4 of its largest entry (the card's bar)."""
    gates, w_hh, h0, c0 = _inputs(rng, t, b, h)
    dout, dhf, dcf = _cotangents(rng, t, b, h)
    out, _, _, acts, cseq = L.lstm_recurrence_train_plain(
        *_t(gates, w_hh, h0, c0))
    dgx, want, _, _ = L.lstm_recurrence_bwd_plain(
        acts, cseq, out, *_t(h0, c0, w_hh, dout, dhf, dcf))
    rows = torch.cat([torch.from_numpy(h0), out.reshape(-1, h)])[:t * b]
    d = dgx.reshape(-1, 4 * h)
    splits, per = L._dw_splits(t * b)
    got = torch.zeros(h, 4 * h)
    for s in range(splits):
        got += rows[s * per:(s + 1) * per].T @ d[s * per:(s + 1) * per]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
