"""The port's int8 serving against the JAX package's (ops/quant.py).

The models run at their default widths on x [2, 1024, 1] (seeds through
numpy, BN statistics randomized), as tests/test_quant.py runs them; the
JAX side runs its int8 conv on the CPU as its own tests do. The chain runs
at narrow widths on 0.5 s in chunks of 4,400 samples (0.2 s rounded to
the packing grid), so JAX's compile stays small.

Three things JAX computes differently on the CPU, each in the last bit of
an f32, and each able to move an int8 code at a rounding boundary, after
which the flip cascades through the quantized layers downstream:
- XLA's rsqrt and torch.rsqrt round differently, so the BN folds differ in
  the last bit (the float model tests hold them at 1e-4);
- inside a jitted program XLA contracts and rewrites the epilogue and the
  in-program weight quantization (`acc * ws + bias` as one FMA, a division
  as a multiply by a reciprocal); run op by op, or with the weights closed
  over (quantized at compile time op by op), it computes them as written,
  as the port does (its kernel rounds each f32 operation on its own);
- summation order in the float convs and the LSTM.
JAX's two traced forms of its own int8 forward (weights as arguments, as
its pipeline runs it; weights closed over) disagree with each other in
some codes, and so by a part of its int8-vs-f32 deviation at the output.
So the comparisons that isolate the int8 arithmetic feed the port JAX's
BN folds; the codes are JAX's pipeline form's, the model outputs its
closed-over form's (both in the `case` fixture).

Bars:
- weights, requantization and the plain int8 conv equal JAX's bit for bit
  (the conv against JAX's int8_exec run op by op);
- calibration gives JAX's points, and scales within 1e-6 of each point's
  largest scale (the float forward differs by summation order);
- int8 codes: each point's layer fed JAX's inputs (teacher forcing) gives
  JAX's codes at >= 99.9% of positions, never more than 1 apart; the
  first point is exact;
- model outputs and the chain: within a quarter of JAX's own int8-vs-f32
  max deviation. One exception, the full-scope chain with each side
  calibrating on its own, is held at a half: scales ~1e-7 apart flip
  codes at rounding boundaries and the flips cascade through the
  quantized C>=128 stages (the same chain on one scales file is held at a
  quarter, test_int8_chain_on_jax_scales_file).
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.config import PipelineConfig as JaxConfig
from ml_audio_restoration_tpu.models import denoiser as jd
from ml_audio_restoration_tpu.models import stereo_separator as jst
from ml_audio_restoration_tpu.models import super_resolution as jsr
from ml_audio_restoration_tpu.ops import quant as jq
from ml_audio_restoration_tpu.pipeline import RestorationPipeline as JaxPipe
from ml_audio_restoration_torch import cli
from ml_audio_restoration_torch.config import PipelineConfig
from ml_audio_restoration_torch.models import denoiser as pd
from ml_audio_restoration_torch.models import stereo_separator as pst
from ml_audio_restoration_torch.models import super_resolution as psr
from ml_audio_restoration_torch.ops import int8_conv as ic
from ml_audio_restoration_torch.ops import quant as pq
from ml_audio_restoration_torch.pipeline import (
    RestorationPipeline, StreamingRestorer)
from test_torch_models import jax_model, port_model

RATE = 22050
MODELS = {"denoiser": (jd, pd, 20), "super_resolution": (jsr, psr, 13),
          "stereo_separator": (jst, pst, 16)}
SCOPES = ("packed", "full")
QUARTER = 0.25
CODE_AGREE = 0.999
SCALE_REL = 1e-6
NARROW = {"denoiser": {"features": (8, 16, 32)},
          "super_resolution": {"base_channels": 8, "num_residual_blocks": 2},
          "stereo_separator": {"base_channels": 8, "lstm_hidden": 16}}
CHUNK = {"chunk_seconds": 4400 / RATE, "overlap_seconds": 0.05}
# the behavioural cases compare the port with itself: short chunks keep
# the CPU's plain LSTM loop short
BEHAVE = {"chunk_seconds": 1000 / RATE, "overlap_seconds": 100 / RATE}
NAMES = tuple(NARROW)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's many small CPU ops: with several
    test workers on the host, each op's thread pool otherwise contends for
    the cores (the file ran ~15x slower than alone). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skip(name):
    return jd.INT8_FLOAT_LAYERS if name == "denoiser" else frozenset()


class _JaxRecorder(jq.QuantCtx):
    """JAX's QuantCtx that keeps every point's output (codes or float)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.values = {}

    def quantize_in(self, name, x):
        self.values[name] = out = super().quantize_in(name, x)
        return out

    def out(self, name, y, **k):
        self.values[name] = out = super().out(name, y, **k)
        return out


@pytest.fixture(scope="module")
def x_mono():
    return (np.random.default_rng(0).normal(size=(2, 1024, 1)) * 0.1
            ).astype(np.float32)


def _jax_folds(name, p, s):
    """JAX's folded (w, b) of every BN-folded conv, under the port's keys
    (models/denoiser.py::folded_wio)."""
    from ml_audio_restoration_tpu.models.common import fold_conv_bn

    def fold(pp, ss, conv="conv", bn="bn"):
        w, b = fold_conv_bn(pp[conv], pp[bn], ss[bn])
        return np.asarray(w), np.asarray(b)

    if name == "denoiser":
        out = {}
        for prefix, ps, ss in (
                *((f"enc{i}", p["encoder"][i], s["encoder"][i])
                  for i in range(3)),
                ("bot", p["bottleneck"], s["bottleneck"]),
                *((f"dec{i}", p["decoder"][i], s["decoder"][i])
                  for i in range(3))):
            for c in ("c1", "c2"):
                out[f"{prefix}.{c}"] = fold(ps[c], ss[c])
        return out
    if name == "super_resolution":
        out = {"middle": fold(p["middle"], s["middle"])}
        for i, (ps, ss) in enumerate(zip(p["blocks"], s["blocks"])):
            for j in (1, 2):
                out[f"blk{i}.c{j}"] = fold(ps, ss, f"conv{j}", f"bn{j}")
        return out
    out = {"stem": fold(p["stem"], s["stem"])}
    for i, (ps, ss) in enumerate(zip(p["blocks"], s["blocks"])):
        out[f"b{i}.d"] = fold(ps["dilated"], ss["dilated"])
        out[f"b{i}.p"] = fold(ps["pointwise"], ss["pointwise"])
    for side in ("left", "right"):
        for layer in ("l1", "l2", "l3"):
            out[f"{side}.{layer}"] = fold(p[side][layer], s[side][layer])
    return out


@pytest.fixture(scope="module", params=list(MODELS))
def case(request, x_mono):
    """One model at default widths: JAX's weights, folds and scales, its
    f32 output, and per scope its int8 output (weights closed over) and
    the value at every quantization point (weights as arguments)."""
    name = request.param
    jmod, pmod, n_points = MODELS[name]
    rng = np.random.default_rng(3 + list(MODELS).index(name))
    _, (p, s) = jax_model(name, 3, rng)
    x = jnp.asarray(x_mono)
    # the weights closed over: XLA quantizes them at compile time, op by
    # op, as written (module docstring)
    scales = jq.calibrate(lambda v: jmod.packed_amax(p, s, v), [x])
    y32 = np.asarray(jax.jit(lambda v: jmod.apply_packed(p, s, v))(x))
    out = {"name": name, "pmod": pmod, "n_points": n_points,
           "scales": scales, "y32": y32, "folds": _jax_folds(name, p, s),
           "port": port_model(name, p, s).eval()}

    for scope in SCOPES:
        def run(p, s, v):
            rec = _JaxRecorder(scales, scope, skip=_skip(name))
            return jmod.apply_packed(p, s, v, q=rec), rec.values

        out[f"{scope}_values"] = jax.jit(run)(p, s, x)[1]
        out[scope] = np.asarray(jax.jit(lambda v: run(p, s, v)[0])(x))
    return out


def _port_forward(case, scope, x, monkeypatch):
    """The port's int8 forward on JAX's scales and JAX's BN folds."""
    folds = case["folds"]
    monkeypatch.setattr(pd, "folded_wio", lambda q, key, conv, bn: tuple(
        torch.from_numpy(np.array(a)) for a in folds[key]))
    q = pq.QuantCtx(case["scales"], scope, skip=_skip(case["name"]))
    with torch.inference_mode():
        return case["pmod"].apply_packed(case["port"], torch.from_numpy(x),
                                         q=q)


# ------------------------------------------------------ weights and codes
@pytest.mark.parametrize("shape", [(3, 16, 8), (3, 128, 128), (14, 256, 1),
                                   (7, 1, 128), (1, 32, 1)])
def test_quantize_weight_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.normal(size=shape) * 0.2).astype(np.float32)
    w[0, 0, :] = 0.0  # a zero row keeps its channel's scale from it
    wq_j, s_j = jq.quantize_weight(jnp.asarray(w))
    wq_p, s_p = pq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(wq_p.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    assert wq_p.dtype == torch.int8 and int(wq_p.abs().max()) == 127


def test_requantize_matches_jax():
    rng = np.random.default_rng(1)
    y = (rng.normal(size=(2, 50, 6)) * 2).astype(np.float32)
    y[0, 0] = [-10.0, 0.0, 0.015, 0.025, -0.025, 10.0]  # clips and ties
    for scale in (np.float32(0.01), rng.uniform(0.005, 0.05, 6).astype(
            np.float32)):
        want = np.asarray(jq.requantize(jnp.asarray(y), scale))
        got = pq.requantize(torch.from_numpy(y), torch.as_tensor(scale))
        np.testing.assert_array_equal(got.numpy(), want)
    assert pq.requantize(torch.tensor([-10.0, 0.0, 0.004, 10.0]),
                         0.01).tolist() == [-127, 0, 0, 127]


def test_calibration_matches_jax(case, x_mono, record_property):
    with torch.inference_mode():
        amax = case["pmod"].packed_amax(case["port"],
                                        torch.from_numpy(x_mono))
    got = pq.scales_from_amax(pq.amax_to_host(amax))
    want = case["scales"]
    assert set(got) == set(want) and len(got) == case["n_points"]
    worst = 0.0
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape
        worst = max(worst, np.abs(a - b).max() / b.max())
        assert np.abs(a - b).max() <= SCALE_REL * b.max(), k
    record_property("scale_rel", float(worst))


@pytest.mark.parametrize("scope", SCOPES)
def test_int8_codes_match_jax(case, scope, x_mono, monkeypatch,
                              record_property):
    """Teacher forcing: every point's output is recorded, then replaced by
    JAX's, so each layer is compared on JAX's inputs."""
    want = case[f"{scope}_values"]
    got = {}

    def forced(name, out):
        got[name] = out
        j = want[name]
        if isinstance(out, pq.QT):
            return pq.QT(torch.from_numpy(np.array(j.q)), out.scale)
        return torch.from_numpy(np.array(j))

    fused, q_in, q_out = pq._fused, pq.QuantCtx.quantize_in, pq.QuantCtx.out
    monkeypatch.setattr(pq, "_fused", lambda q, name, *a, **k: forced(
        name, fused(q, name, *a, **k)))
    monkeypatch.setattr(pq.QuantCtx, "quantize_in", lambda self, name, x:
                        forced(name, q_in(self, name, x)))
    monkeypatch.setattr(pq.QuantCtx, "out", lambda self, name, y, **k:
                        forced(name, q_out(self, name, y, **k)))
    _port_forward(case, scope, x_mono, monkeypatch)
    assert set(got) == set(want) and next(iter(got)) == "in"
    np.testing.assert_array_equal(got["in"].q.numpy(),
                                  np.asarray(want["in"].q))
    worst = 1.0
    for name, out in got.items():
        if isinstance(out, pq.QT):
            j = np.asarray(want[name].q).astype(np.int32)
            diff = np.abs(out.q.numpy().astype(np.int32) - j)
            worst = min(worst, float((diff == 0).mean()))
            assert (diff == 0).mean() >= CODE_AGREE, name
            assert diff.max() <= 1, name
        else:
            assert np.abs(out.numpy() - np.asarray(want[name])).max() \
                <= 1e-5, name
    record_property("worst_code_agreement", worst)


@pytest.mark.parametrize("scope", SCOPES)
def test_model_int8_matches_jax(case, scope, x_mono, monkeypatch,
                                record_property):
    got = _port_forward(case, scope, x_mono, monkeypatch).numpy()
    want = case[scope]
    assert got.shape == want.shape and got.dtype == np.float32
    jax_dev = np.abs(want - case["y32"]).max()
    assert 0 < jax_dev < 5e-3  # JAX's own bar (tests/test_quant.py)
    record_property("ratio", float(np.abs(got - want).max() / jax_dev))
    assert np.abs(got - want).max() <= QUARTER * jax_dev


# ------------------------------------------------------ the plain int8 conv
@pytest.mark.parametrize("scope", SCOPES)
def test_plain_int8_conv_matches_jax(case, scope, x_mono, monkeypatch):
    """Every int8 conv of the forward (its strides, lhs dilations, pads,
    Cout=1 exits): the int32 accumulators against XLA's s8 conv, the whole
    fused epilogue against JAX's int8_exec and qconv epilogue run op by op,
    bit for bit."""
    calls = []
    make = pq.int8_exec

    def recording(x_scale, cache=None, key=None):
        ex = make(x_scale, cache, key)

        def _exec(xq, kernel, **kw):
            calls.append((xq, kernel(), x_scale, kw))
            return ex(xq, kernel, **kw)
        return _exec

    monkeypatch.setattr(pq, "int8_exec", recording)
    _port_forward(case, scope, x_mono, monkeypatch)
    assert calls
    for xq, (wp, bias), x_scale, kw in calls:
        geo = dict(window_strides=kw["window_strides"],
                   padding=kw["padding"],
                   lhs_dilation=kw.get("lhs_dilation"))
        xs = jnp.asarray(x_scale.numpy()).reshape(-1)
        wq, ws = jq.quantize_weight(jnp.asarray(wp.numpy()) * xs[None, :,
                                                                  None])
        acc = jax.lax.conv_general_dilated(
            jnp.asarray(xq.numpy()), wq, dimension_numbers=jq._DIMNUMS,
            preferred_element_type=jnp.int32, **geo)
        acc_p = ic.plain_accumulate(
            xq, torch.from_numpy(np.asarray(wq)),
            stride=geo["window_strides"][0],
            lhs_dilation=(geo["lhs_dilation"] or (1,))[0],
            padding=geo["padding"][0])
        np.testing.assert_array_equal(acc_p.numpy(), np.asarray(acc))
        # JAX's epilogue, op by op
        y = jq.int8_exec(xs)(jnp.asarray(xq.numpy()),
                             jnp.asarray(wp.numpy()),
                             None if bias is None
                             else jnp.asarray(bias.numpy()), **geo)
        if kw.get("add") is not None:
            add = kw["add"]
            y = y + (jq.dequantize(jq.QT(jnp.asarray(add.numpy()),
                                         jnp.asarray(kw["add_scale"].numpy())))
                     if add.dtype == torch.int8 else jnp.asarray(add.numpy()))
        if kw.get("act") == "lrelu":
            y = jnp.where(y >= 0, y, 0.2 * y)
        if kw.get("out_inv") is not None:
            y = jnp.clip(jnp.round(y * jnp.asarray(kw["out_inv"].numpy())),
                         -127, 127).astype(jnp.int8)
        weight = ic.Int8Weight(torch.from_numpy(np.asarray(wq)),
                               torch.from_numpy(np.asarray(ws)),
                               None if bias is None else bias)
        got = ic.int8_conv_plain(
            xq, weight, stride=geo["window_strides"][0],
            lhs_dilation=(geo["lhs_dilation"] or (1,))[0],
            padding=geo["padding"][0],
            **{k: v for k, v in kw.items() if k in (
                "add", "add_scale", "act", "out_inv", "out_dtype")})
        want = np.asarray(y)
        if got.dtype == torch.bfloat16:
            got, want = got.float(), want.astype(np.float32)
        np.testing.assert_array_equal(got.numpy(), want)


def test_jitted_int8_exec_within_rounding():
    """JAX's int8_exec run op by op is the port's epilogue bit for bit;
    jitted with the weights as arguments (as the JAX pipeline runs it) it
    differs from both in the last bits (XLA's contraction and rewrites)."""
    rng = np.random.default_rng(2)
    xq = jnp.asarray(rng.integers(-127, 128, (2, 64, 32)).astype(np.int8))
    wp = jnp.asarray((rng.normal(size=(3, 32, 16)) * 0.1).astype(np.float32))
    bias = jnp.asarray(rng.normal(size=16).astype(np.float32))
    xs = jnp.asarray(rng.uniform(0.001, 0.01, 32).astype(np.float32))
    geo = dict(window_strides=(1,), padding=[(1, 1)])
    eager = np.asarray(jq.int8_exec(xs)(xq, wp, bias, **geo))
    jitted = np.asarray(jax.jit(lambda x, w, b, sc: jq.int8_exec(sc)(
        x, w, b, **geo))(xq, wp, bias, xs))
    wq, ws = pq.quantize_weight(torch.from_numpy(np.asarray(wp))
                                * torch.from_numpy(np.asarray(xs))[:, None])
    got = ic.int8_conv_plain(torch.from_numpy(np.asarray(xq)),
                             ic.Int8Weight(wq, ws, torch.from_numpy(
                                 np.asarray(bias))), padding=(1, 1))
    np.testing.assert_array_equal(got.numpy(), eager)
    assert np.abs(jitted - eager).max() <= 1e-6 * np.abs(eager).max()


def test_int8_conv_raises_off_its_types():
    w = ic.Int8Weight(torch.zeros((3, 4, 2), dtype=torch.int8),
                      torch.ones(2))
    with pytest.raises(TypeError, match="s8"):
        ic.int8_conv(torch.zeros((1, 8, 4)), w, padding=(1, 1))
    with pytest.raises(ValueError, match="channels"):
        ic.int8_conv(torch.zeros((1, 8, 3), dtype=torch.int8), w)
    with pytest.raises(ValueError, match="activation"):
        ic.int8_conv(torch.zeros((1, 8, 4), dtype=torch.int8), w,
                     act="sigmoid")


# ------------------------------------------------------------- the chain
@pytest.fixture(scope="module")
def stages():
    rng = np.random.default_rng(5)
    return {name: jax_model(name, i, rng, **NARROW[name])[1]
            for i, name in enumerate(NAMES)}


@pytest.fixture(scope="module")
def clip():
    return (np.random.default_rng(1).normal(size=(1, RATE // 2)) * 0.15
            ).astype(np.float32)


def _port_pipe(stages, **cfg):
    return RestorationPipeline(
        *(port_model(name, *stages[name]) for name in NAMES),
        config=PipelineConfig(**cfg), device="cpu")


def _jax_pipe(stages, **cfg):
    return JaxPipe(*(stages[name] for name in NAMES),
                   config=JaxConfig(**cfg))


@pytest.fixture(scope="module")
def jax_chain(stages, clip):
    """JAX's f32 restore and its auto-calibrated int8 restore per scope."""
    out = {"f32": np.asarray(_jax_pipe(stages, **CHUNK).restore(clip)[0])}
    for scope in SCOPES:
        pipe = _jax_pipe(stages, quantize_int8=True, int8_scope=scope,
                         **CHUNK)
        out[scope] = np.asarray(pipe.restore(clip)[0])
        out[f"{scope}_scales"] = pipe._int8_scales
    return out


@pytest.mark.parametrize("scope,bar", [("packed", QUARTER), ("full", 0.5)])
def test_int8_chain_matches_jax(stages, clip, jax_chain, scope, bar,
                                record_property):
    """Each side auto-calibrates on the clip (see the module docstring for
    the full scope's bar)."""
    pipe = _port_pipe(stages, quantize_int8=True, int8_scope=scope, **CHUNK)
    got, rate = pipe.restore(clip)
    assert rate == 2 * RATE
    assert set(pipe._int8.scales) == set(jax_chain[f"{scope}_scales"])
    want = jax_chain[scope]
    jax_dev = np.abs(want - jax_chain["f32"]).max()
    assert jax_dev > 1e-4
    record_property("ratio", float(np.abs(got.numpy() - want).max()
                                   / jax_dev))
    assert np.abs(got.numpy() - want).max() <= bar * jax_dev


@pytest.mark.parametrize("scope", SCOPES)
def test_int8_chain_on_jax_scales_file(stages, clip, jax_chain, scope,
                                       tmp_path, record_property):
    """JAX's scales file loads in the port, and the port's restore on it is
    within a quarter of JAX's int8-vs-f32 deviation of JAX's restore on
    the same scales."""
    path = jq.save_scales_file(tmp_path / "jax.json",
                               jax_chain[f"{scope}_scales"])
    pipe = _port_pipe(stages, quantize_int8=True, int8_scope=scope, **CHUNK)
    assert pipe.load_int8_scales(path) == jax_chain[f"{scope}_scales"]
    got, _ = pipe.restore(clip)
    want = jax_chain[scope]
    jax_dev = np.abs(want - jax_chain["f32"]).max()
    record_property("ratio", float(np.abs(got.numpy() - want).max()
                                   / jax_dev))
    assert np.abs(got.numpy() - want).max() <= QUARTER * jax_dev


def test_port_scales_file_loads_in_jax(stages, clip, tmp_path):
    pipe = _port_pipe(stages, quantize_int8=True, **CHUNK)
    pipe.restore(clip)
    path = pipe.save_int8_scales(tmp_path / "port.json")
    assert jq.load_scales_file(path) == pipe._int8.scales
    assert pq.load_scales_file(path) == pipe._int8.scales
    # the same layout as JAX's writer: indent 1, sorted keys
    assert path.read_text() == json.dumps(pipe._int8.scales, indent=1,
                                          sort_keys=True)


# ------------------------------------------------------------- behaviour
@pytest.fixture(scope="module")
def small_stages():
    rng = np.random.default_rng(11)
    return {name: jax_model(name, 20 + i, rng, **NARROW[name])[1]
            for i, name in enumerate(NAMES)}


def _audio(seed, n=3000):
    return (np.random.default_rng(seed).normal(size=(1, n)) * 0.15).astype(
        np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).mean() / (np.abs(a).mean() + 1e-9))


def test_pipeline_autocalibrates_then_reuses(small_stages):
    base = _port_pipe(small_stages, **BEHAVE)
    pipe = _port_pipe(small_stages, quantize_int8=True, **BEHAVE)
    audio = _audio(1)
    out32, _ = base.restore(audio)
    outq, _ = pipe.restore(audio)
    assert set(pipe._int8.scales) == {"denoiser", "super_resolution",
                                      "stereo"}
    assert outq.shape == out32.shape and _rel(out32, outq) < 0.05
    version = pipe._int8.version
    pipe.restore(_audio(2, 2500))
    assert pipe._int8.version == version


def test_pipeline_subchunk_stereo_stays_float(small_stages, monkeypatch):
    cfg = dict(BEHAVE, stereo_chunk_seconds=250 / RATE)
    pipe = _port_pipe(small_stages, quantize_int8=True, **cfg)
    audio = _audio(3)
    pipe.calibrate_int8(audio)
    assert "stereo" in pipe._int8.scales  # calibration still records it
    ran = []
    packed = pst.apply_packed
    monkeypatch.setattr(pst, "apply_packed",
                        lambda *a, **k: ran.append(1) or packed(*a, **k))
    outq, _ = pipe.restore(audio)
    assert not ran  # the stereo stage ran its float forward
    out32, _ = _port_pipe(small_stages, **cfg).restore(audio)
    assert _rel(out32, outq) < 0.05


def test_pipeline_int8_source_rate(small_stages):
    cfg = dict(BEHAVE, stereo_source_rate=True)
    pipe = _port_pipe(small_stages, quantize_int8=True, **cfg)
    audio = _audio(4)
    outq, _ = pipe.restore(audio)
    assert set(pipe._int8.scales) == {"denoiser", "super_resolution",
                                      "stereo"}
    out32, _ = _port_pipe(small_stages, **cfg).restore(audio)
    assert _rel(out32, outq) < 0.05
    mono = RestorationPipeline(
        port_model("denoiser", *small_stages["denoiser"]),
        port_model("super_resolution", *small_stages["super_resolution"]),
        config=PipelineConfig(quantize_int8=True, **cfg), device="cpu")
    np.testing.assert_allclose(outq.numpy().mean(axis=0),
                               mono.restore(audio)[0].numpy()[0], atol=1e-5)


def test_whole_file_odd_length_falls_back(small_stages):
    audio = _audio(5, 1027)
    plain, _ = _port_pipe(small_stages, whole_file=True).restore(audio)
    pipe = _port_pipe(small_stages, whole_file=True, quantize_int8=True)
    with pytest.warns(UserWarning, match="int8 serving disabled"):
        outq, _ = pipe.restore(audio)
    assert not pipe._int8_failed  # a later recording may align
    np.testing.assert_array_equal(plain.numpy(), outq.numpy())


def test_without_packed_convs_falls_back(small_stages):
    audio = _audio(6)
    plain, _ = _port_pipe(small_stages, packed_convs=False,
                          **BEHAVE).restore(audio)
    pipe = _port_pipe(small_stages, packed_convs=False, quantize_int8=True,
                      **BEHAVE)
    with pytest.warns(UserWarning, match="int8 serving disabled"):
        outq, _ = pipe.restore(audio)
    assert pipe._int8.scales is None  # no calibration pass spent
    np.testing.assert_array_equal(plain.numpy(), outq.numpy())


def test_stale_scales_clear_error(small_stages, tmp_path):
    pipe = _port_pipe(small_stages, quantize_int8=True, **BEHAVE)
    path = tmp_path / "stale.json"
    path.write_text(json.dumps({"denoiser": {}, "super_resolution": {},
                                "stereo": {}}))
    pipe.load_int8_scales(path)
    with pytest.raises(KeyError, match="quantization point"):
        pipe.restore(_audio(7))


def test_pipeline_missing_stage_scales_recalibrate(small_stages):
    audio = _audio(8)
    ref = _port_pipe(small_stages, quantize_int8=True, **BEHAVE)
    out_ref, _ = ref.restore(audio)
    pipe = _port_pipe(small_stages, quantize_int8=True, **BEHAVE)
    pipe._int8.set({k: v for k, v in ref._int8.scales.items()
                    if k != "stereo"})
    with pytest.warns(UserWarning, match="lack stage"):
        outq, _ = pipe.restore(audio)
    assert set(pipe._int8.scales) == {"denoiser", "super_resolution",
                                      "stereo"}
    np.testing.assert_array_equal(out_ref.numpy(), outq.numpy())


def _stream(small_stages, **kw):
    return StreamingRestorer(
        denoiser=port_model("denoiser", *small_stages["denoiser"]),
        super_resolution=port_model("super_resolution",
                                    *small_stages["super_resolution"]),
        device="cpu", **kw)


def _run(s, x, block=2048):
    outs = [s.feed(x[o:o + block]) for o in range(0, x.size, block)]
    outs.append(s.flush())
    return np.concatenate(outs, axis=-1)


def test_streaming_missing_stage_scales_recalibrate(small_stages):
    x = _audio(9, 4096)[0]
    ref = _stream(small_stages, quantize_int8=True)
    out_ref = _run(ref, x)
    assert set(ref._int8.scales) == {"denoiser", "super_resolution"}
    s = _stream(small_stages, quantize_int8=True,
                int8_scales={"denoiser": ref._int8.scales["denoiser"]})
    with pytest.warns(UserWarning, match="lack stage"):
        out = _run(s, x)
    assert s.quantize_int8  # recalibrated, not downgraded
    assert set(s._int8.scales) == {"denoiser", "super_resolution"}
    np.testing.assert_array_equal(out_ref, out)
    float_out = _run(_stream(small_stages), x)
    assert 0 < _rel(float_out, out) < 0.05


def test_pipeline_gate_failure_does_not_retry(small_stages):
    pipe = _port_pipe(small_stages, packed_convs=False, quantize_int8=True,
                      **BEHAVE)
    audio = _audio(10)
    with pytest.warns(UserWarning, match="int8 serving disabled"):
        pipe.restore(audio)
    assert pipe._int8_failed
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pipe.restore(audio)


def test_streaming_preloaded_scales_respect_packed_gate(small_stages):
    x = _audio(11, 4096)[0]
    calib = _stream(small_stages, quantize_int8=True)
    _run(calib, x)
    want = _run(_stream(small_stages, packed=False), x)
    s = _stream(small_stages, packed=False, quantize_int8=True,
                int8_scales=calib._int8.scales)
    with pytest.warns(UserWarning, match="int8 streaming unavailable"):
        out = _run(s, x)
    assert not s.quantize_int8
    np.testing.assert_array_equal(want, out)


def test_warmup_with_uncovered_scales_skips(small_stages):
    audio = _audio(12)
    ref = _port_pipe(small_stages, quantize_int8=True,
                     max_chunks_per_program=4, **BEHAVE)
    ref.restore(audio)
    pipe = _port_pipe(small_stages, quantize_int8=True,
                      max_chunks_per_program=4, **BEHAVE)
    pipe._int8.set({k: v for k, v in ref._int8.scales.items()
                    if k != "stereo"})
    with pytest.warns(UserWarning, match="lack stage"):
        info = pipe.warmup()
    assert info["programs"] == 0 and pipe._int8.scales is None
    out, _ = pipe.restore(audio)
    assert np.isfinite(out.numpy()).all()
    s = _stream(small_stages, quantize_int8=True)
    with pytest.warns(UserWarning, match="warmup skipped"):
        assert s.warmup(2048) == {"programs": 0, "seconds": 0.0}


def test_disabled_sr_stage_does_not_recalibrate(small_stages):
    pipe = _port_pipe(small_stages, quantize_int8=True,
                      enable_super_resolution=False, **BEHAVE)
    out, rate = pipe.restore(_audio(13))
    assert rate == RATE
    assert set(pipe._int8.scales) == {"denoiser", "stereo"}
    version = pipe._int8.version
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pipe.restore(_audio(14))
    assert pipe._int8.version == version


def test_scales_file_roundtrip_atomic(tmp_path):
    path = tmp_path / "scales.json"
    pq.save_scales_file(path, {"denoiser": {"in": [0.1, 0.2]}})
    pq.save_scales_file(path, {"denoiser": {"in": [0.3]},
                               "stereo": {"in": [1.0]}})
    assert pq.load_scales_file(path) == {"denoiser": {"in": [0.3]},
                                         "stereo": {"in": [1.0]}}
    assert [p.name for p in tmp_path.iterdir()] == ["scales.json"]


def test_saved_scales_restore_equal(small_stages, tmp_path):
    audio = _audio(15)
    first = _port_pipe(small_stages, quantize_int8=True, **BEHAVE)
    out1, _ = first.restore(audio)
    path = first.save_int8_scales(tmp_path / "s.json")
    second = _port_pipe(small_stages, quantize_int8=True, **BEHAVE)
    second.load_int8_scales(path)
    version = second._int8.version
    out2, _ = second.restore(audio)
    assert second._int8.version == version  # no recalibration
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())


def test_cli_int8_restore_and_stream(small_stages, tmp_path):
    """`restore --int8 --int8-scales` writes the scales it calibrated and
    loads them on the next run; `stream --int8` runs the int8 streams."""
    from ml_audio_restoration_tpu.compat.torch_saver import EXPORTERS
    from ml_audio_restoration_torch.audio import load_audio, save_audio

    args = []
    for name, flag in zip(NAMES, ("--denoiser", "--super-res", "--stereo")):
        path = tmp_path / f"{name}.pth"
        torch.save({"model_state_dict": EXPORTERS[name](*small_stages[name])},
                   path)
        args += [flag, str(path)]
    src = tmp_path / "in.wav"
    save_audio(src, _audio(16, 3000), RATE)
    scales = tmp_path / "scales.json"
    for i in range(2):
        assert cli.main(["restore", str(src), str(tmp_path / f"o{i}.wav"),
                         "--chunk-seconds", str(BEHAVE["chunk_seconds"]),
                         "--overlap-seconds", str(BEHAVE["overlap_seconds"]),
                         "--int8", "--int8-scales", str(scales),
                         "--device", "cpu", *args]) == 0
        assert set(pq.load_scales_file(scales)) == {
            "denoiser", "super_resolution", "stereo"}
    a, _ = load_audio(tmp_path / "o0.wav", None, mono=False)
    b, _ = load_audio(tmp_path / "o1.wav", None, mono=False)
    np.testing.assert_array_equal(a, b)
    stream_scales = tmp_path / "stream.json"
    assert cli.main(["stream", str(src), "--output-dir",
                     str(tmp_path / "streamed"), "--int8", "--int8-scales",
                     str(stream_scales), "--device", "cpu", *args]) == 0
    assert set(pq.load_scales_file(stream_scales)) == {"denoiser",
                                                       "super_resolution"}
    out, rate = load_audio(tmp_path / "streamed" / "in_restored.wav", None,
                           mono=False)
    assert rate == 2 * RATE and out.shape == (2, 6000)
