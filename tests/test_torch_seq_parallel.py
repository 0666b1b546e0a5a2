"""Sequence-parallel serving of the port (the mesh's 'model' axis,
parallel/sequence.py and RestorationPipeline._sequence_stack): each chunk's
time split over a mesh row, against the port unsharded and against the JAX
package's P("data", "model", None) on its 8 virtual CPU devices
(tests/conftest.py).

The CPU is one torch device, so the meshes here repeat it: the windows run
one after another on it, which checks the cut grid, the halos, the crops,
the gathers and the numbers.

Bars:
- sharded against unsharded: SHARD_TOL (atol 2e-5, rtol 1e-4), the bar of
  the data axis's tests (tests/test_torch_mesh.py); whole-file 1e-5, as
  JAX tests/test_pipeline.py:633 and tests/test_framework.py:307 hold it;
- the port against the JAX package's sequence-parallel restore: CHAIN_BAR
  (1e-3);
- one stage on windows against the stage whole: 1e-5;
- the windowed interpolation against the whole's slice: bit for bit.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from ml_audio_restoration_tpu.config import PipelineConfig as JaxConfig
from ml_audio_restoration_tpu.parallel import make_mesh as jax_mesh
from ml_audio_restoration_tpu.pipeline import RestorationPipeline as JaxPipe
from ml_audio_restoration_torch.config import PipelineConfig
from ml_audio_restoration_torch.models import (AudioDenoiser,
                                               AudioSuperResolution,
                                               StereoSeparator)
from ml_audio_restoration_torch.models.common import init_params
from ml_audio_restoration_torch.ops import upsample_linear
from ml_audio_restoration_torch.parallel import make_mesh, time_shards
from ml_audio_restoration_torch.parallel import sequence
from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                 StreamingRestorer)
from ml_audio_restoration_torch.pipeline import restore as restore_mod
from test_torch_models import jax_model, port_model
from test_torch_pipeline import CHAIN_BAR, CHUNKED, RATE, SMALL
from test_torch_serving import stages  # noqa: F401

SHARD_TOL = dict(atol=2e-5, rtol=1e-4)
WHOLE_TOL = 1e-5
STAGE_TOL = 1e-5
STREAM_TOL = 1e-6
NAMES = {"denoiser": "denoiser", "super_resolution": "super_resolution",
         "stereo_separator": "stereo"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's many small CPU ops (as
    tests/test_torch_mesh.py). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(data, model):
    return make_mesh(data, model, devices=["cpu"] * (data * model))


def _models(stages, names=tuple(SMALL)):  # noqa: F811
    return {NAMES[n]: port_model(n, *stages[n]) for n in names}


def _port(stages, mesh=None, names=tuple(SMALL), **cfg):  # noqa: F811
    return RestorationPipeline(**_models(stages, names),
                               config=PipelineConfig(**cfg), device="cpu",
                               mesh=mesh)


def _jax(stages, mesh=None, **cfg):  # noqa: F811
    return JaxPipe(denoiser=stages["denoiser"],
                   super_resolution=stages["super_resolution"],
                   stereo=stages["stereo_separator"], config=JaxConfig(**cfg),
                   mesh=mesh)


def _audio(t, seed=1):
    return (np.random.default_rng(seed).normal(size=(1, t)) * 0.2).astype(
        np.float32)


def _seeded(cls, seed, **cfg):
    gen = torch.Generator().manual_seed(seed)
    return init_params(cls(**cfg), gen).eval()


def _windowed(fn, x, cores, halo, rate=1, **kw):
    """fn on each core's window of x [B, C, T], cropped and concatenated:
    the sequence-parallel path of one stage."""
    t = x.shape[-1]
    outs = []
    for w in sequence.windows(cores, halo, t):
        extra = ({"offset": w.start, "total": t} if kw.get("window")
                 else {})
        outs.append(sequence.crop(fn(x[..., w.start:w.stop], **extra), w,
                                  rate))
    return torch.cat(outs, dim=-1)


def _stage_radii(dn, sr, st):
    """Each stage's own receptive radius at its input rate, on its grid."""
    return {"denoiser": sequence.radius(sequence.denoiser_field(dn),
                                        grid=2 ** len(dn.encoder)),
            "super_resolution": sequence.radius(
                sequence.super_resolution_field(sr),
                2 ** len(sr.upsample_blocks)),
            "stereo_encoder": sequence.radius(sequence.encoder_field(st)),
            "stereo_decoder": sequence.radius(sequence.decoder_field(st))}


# ---------------------------------------------------------- the cuts

def test_time_shards_cut_on_the_grid():
    """Cores cover the length, cut on the grid, the first ones taking the
    extra grid units; a length with fewer grid units than the row has
    devices gets fewer cores (the last devices stay empty)."""
    m8 = _cpu_mesh(1, 8)
    assert time_shards(m8, 16384, 8) == [(i * 2048, (i + 1) * 2048)
                                         for i in range(8)]
    assert time_shards(m8, 100, 8) == [(0, 16), (16, 32), (32, 48),
                                       (48, 64), (64, 80), (80, 88),
                                       (88, 96), (96, 100)]
    assert time_shards(m8, 1, 8) == [(0, 1)]
    assert time_shards(m8, 20, 8) == [(0, 8), (8, 16), (16, 20)]
    assert time_shards(_cpu_mesh(2, 3), 22050, 1) == [(0, 7350),
                                                      (7350, 14700),
                                                      (14700, 22050)]
    assert sequence.windows([(0, 16), (16, 32)], 24, 40) == [
        sequence.Window(0, 16, 0, 40), sequence.Window(16, 32, 0, 40)]


def test_default_radii_are_derived_from_the_modules():
    """The receptive radii of the default stages at their input rates, and
    the plans built from them: the denoiser's grid is its three pools
    (8), the front halo one input halo for the three stages in front of
    the LSTM, the back halo the decoders' 12 rounded up to the stage
    rate's grid. A wider kernel moves them."""
    dn, sr, sp = AudioDenoiser(), AudioSuperResolution(), StereoSeparator()
    radii = _stage_radii(dn, sr, sp)
    assert radii == {"denoiser": 54, "super_resolution": 15,
                     "stereo_encoder": 18, "stereo_decoder": 12}
    assert sequence.plan(dn, sr, sp) == sequence.SequencePlan(8, 80, 16)
    assert sequence.plan(dn, sr, sp, stereo_windows=True).back_halo == 0
    assert sequence.plan(None, sr, None).grid == 1
    assert sequence.plan(None, sr, sp, packed=True).grid == 4
    wide = StereoSeparator()
    wide.encoder[0][0] = torch.nn.Conv1d(1, 32, 11, padding=5)
    assert sequence.radius(sequence.encoder_field(wide)) == 20


# ------------------------------------------------------- single stages

@pytest.mark.parametrize("t", [16384, 16389])
def test_denoiser_time_sharded_over_eight(rng, t):
    """JAX tests/test_framework.py:307 on the port: the default denoiser
    with the time of one input cut into 8 cores on its pooling grid, each
    window run alone and cropped, against the whole (and at an odd
    length, whose last window carries the odd pooling tail)."""
    model = _seeded(AudioDenoiser, 0)
    x = torch.from_numpy(rng.normal(size=(1, 1, t)).astype(np.float32)
                         * 0.2)
    plan = sequence.plan(model)
    cores = time_shards(_cpu_mesh(1, 8), t, plan.grid)
    assert len(cores) == 8
    with torch.inference_mode():
        want = model(x)
        got = _windowed(model, x, cores, plan.front_halo)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=STAGE_TOL)


STAGES = {
    "denoiser": (AudioDenoiser, {"features": (8, 16, 32)}),
    "denoiser_two_levels": (AudioDenoiser, {"features": (8, 16)}),
    "super_resolution": (AudioSuperResolution, {"base_channels": 8}),
    "super_resolution_x4": (AudioSuperResolution,
                            {"base_channels": 8, "upscale_factor": 4,
                             "num_residual_blocks": 2}),
    "stereo_encoder": (StereoSeparator, {"base_channels": 8}),
    "stereo_decoder": (StereoSeparator, {"base_channels": 8,
                                         "lstm_hidden": 16}),
}
_built: dict = {}


def _stage(name):
    """(fn, rate, halo, grid, in_channels) of one stage at narrow width."""
    if name not in _built:
        cls, cfg = STAGES[name]
        model = _seeded(cls, len(_built), **cfg)
        if name.startswith("denoiser"):
            plan = sequence.plan(model)
            _built[name] = (model, 1, plan.front_halo, plan.grid, 1, False)
        elif name.startswith("super_resolution"):
            plan = sequence.plan(sr=model)
            _built[name] = (model, 2 ** len(model.upsample_blocks),
                            plan.front_halo, plan.grid, 1, True)
        elif name == "stereo_encoder":
            plan = sequence.plan(st=model)
            _built[name] = (model.encode, 1, plan.front_halo, 1, 1, False)
        else:
            plan = sequence.plan(st=model)
            _built[name] = (model.decode, 1, plan.back_halo, 1, 16, False)
    return _built[name]


@settings(max_examples=12, deadline=None)
@given(name=st.sampled_from(sorted(STAGES)), data=st.data())
def test_derived_halo_reproduces_each_stage(name, data):
    """For random lengths, row sizes and cut positions on the stage's
    grid, each stage run on its windows with the derived halo and cropped
    equals the stage run whole, on every core."""
    fn, rate, halo, grid, cin, window = _stage(name)
    t = data.draw(st.integers(min_value=max(grid, 4), max_value=700),
                  label="length")
    units = -(-t // grid)
    cuts = sorted(data.draw(st.sets(st.integers(1, max(units - 1, 1)),
                                    max_size=6), label="cuts")
                  - {units})
    bounds = [0] + [c * grid for c in cuts if c * grid < t] + [t]
    cores = list(zip(bounds[:-1], bounds[1:]))
    seed = data.draw(st.integers(0, 2 ** 16), label="seed")
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(2, cin, t)).astype(np.float32) * 0.3)
    with torch.inference_mode():
        want = fn(x)
        got = _windowed(fn, x, cores, halo, rate, window=window)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=STAGE_TOL)


def test_windowed_upsample_is_bit_for_bit_past_2_23():
    """Past output index 2**23, dst + 0.5 rounds in float32: a window that
    passes its global offset gives the whole's slice bit for bit (the core:
    every output whose two source samples lie in the window), one that
    counts from its own start does not. The last window clamps at the
    recording's real end as the whole does."""
    t = (1 << 22) + 4096
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 1, t)).astype(np.float32))
    whole = upsample_linear(x, 2)
    lo, hi = (1 << 22) + 1000, (1 << 22) + 3000
    assert 2 * lo > 1 << 23
    got = upsample_linear(x[..., lo:hi], 2, offset=lo, total=t)
    assert torch.equal(got[..., 2:-2], whole[..., 2 * lo + 2:2 * hi - 2])
    local = upsample_linear(x[..., lo:hi], 2)
    assert not torch.equal(local[..., 2:-2],
                           whole[..., 2 * lo + 2:2 * hi - 2])
    end = upsample_linear(x[..., t - 1000:], 2, offset=t - 1000, total=t)
    assert torch.equal(end[..., 2:], whole[..., 2 * (t - 1000) + 2:])


# ------------------------------------------------------ whole pipelines

def test_whole_file_over_eight_matches_unsharded_and_jax(stages):  # noqa: F811
    """JAX tests/test_pipeline.py:633 on the port: whole_file serving of
    22,050 samples (not a multiple of the grid) with time sharded over
    make_mesh(1, 8), against the port unsharded (1e-5) and against the
    JAX package's sequence-parallel restore on its 1x8 mesh (chain
    bar)."""
    audio = _audio(22050, seed=13)
    got, rate = _port(stages, _cpu_mesh(1, 8), whole_file=True).restore(
        audio, RATE)
    plain, _ = _port(stages, whole_file=True).restore(audio, RATE)
    want, want_rate = _jax(stages, jax_mesh(data_parallel=1,
                                            model_parallel=8),
                           whole_file=True).restore(audio, RATE)
    assert rate == want_rate == 2 * RATE
    assert tuple(got.shape) == np.asarray(want).shape == (2, 44100)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=WHOLE_TOL)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < CHAIN_BAR


@pytest.mark.parametrize("slab", [None, 4])
def test_chunked_two_by_two_matches_unsharded_and_jax(stages,  # noqa: F811
                                                      monkeypatch, slab):
    """Chunks over the 2 data rows and each chunk's time over the 2
    devices of its row: the JAX package's 2x2 mesh and the port
    unsharded, in one program and in slabs of 4 chunks. The LSTM runs
    once a row a program, on the row's first device, over the whole
    chunk."""
    from ml_audio_restoration_torch.ops import lstm as L

    seen = []
    plain_recurrence = L.lstm_recurrence

    def spy(gates, *a):
        seen.append(tuple(gates.shape[:2]))
        return plain_recurrence(gates, *a)

    cfg = dict(CHUNKED) if slab is None else dict(
        CHUNKED, max_chunks_per_program=slab)
    audio = _audio(5000, seed=2)
    want, _ = _jax(stages, jax_mesh(data_parallel=2, model_parallel=2),
                   **cfg).restore(audio, RATE)
    plain, _ = _port(stages, **cfg).restore(audio, RATE)
    monkeypatch.setattr(L, "lstm_recurrence", spy)
    got, _ = _port(stages, _cpu_mesh(2, 2), **cfg).restore(audio, RATE)
    # 6 chunks bucket to 8, 4 a row; or two slabs of 4 chunks, 2 a row
    assert seen == ([(2000, 4)] * 2 if slab is None else [(2000, 2)] * 4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **SHARD_TOL)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < CHAIN_BAR


OPTIONS = {
    "bf16": {"compute_dtype": "bfloat16"},
    "mid_exact": {"stereo_mid_exact": True},
    "source_rate": {"stereo_source_rate": True},
    "sub_chunked": {"stereo_chunk_seconds": 0.05},
    "sub_chunked_source_rate": {"stereo_chunk_seconds": 0.05,
                                "stereo_source_rate": True},
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_every_option_over_one_by_two(stages, option):  # noqa: F811
    """Each serving option, whole-file over a 1x2 mesh, against its
    unsharded twin at the sharded bar."""
    cfg = dict(OPTIONS[option], whole_file=True)
    audio = _audio(3001, seed=4)
    got, _ = _port(stages, _cpu_mesh(1, 2), **cfg).restore(audio, RATE)
    want, _ = _port(stages, **cfg).restore(audio, RATE)
    assert got.shape == want.shape == (2, 6002)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SHARD_TOL)


@pytest.fixture(scope="module")
def packable():
    """Narrow stages the int8 path takes: the denoiser with its three
    encoder levels (the packed forward needs them)."""
    rng = np.random.default_rng(13)
    return {"denoiser": jax_model("denoiser", 0, rng,
                                  features=(8, 16, 32))[1],
            "super_resolution": jax_model("super_resolution", 1, rng,
                                          **SMALL["super_resolution"])[1],
            "stereo_separator": jax_model("stereo_separator", 2, rng,
                                          **SMALL["stereo_separator"])[1]}


@pytest.mark.parametrize("scope", ["packed", "full"])
def test_int8_over_one_by_two_on_one_scales_file(packable, tmp_path, scope):
    """int8 whole-file over a 1x2 mesh with the unsharded restore's scales
    file: no recalibration, the int8 forwards on grid-aligned windows,
    and the unsharded int8 output at the sharded bar (the int8 layers are
    integer sums, so the windows change nothing there)."""
    cfg = dict(whole_file=True, quantize_int8=True, int8_scope=scope)
    audio = _audio(6000, seed=5)
    plain = _port(packable, **cfg)
    want, _ = plain.restore(audio, RATE)
    plain.save_int8_scales(tmp_path / "scales.json")
    f32, _ = _port(packable, whole_file=True).restore(audio, RATE)
    seq = _port(packable, _cpu_mesh(1, 2), **cfg)
    scales = seq.load_int8_scales(tmp_path / "scales.json")
    got, _ = seq.restore(audio, RATE)
    assert seq._int8.scales is scales
    assert float((want - f32).abs().max()) > 1e-4  # int8 really ran
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SHARD_TOL)


@pytest.mark.parametrize("t,cfg", [
    (100, {"whole_file": True}),
    (8, {"whole_file": True}),
    (1, {"chunk_seconds": 0.1, "overlap_seconds": 0.01}),  # one chunk
    (100, dict(CHUNKED))])
def test_files_shorter_than_the_halo(stages, t, cfg):  # noqa: F811
    """Shards shorter than the halo over 8 entries: a 100-sample
    whole-file recording is cut into 8 cores of 4 to 16 samples under a
    halo of several times that, an 8-sample one into 2 cores (fewer
    windows than devices); a 1-sample file rides its zero-padded chunk."""
    audio = _audio(t, seed=t)
    got, _ = _port(stages, _cpu_mesh(1, 8), **cfg).restore(audio, RATE)
    want, _ = _port(stages, **cfg).restore(audio, RATE)
    assert got.shape == want.shape == (2, 2 * t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SHARD_TOL)


def test_restore_many_and_warmup_on_a_model_axis(stages):  # noqa: F811
    """restore_many and warmup take the time-sharded stack: warmup's
    buckets are the data axis's (lcm(4, 2)), and each coalesced member
    equals its unsharded restore."""
    cfg = dict(CHUNKED, max_chunks_per_program=8)
    pipe = _port(stages, _cpu_mesh(2, 2), names=("denoiser",), **cfg)
    assert pipe.warmup(coalesce=2)["buckets"] == [4, 8]
    audios = [_audio(t, seed=t) for t in (2000, 3500, 1000)]
    got = pipe.restore_many(audios, RATE)
    plain = _port(stages, names=("denoiser",), **cfg)
    for a, (out, rate) in zip(audios, got):
        want, _ = plain.restore(a, RATE)
        np.testing.assert_allclose(out.numpy(), want.numpy(), **SHARD_TOL)


def test_model_axis_builds_per_device_stacks(stages, monkeypatch):  # noqa: F811
    """Under a 2x2 mesh the stack builds one set of stages per distinct
    device (one: the CPU repeated) and runs every window through it: the
    window count is the cores' (2 a row, 2 rows)."""
    calls = []
    build = restore_mod.RestorationPipeline._device_stages

    def counting(self, device, *a):
        calls.append(device)
        return build(self, device, *a)

    monkeypatch.setattr(restore_mod.RestorationPipeline, "_device_stages",
                        counting)
    pipe = _port(stages, _cpu_mesh(2, 2), whole_file=True)
    fronts = []
    front = restore_mod._Stages.front

    def spy(self, x, **kw):
        fronts.append((x.shape[-1], kw["offset"]))
        return front(self, x, **kw)

    monkeypatch.setattr(restore_mod._Stages, "front", spy)
    pipe.restore(_audio(4000, seed=9), RATE)
    assert calls == [torch.device("cpu")]
    plan = sequence.plan(*pipe._models())
    assert fronts == [(2000 + plan.front_halo, 0),
                      (2000 + plan.front_halo, 2000 - plan.front_halo)]


# --------------------------------------------------- streams and server

@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_streams_on_a_model_axis_match_unsharded(stages, data,  # noqa: F811
                                                 model):
    """StreamingRestorer takes a mesh with a 'model' axis: the streams
    split over its data rows, each row's first device running them (JAX
    shards the stream batch over 'data' and replicates it over 'model');
    the output is the unsharded restorer's."""
    models = _models(stages)
    plain = StreamingRestorer(**models, batch=4, device="cpu")
    mesh = _cpu_mesh(data, model)
    sharded = StreamingRestorer(**models, batch=4, mesh=mesh, device="cpu")
    assert [hi - lo for _, lo, hi in sharded._shards] == [4 // data] * data
    blocks = (np.random.default_rng(10).normal(size=(2, 4, 1500))
              * 0.1).astype(np.float32)
    for b in blocks:
        want, got = plain.feed(b), sharded.feed(b)
        assert float(np.abs(got - want).max()) <= STREAM_TOL
    assert float(np.abs(sharded.flush() - plain.flush()).max()) <= STREAM_TOL


def test_server_names_every_mesh_device_and_serves_sequence_parallel():
    """The daemon over a 2x2 mesh pipeline: /healthz lists all four
    entries (the one route that names devices, as in the JAX package), and
    a request is answered as the unsharded pipeline answers it."""
    import json

    from test_torch_server_http import (SR, _get, _pipe, _post, _server,
                                        _want)
    from ml_audio_restoration_torch.audio import encode_wav

    dn = jax_model("denoiser", 3, np.random.default_rng(3),
                   features=(8, 16, 32))[1]
    sig = _audio(int(0.6 * SR), seed=6)[0]
    pipe = _pipe(dn)
    pipe.mesh = _cpu_mesh(2, 2)
    with _server(pipe) as srv:
        health = json.load(_get(srv, "/healthz"))
        got, rate = _post(srv, encode_wav(sig[:, None], SR,
                                          subtype="FLOAT"), subtype="FLOAT")
    assert health["devices"] == ["cpu"] * 4
    assert rate == SR
    np.testing.assert_allclose(got, _want(_pipe(dn), sig), **SHARD_TOL)

