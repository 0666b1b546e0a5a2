"""The port's serving options against the JAX package's: bf16 compute,
sub-chunked / mid-exact / source-rate stereo, coalesced `restore_many`,
`restore_directory`, `warmup` and the CLI's restore options.

Both packages get the same weights (the narrow widths of
test_torch_pipeline.SMALL, randomized BN) and the same seeded numpy audio.

Bars:
- f32: 1e-3 max abs on the restored waveform, the chain bar (observed
  ~1e-7: float summation order);
- bf16: the JAX side runs its TPU serving route, the Pallas recurrence
  (in interpret mode) with f32 state, which is what the port's K1 does.
  Each bf16 computation rounds the same f32 function, so the bar is twice
  the deviation of JAX's own bf16 output from its f32 output on the same
  inputs (two roundings, each within D of the f32 function, lie within 2D
  of each other). The port's bf16 output is a bf16 tensor cast to f32, so
  the deviations are a few bf16 steps (~5e-4 at a peak of 0.1): observed
  ratios (port vs JAX bf16) / (JAX bf16 vs f32) of 0.6 to 1.6;
- restore_many against restore on the same pipeline: 1e-6 (the JAX test's
  bar; the convolutions may sum in another order at another batch size).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_audio_restoration_tpu.ops.pallas.lstm as pallas_lstm
from ml_audio_restoration_tpu.compat.torch_saver import EXPORTERS
from ml_audio_restoration_tpu.config import PipelineConfig as JaxConfig
from ml_audio_restoration_tpu.pipeline import RestorationPipeline as JaxPipe
from ml_audio_restoration_tpu.pipeline.restore import (
    stereo_sub_cfg as jax_sub_cfg)
from ml_audio_restoration_torch import cli
from ml_audio_restoration_torch.audio import load_audio, save_audio, wav_info
from ml_audio_restoration_torch.config import PipelineConfig, load_config
from ml_audio_restoration_torch.models import cast_model
from ml_audio_restoration_torch.pipeline import RestorationPipeline
from ml_audio_restoration_torch.pipeline.restore import stereo_sub_cfg
from test_torch_models import jax_model, port_model
from test_torch_pipeline import CHAIN_BAR, CHUNKED, RATE, SMALL

MANY_BAR = 1e-6
SUB = 250 / RATE  # stereo windows of 500 samples after SR at CHUNKED
MANY = {"sample_rate": 8000, "chunk_seconds": 0.25, "overlap_seconds": 0.05}


@pytest.fixture(scope="module")
def stages():
    rng = np.random.default_rng(5)
    return {name: jax_model(name, i, rng, **cfg)[1]
            for i, (name, cfg) in enumerate(SMALL.items())}


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's TPU serving recurrence, run on the CPU: the Pallas kernel in
    interpret mode behind lstm_impl="pallas" (ops/lstm.py imports the
    wrapper at call time)."""
    monkeypatch.setattr(pallas_lstm, "lstm_recurrence_pallas",
                        functools.partial(pallas_lstm.lstm_recurrence_pallas,
                                          interpret=True))


def _audio(t, seed=1, channels=1):
    return (np.random.default_rng(seed).normal(size=(channels, t))
            * 0.2).astype(np.float32)


def _jax_pipe(stages, names=tuple(SMALL), **cfg):
    kw = {"denoiser": "denoiser", "super_resolution": "super_resolution",
          "stereo_separator": "stereo"}
    return JaxPipe(**{kw[n]: stages[n] for n in names},
                   config=JaxConfig(**cfg))


def _port_pipe(stages, names=tuple(SMALL), **cfg):
    models = [port_model(n, *stages[n]) if n in names else None
              for n in SMALL]
    return RestorationPipeline(*models, config=PipelineConfig(**cfg),
                               device="cpu")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _dev(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


@pytest.mark.parametrize("seconds,rate", [
    (0.25, 22050), (0.25, 44100), (0.1, 8000), (1000 / 22050, 22050),
    (0.013, 16000), (2.0, 22050)])
def test_stereo_sub_cfg_matches_jax(seconds, rate):
    """The same windows, exactly, over stage lengths and rate factors,
    including a window at or past the stage length (None) and a tiny one
    (the floor of 4)."""
    for overlap in (0.0, 0.05, 0.02):
        for f in (1, 2, 4):
            for stage_len in (4, 1000, 11025, 88200, 10 ** 6):
                args = dict(stage_len=stage_len, f=f, sample_rate=rate)
                port = PipelineConfig(stereo_chunk_seconds=seconds,
                                      overlap_seconds=overlap)
                ref = JaxConfig(stereo_chunk_seconds=seconds,
                                overlap_seconds=overlap)
                assert stereo_sub_cfg(port, **args) == jax_sub_cfg(ref,
                                                                   **args)
    assert stereo_sub_cfg(PipelineConfig(), 88200, 2) is None


@pytest.mark.parametrize("extra", [
    {"stereo_chunk_seconds": SUB},
    {"stereo_mid_exact": True},
    {"stereo_source_rate": True},
    {"stereo_source_rate": True, "stereo_chunk_seconds": SUB},
    {"stereo_mid_exact": True, "stereo_chunk_seconds": SUB},
    {"stereo_chunk_seconds": SUB, "enable_super_resolution": False}])
def test_stereo_options_match_jax(stages, extra):
    audio = _audio(5000)
    cfg = dict(CHUNKED, **extra)
    want, want_rate = _jax_pipe(stages, **cfg).restore(audio, RATE)
    got, rate = _port_pipe(stages, **cfg).restore(audio, RATE)
    assert rate == want_rate
    assert tuple(got.shape) == np.asarray(want).shape
    assert _dev(got, want) < CHAIN_BAR


def test_stereo_window_covering_the_chunk_is_plain(stages):
    """A window at least as long as the stage input changes nothing: the
    same bits as the full-window path."""
    audio = _audio(5000)
    plain, _ = _port_pipe(stages, **CHUNKED).restore(audio, RATE)
    same, _ = _port_pipe(stages, **CHUNKED,
                         stereo_chunk_seconds=4000 / RATE).restore(audio,
                                                                   RATE)
    assert torch.equal(plain, same)


def test_mid_exact_keeps_the_mid(stages):
    """Stereo only: the output's mean is the input, and the side is the
    raw mode's (JAX tests/test_pipeline.py::
    test_stereo_mid_exact_preserves_mono)."""
    audio = _audio(22050, seed=2)
    names = ("stereo_separator",)
    cfg = {"chunk_seconds": 4000 / RATE, "overlap_seconds": 200 / RATE}
    raw, _ = _port_pipe(stages, names, **cfg).restore(audio, RATE)
    outs = [_port_pipe(stages, names, stereo_mid_exact=True, **cfg,
                       **extra).restore(audio, RATE)[0]
            for extra in ({}, {"stereo_chunk_seconds": 1000 / RATE})]
    for got in outs:
        np.testing.assert_allclose(got.mean(0).numpy(), audio[0], atol=1e-6)
    np.testing.assert_allclose(((outs[0][0] - outs[0][1]) / 2).numpy(),
                               ((raw[0] - raw[1]) / 2).numpy(), atol=1e-6)


def test_source_rate_mid_is_the_sr_output(stages):
    """The output's mean is the denoise + SR output, and without SR the
    option is mid-exact (JAX test_stereo_source_rate_upmix)."""
    audio = _audio(8000, seed=3)
    mono, _ = _port_pipe(stages, ("denoiser", "super_resolution"),
                         **CHUNKED).restore(audio, RATE)
    got, rate = _port_pipe(stages, stereo_source_rate=True,
                           **CHUNKED).restore(audio, RATE)
    assert rate == 2 * RATE and tuple(got.shape) == (2, 16000)
    np.testing.assert_allclose(got.mean(0).numpy(), mono[0].numpy(),
                               atol=1e-6)
    assert float((got[0] - got[1]).abs().max()) > 1e-4
    names = ("stereo_separator",)
    a, _ = _port_pipe(stages, names, stereo_source_rate=True,
                      **CHUNKED).restore(audio, RATE)
    b, _ = _port_pipe(stages, names, stereo_mid_exact=True,
                      **CHUNKED).restore(audio, RATE)
    assert torch.equal(a, b)


@pytest.mark.parametrize("extra", [
    {}, {"stereo_chunk_seconds": SUB}, {"stereo_source_rate": True},
    {"stereo_mid_exact": True, "stereo_chunk_seconds": SUB}])
def test_bf16_restore_matches_jax(stages, pallas_interpret, extra):
    """bf16 compute against JAX's bf16 serving route (see the module
    docstring for the bar). 6 chunks bucket to 8, so JAX's recurrence runs
    the Pallas kernel (it takes the scan below an effective batch of 8)."""
    audio = _audio(5000)
    cfg = dict(CHUNKED, **extra)
    want32, _ = _jax_pipe(stages, **cfg).restore(audio, RATE)
    want, _ = _jax_pipe(stages, compute_dtype="bfloat16", lstm_impl="pallas",
                        **cfg).restore(audio, RATE)
    port = _port_pipe(stages, compute_dtype="bfloat16", **cfg)
    got, _ = port.restore(audio, RATE)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == np.asarray(want).shape
    assert all(p.dtype == torch.bfloat16 for m in port._models()
               for p in m.state_dict().values() if p.is_floating_point())
    jax_dev = _dev(want, want32)
    assert 0.0 < _dev(got, want) <= 2 * jax_dev


@pytest.mark.parametrize("cfg,t", [({"whole_file": True}, 5000),
                                   (CHUNKED, 2500)])
def test_bf16_small_batch_restore_matches_jax_scan(stages, cfg, t):
    """Below an effective LSTM batch of 8 JAX's apply_stereo takes the scan
    on the TPU too (pipeline/restore.py:132-140), and the scan keeps h and
    c in bf16 where K1 keeps them in f32: whole_file (one row) and a
    recording of 3 chunks (bucket 4). The port against that route, at
    twice JAX's own bf16-vs-f32 deviation (the module docstring's bar);
    observed ratios 0.58 and 0.58."""
    audio = _audio(t)
    want32, _ = _jax_pipe(stages, **cfg).restore(audio, RATE)
    want, _ = _jax_pipe(stages, compute_dtype="bfloat16",
                        **cfg).restore(audio, RATE)
    got, _ = _port_pipe(stages, compute_dtype="bfloat16", **cfg).restore(
        audio, RATE)
    assert tuple(got.shape) == np.asarray(want).shape
    assert 0.0 < _dev(got, want) <= 2 * _dev(want, want32)


@pytest.mark.parametrize("name", list(SMALL))
def test_bf16_models_match_jax(pallas_interpret, name):
    """Each model in bf16: `cast_model` rounds every weight and BN
    statistic to bf16 and the eval forward folds BN from them in f32, then
    casts, as the JAX fold does. Observed at these widths, port vs JAX
    bf16 (JAX bf16 vs f32): denoiser 6.1e-4 (6.7e-4), SR 7.8e-3 (5.1e-3),
    stereo 9.8e-4 (1.2e-3); the bar is twice JAX's own bf16 deviation."""
    rng = np.random.default_rng(0)
    mod, (params, state) = jax_model(name, 0, rng, **SMALL[name])
    x = (rng.normal(size=(8, 1, 515)) * 0.3).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 1))
    bf16 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)
    kw = {"lstm_impl": "pallas"} if name == "stereo_separator" else {}
    want32 = np.asarray(mod.apply(params, state, xj)[0])
    want = np.asarray(mod.apply(bf16(params), bf16(state),
                                xj.astype(jnp.bfloat16), **kw)[0]
                      .astype(jnp.float32))
    model = port_model(name, params, state)
    with torch.inference_mode():
        got = cast_model(model, torch.bfloat16)(
            torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.float32  # a copy
    got = got.float().numpy().transpose(0, 2, 1)
    assert 0.0 < _dev(got, want) <= 2 * _dev(want, want32)


def test_restore_many_matches_individual(stages):
    """Mixed chunk counts and a repeat, coalesced into one batch
    (JAX test_restore_many_matches_individual)."""
    pipe = _port_pipe(stages, **MANY)
    audios = [_audio(t, seed=t) for t in (1500, 4100, 9000, 2000, 2000)]
    got = pipe.restore_many(audios)
    assert len(got) == len(audios)
    for a, (out, rate) in zip(audios, got):
        want, want_rate = pipe.restore(a)
        assert rate == want_rate and out.shape == want.shape
        assert _dev(out, want) <= MANY_BAR


def test_restore_many_takes_what_restore_takes(stages):
    """A stereo recording (mixed down), a 1-D one and a tensor, coalesced:
    each equals restore of the same input."""
    pipe = _port_pipe(stages, **MANY)
    audios = [_audio(3000, seed=1, channels=2), _audio(4100, seed=3)[0],
              torch.from_numpy(_audio(2500, seed=4))]
    for a, (out, _) in zip(audios, pipe.restore_many(audios)):
        want = pipe.restore(a)[0]
        assert out.shape == want.shape and _dev(out, want) <= MANY_BAR


def test_restore_many_group_split_and_solo(stages):
    """Groups split at max_chunks_per_program, a recording whose bucket
    exceeds it takes restore's slabs; restore_many([]) and a single
    recording (JAX test_restore_many_group_split_and_solo)."""
    pipe = _port_pipe(stages, ("denoiser",), max_chunks_per_program=8,
                      **MANY)
    # chunk 2000, hop 1600: 3, 4, 15 (solo: bucket 16 > 8) and 1 chunks
    audios = [_audio(t, seed=t) for t in (4000, 6000, 24000, 2000)]
    got = pipe.restore_many(audios)
    for a, (out, _) in zip(audios, got):
        assert _dev(out, pipe.restore(a)[0]) <= MANY_BAR
    assert pipe.restore_many([]) == []
    one = pipe.restore_many([audios[0]])
    assert torch.equal(one[0][0], pipe.restore(audios[0])[0])


@pytest.mark.parametrize("lens,cap", [
    ((98000, 3600), 64),   # [61, 2] chunks at 64: bucket coverage 68
    ((8400, 3600), 8)])    # [5, 2] chunks at 8: coverage 12
def test_restore_many_caps_the_bucketed_coverage(stages, monkeypatch, lens,
                                                 cap):
    """A group such as [61, 2] at max_chunks_per_program=64 needs 61 + 4
    rows to cover the second recording's bucketed slice, which busts the
    cap, so it splits (JAX test_restore_many_group_cap_counts_bucketed_
    coverage); the outputs still equal individual restores."""
    pipe = _port_pipe(stages, ("denoiser",), max_chunks_per_program=cap,
                      **MANY)
    sizes = []
    build = pipe._stage_stack

    def counting(*args, **kwargs):
        stack = build(*args, **kwargs)

        def run(chunks):
            sizes.append(chunks.shape[0])
            return stack(chunks)
        return run

    monkeypatch.setattr(pipe, "_stage_stack", counting)
    audios = [_audio(t, seed=t) for t in lens]
    got = pipe.restore_many(audios)
    assert sizes and max(sizes) <= cap
    for a, (out, _) in zip(audios, got):
        assert _dev(out, pipe.restore(a)[0]) <= MANY_BAR


def test_restore_many_with_every_option(stages):
    """Coalescing under bf16 + sub-chunked + mid-exact still equals the
    single restores (JAX test_restore_many_full_config_combos)."""
    pipe = _port_pipe(stages, compute_dtype="bfloat16",
                      stereo_chunk_seconds=0.1, stereo_mid_exact=True,
                      **MANY)
    audios = [_audio(t, seed=t) for t in (3000, 5200)]
    for a, (out, _) in zip(audios, pipe.restore_many(audios)):
        assert _dev(out, pipe.restore(a)[0]) <= MANY_BAR


@pytest.mark.parametrize("coalesce", [1, 4])
def test_restore_directory_equals_restore_file(stages, tmp_path, coalesce):
    """The same bytes as one restore_file a file (JAX
    test_restore_directory_matches_restore_file)."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i in range(3):
        save_audio(in_dir / f"r{i}.wav", _audio(22050 + 800 * i, seed=i) / 2,
                   RATE)
    pipe = _port_pipe(stages, chunk_seconds=0.5, overlap_seconds=0.02)
    results = pipe.restore_directory(in_dir, tmp_path / "batch",
                                     coalesce=coalesce)
    assert [p.name for p, _ in results] == [f"r{i}_restored.wav"
                                            for i in range(3)]
    assert all(rate == 2 * RATE for _, rate in results)
    for i in range(3):
        seq = tmp_path / f"seq{i}.wav"
        pipe.restore_file(in_dir / f"r{i}.wav", seq)
        assert (tmp_path / "batch" / f"r{i}_restored.wav").read_bytes() \
            == seq.read_bytes()
    assert pipe.restore_directory(tmp_path / "batch" / "none", tmp_path) \
        == []


def test_warmup_runs_every_bucket(stages):
    pipe = _port_pipe(stages, max_chunks_per_program=10, **MANY)
    got = pipe.warmup(coalesce=2)
    assert got["buckets"] == [4, 8, 10]
    assert got["programs"] == 6 and got["seconds"] > 0
    assert pipe.warmup()["programs"] == 0  # every shape already ran
    whole = _port_pipe(stages, whole_file=True)
    with pytest.warns(UserWarning, match="whole_file"):
        assert whole.warmup() == {"programs": 0, "seconds": 0.0,
                                  "buckets": []}


def test_config_validation():
    """int8 builds (ops/quant.py) and fast_serve_int8.yaml restores int8 on
    the CPU; lstm_impl takes None, "scan" and "pallas" and rejects the
    rest, as the JAX pipeline does."""
    assert PipelineConfig(quantize_int8=True).quantize_int8
    with pytest.raises(ValueError, match="int8_scope"):
        PipelineConfig(quantize_int8=True, int8_scope="some")
    for ok in (None, "scan", "pallas"):
        PipelineConfig(lstm_impl=ok)
    for bad in ("pallas_train", "palas", "cudnn"):
        with pytest.raises(ValueError, match="lstm_impl"):
            PipelineConfig(lstm_impl=bad)
    with pytest.raises(ValueError, match="compute_dtype"):
        PipelineConfig(compute_dtype="float16")
    # a YAML overlay sets fields after construction
    cfg = load_config("config/fast_serve_int8.yaml").pipeline
    assert (cfg.quantize_int8, cfg.compute_dtype,
            cfg.stereo_chunk_seconds) == (True, "bfloat16", 0.25)
    cfg.chunk_seconds, cfg.overlap_seconds = 2000 / RATE, 200 / RATE
    rng = np.random.default_rng(8)
    packable = {"denoiser": {"features": (8, 16, 32)},
                "super_resolution": {"base_channels": 8,
                                     "num_residual_blocks": 2},
                "stereo_separator": {"base_channels": 8, "lstm_hidden": 16}}
    pipe = RestorationPipeline(
        *(port_model(n, *jax_model(n, i, rng, **c)[1])
          for i, (n, c) in enumerate(packable.items())),
        config=cfg, device="cpu")
    out, rate = pipe.restore(_audio(4000))
    assert set(pipe._int8.scales) == {"denoiser", "super_resolution",
                                      "stereo"}
    assert out.shape == (2, 8000) and rate == 2 * RATE
    assert bool(torch.isfinite(out).all())
    fast = load_config("config/fast_serve.yaml").pipeline
    assert (fast.compute_dtype, fast.stereo_chunk_seconds) == ("bfloat16",
                                                                0.25)
    RestorationPipeline(config=fast, device="cpu")


def _checkpoints(stages, tmp_path):
    paths = {}
    for name in SMALL:
        paths[name] = tmp_path / f"{name}.pth"
        torch.save({"model_state_dict": EXPORTERS[name](*stages[name])},
                   paths[name])
    return ["--denoiser", str(paths["denoiser"]),
            "--super-res", str(paths["super_resolution"]),
            "--stereo", str(paths["stereo_separator"])]


def test_cli_restore_directory_with_config(stages, tmp_path, capsys):
    """`restore <dir> <dir> --config config/fast_serve.yaml`: every file
    restored under the YAML's bf16 + 0.25 s stereo windows, equal to the
    pipeline's restore_file under the same config."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i, t in enumerate((3000, 4500)):
        save_audio(in_dir / f"take{i}.wav", _audio(t, seed=i) / 2, RATE)
    rc = cli.main(["restore", str(in_dir), str(tmp_path / "out"),
                   "--config", "config/fast_serve.yaml",
                   "--chunk-seconds", str(1000 / RATE),
                   "--overlap-seconds", str(100 / RATE),
                   "--coalesce", "2", "--device", "cpu"]
                  + _checkpoints(stages, tmp_path))
    assert rc == 0
    assert "2 files restored" in capsys.readouterr().out
    cfg = dataclasses.replace(
        load_config("config/fast_serve.yaml").pipeline,
        chunk_seconds=1000 / RATE, overlap_seconds=100 / RATE)
    pipe = RestorationPipeline(*(port_model(n, *stages[n]) for n in SMALL),
                               config=cfg, device="cpu")
    for i, t in enumerate((3000, 4500)):
        info = wav_info(tmp_path / "out" / f"take{i}_restored.wav")
        assert (info.channels, info.sample_rate, info.frames) == (
            2, 2 * RATE, 2 * t)
        pipe.restore_file(in_dir / f"take{i}.wav", tmp_path / "want.wav")
        got, _ = load_audio(tmp_path / "out" / f"take{i}_restored.wav",
                            None, mono=False)
        want, _ = load_audio(tmp_path / "want.wav", None, mono=False)
        assert float(np.abs(got - want).max()) <= 2 / 32768


@pytest.mark.parametrize("flags,field", [
    (["--dtype", "bfloat16"], ("compute_dtype", "bfloat16")),
    (["--stereo-chunk-seconds", str(SUB)], ("stereo_chunk_seconds", SUB)),
    (["--stereo-mid-exact"], ("stereo_mid_exact", True)),
    (["--stereo-source-rate"], ("stereo_source_rate", True))])
def test_cli_restore_options(stages, tmp_path, monkeypatch, flags, field):
    """Each option flag reaches the pipeline's config and the file comes
    out as the pipeline restores it."""
    seen = []
    restore = RestorationPipeline.restore

    def spy(self, audio, sample_rate=None):
        seen.append(self.config)
        return restore(self, audio, sample_rate)

    monkeypatch.setattr(RestorationPipeline, "restore", spy)
    src, dst = tmp_path / "in.wav", tmp_path / "out.wav"
    save_audio(src, _audio(3000) / 2, RATE)
    rc = cli.main(["restore", str(src), str(dst), "--chunk-seconds",
                   str(1000 / RATE), "--overlap-seconds", str(100 / RATE),
                   "--device", "cpu"] + flags
                  + _checkpoints(stages, tmp_path))
    assert rc == 0 and len(seen) == 1
    assert getattr(seen[0], field[0]) == field[1]
    assert wav_info(dst).frames == 6000
