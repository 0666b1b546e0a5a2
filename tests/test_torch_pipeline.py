"""The port's RestorationPipeline against the JAX package's.

Both pipelines get the same weights (narrow widths, randomized BN) and the
same numpy audio. The bar is 1e-3 max abs on the restored waveform, the
chain bar the JAX package holds against upstream; the JAX side runs its
default packed conv layout, equal to the plain path up to reassociation.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.compat.torch_saver import EXPORTERS
from ml_audio_restoration_tpu.config import PipelineConfig as JaxConfig
from ml_audio_restoration_tpu.pipeline import RestorationPipeline as JaxPipe
from ml_audio_restoration_torch import cli
from ml_audio_restoration_torch.audio import load_audio, save_audio, wav_info
from ml_audio_restoration_torch.config import PipelineConfig
from ml_audio_restoration_torch.parallel import make_mesh
from ml_audio_restoration_torch.pipeline import (
    RestorationPipeline, StreamingRestorer, restore_audio)
from ml_audio_restoration_torch.pipeline.restore import slab_plan
from test_torch_models import jax_model, port_model

CHAIN_BAR = 1e-3
RATE = 22050
SMALL = {"denoiser": {"features": (8, 16)},
         "super_resolution": {"base_channels": 8, "num_residual_blocks": 2},
         "stereo_separator": {"base_channels": 8, "lstm_hidden": 16}}
CHUNKED = {"chunk_seconds": 1000 / RATE, "overlap_seconds": 100 / RATE}


@pytest.fixture(scope="module")
def stages():
    rng = np.random.default_rng(5)
    return {name: jax_model(name, i, rng, **cfg)[1]
            for i, (name, cfg) in enumerate(SMALL.items())}


def _pipes(stages, device="cpu", **cfg):
    jax_pipe = JaxPipe(denoiser=stages["denoiser"],
                       super_resolution=stages["super_resolution"],
                       stereo=stages["stereo_separator"],
                       config=JaxConfig(**cfg))
    port = RestorationPipeline(
        *(port_model(name, *stages[name]) for name in SMALL),
        config=PipelineConfig(**cfg), device=device)
    return jax_pipe, port


@pytest.mark.parametrize("cfg,t", [
    (CHUNKED, 5000),                                   # 6 chunks -> bucket 8
    (dict(CHUNKED, max_chunks_per_program=4), 5000),   # two slabs
    ({"whole_file": True}, 3001),
    (dict(CHUNKED, enable_super_resolution=False), 4321),
    # 18 chunks at 16: two balanced slabs of 12 (24 rows; 32 at the cap)
    (dict(CHUNKED, max_chunks_per_program=16), 16300)])
def test_restore_matches_jax(stages, cfg, t):
    audio = (np.random.default_rng(t).normal(size=(1, t)) * 0.2).astype(
        np.float32)
    jax_pipe, port = _pipes(stages, **cfg)
    want, want_rate = jax_pipe.restore(audio, RATE)
    got, rate = port.restore(audio, RATE)
    f = 1 if cfg.get("enable_super_resolution") is False else 2
    assert rate == want_rate == RATE * f
    assert tuple(got.shape) == (2, t * f) == np.asarray(want).shape
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < CHAIN_BAR


@pytest.mark.parametrize("cap", [4, 8, 16, 64])
@pytest.mark.parametrize("gran", [4, 8, 12])
def test_slab_plan_balances_slabs(cap, gran):
    """The fewest slabs the cap allows, all of one size at most the cap,
    none empty, a multiple of the granularity where the cap is one, and
    under a granularity of padding a slab."""
    for n_real in range(1, 301):
        num_slabs, s = slab_plan(n_real, cap, gran)
        assert s <= cap and num_slabs == -(-n_real // cap)
        assert (num_slabs - 1) * s < n_real <= num_slabs * s
        assert cap % gran or s % gran == 0
        assert num_slabs * s - n_real < num_slabs * gran


def test_stereo_input_is_mixed_to_mono(stages):
    audio = (np.random.default_rng(1).normal(size=(2, 3000)) * 0.2).astype(
        np.float32)
    _, port = _pipes(stages, **CHUNKED)
    got, _ = port.restore(audio, RATE)
    mono, _ = port.restore(audio.mean(axis=0, keepdims=True), RATE)
    assert torch.equal(got, mono)


def test_restore_file_roundtrip(stages, tmp_path):
    t = 4096
    sig = (0.4 * np.sin(2 * np.pi * 440 * np.arange(t) / RATE)).astype(
        np.float32)[None]
    src = tmp_path / "in.wav"
    save_audio(src, sig, RATE)
    jax_pipe, port = _pipes(stages, whole_file=True)
    _, out_rate = port.restore_file(src, tmp_path / "out.wav")
    jax_pipe.restore_file(src, tmp_path / "jax.wav")
    info = wav_info(tmp_path / "out.wav")
    assert out_rate == info.sample_rate == 2 * RATE
    assert info.channels == 2 and info.frames == 2 * t
    got, _ = load_audio(tmp_path / "out.wav", None, mono=False)
    want, _ = load_audio(tmp_path / "jax.wav", None, mono=False)
    # PCM_16 on both sides: one quantization step apart at most, plus the
    # chain bar scaled by the output normalization
    assert float(np.max(np.abs(got - want))) < CHAIN_BAR + 2 / 32768


def test_cuda_default_raises_without_a_card(stages):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RestorationPipeline()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_audio("in.wav", "out.wav")
    RestorationPipeline(device="cpu")


def _int8_pipeline():
    cfg = PipelineConfig()
    cfg.quantize_int8 = True  # as a YAML overlay sets it
    return RestorationPipeline(config=cfg, device="cpu")


@pytest.mark.parametrize("make,error", [
    (lambda: StreamingRestorer(batch=3, mesh=make_mesh(
        2, devices=["cpu"] * 2), device="cpu"), ValueError),
    (lambda: RestorationPipeline(config=dataclasses.replace(
        PipelineConfig(), lstm_impl="pallas_train"), device="cpu"),
     ValueError),
    (lambda: StreamingRestorer(lstm_impl="pallas_train", device="cpu"),
     ValueError)])
def test_unported_options_raise(make, error):
    """A stream batch that does not divide evenly over the mesh raises (JAX
    tests/test_streaming.py:250); the training recurrence is no serving
    route."""
    with pytest.raises(error):
        make()


@pytest.mark.parametrize("make,int8,scales", [
    (_int8_pipeline, "config", False),
    (lambda: RestorationPipeline(config=PipelineConfig(quantize_int8=True),
                                 device="cpu"), "config", False),
    (lambda: StreamingRestorer(quantize_int8=True, device="cpu"),
     "quantize_int8", False),
    (lambda: StreamingRestorer(int8_scales={}, quantize_int8=True,
                               device="cpu"), "quantize_int8", True)])
def test_int8_options_build(make, int8, scales):
    """int8 serving is ported (ops/quant.py): the constructions that raised
    before now build an int8 pipeline or restorer (scales preloaded where
    given)."""
    obj = make()
    on = (obj.config.quantize_int8 if int8 == "config"
          else obj.quantize_int8)
    assert on and (obj._int8.scales is not None) == scales


def test_cli_restore_on_cpu(stages, tmp_path):
    paths = {}
    for name in SMALL:
        paths[name] = tmp_path / f"{name}.pth"
        torch.save({"model_state_dict": EXPORTERS[name](*stages[name])},
                   paths[name])
    src, dst = tmp_path / "in.wav", tmp_path / "out.wav"
    save_audio(src, (np.random.default_rng(2).normal(size=(1, 3000)) * 0.1)
               .astype(np.float32), RATE)
    rc = cli.main(["restore", str(src), str(dst),
                   "--denoiser", str(paths["denoiser"]),
                   "--super-res", str(paths["super_resolution"]),
                   "--stereo", str(paths["stereo_separator"]),
                   "--chunk-seconds", str(1000 / RATE),
                   "--overlap-seconds", str(100 / RATE), "--device", "cpu"])
    assert rc == 0
    info = wav_info(dst)
    assert (info.channels, info.sample_rate, info.frames) == (2, 2 * RATE,
                                                              6000)
