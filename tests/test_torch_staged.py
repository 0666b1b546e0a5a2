"""The port's StagedRestorationPipeline (one model stage a device) against
its RestorationPipeline and against the JAX package's staged pipeline on
its virtual CPU devices (tests/conftest.py): the counterparts of JAX
tests/test_pipeline.py:332, :346, :462, :605 and :720.

The CPU is one torch device, so the port's stages all sit on it here; the
stage hops are then no-ops, and the card run (chip_smoke.py `serve_mesh`)
holds three stages on repeated card entries bit for bit against restore.

Bars: staged against restore, 2e-6 (the JAX tests'); the port's staged
against the JAX package's, CHAIN_BAR (1e-3).
"""
import dataclasses

import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.config import PipelineConfig as JaxConfig
from ml_audio_restoration_tpu.pipeline import (
    StagedRestorationPipeline as JaxStaged)
from ml_audio_restoration_torch.config import PipelineConfig
from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                 StagedRestorationPipeline)
from ml_audio_restoration_torch.pipeline import restore as restore_mod
from test_torch_models import port_model
from test_torch_pipeline import CHAIN_BAR, CHUNKED, RATE, SMALL
from test_torch_serving import stages  # noqa: F401

STAGED_TOL = 2e-6
CPU = torch.device("cpu")
KW = {"denoiser": "denoiser", "super_resolution": "super_resolution",
      "stereo_separator": "stereo"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    suite's other workers, each op's thread pool otherwise contends for
    the cores (test_torch_quant.py's fixture). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(stages):  # noqa: F811
    return {KW[n]: port_model(n, *stages[n]) for n in SMALL}


def _pair(stages, devices=("cpu",) * 3, **cfg):  # noqa: F811
    """(RestorationPipeline, StagedRestorationPipeline) on one config."""
    config = PipelineConfig(**cfg)
    plain = RestorationPipeline(**_models(stages), config=config,
                                device="cpu")
    staged = StagedRestorationPipeline(**_models(stages), config=config,
                                       devices=list(devices))
    return plain, staged


def _audio(t, seed):
    return (np.random.default_rng(seed).normal(size=(1, t)) * 0.2).astype(
        np.float32)


def _close(got, want):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= STAGED_TOL


def test_staged_matches_restore_and_jax(stages):  # noqa: F811
    """One slab: the stages over three (repeated) devices against restore,
    and against the JAX package's stages on three virtual devices."""
    audio = _audio(5000, seed=1)
    plain, staged = _pair(stages, **CHUNKED)
    got, rate = staged.restore(audio, RATE)
    want, want_rate = plain.restore(audio, RATE)
    assert rate == want_rate == 2 * RATE
    _close(got, want)
    jax_staged = JaxStaged(**{KW[n]: stages[n] for n in SMALL},
                           config=JaxConfig(**CHUNKED))
    assert len(set(jax_staged.placement.values())) == 3
    jax_out, _ = jax_staged.restore(audio, RATE)
    assert float(np.abs(got.numpy() - np.asarray(jax_out)).max()) < CHAIN_BAR


def test_staged_pipeline_matches_single_device(stages):  # noqa: F811
    """JAX tests/test_pipeline.py:462: slabs streamed through the stages
    (here two slabs of 4 chunks) equal the single-device pipeline, each
    stage resident on its device; with two devices the stages wrap
    round-robin."""
    cfg = dict(CHUNKED, max_chunks_per_program=4)
    t = np.arange(5000) / RATE
    audio = (0.3 * np.sin(2 * np.pi * 347 * t)
             + 0.02 * np.random.default_rng(3).normal(size=t.shape)
             ).astype(np.float32)[None]
    plain, staged = _pair(stages, **cfg)
    got, rate = staged.restore(audio, RATE)
    want, want_rate = plain.restore(audio, RATE)
    assert rate == want_rate
    _close(got, want)
    assert list(staged.placement) == ["denoiser", "super_resolution",
                                      "stereo"]
    for name, dev in staged.placement.items():
        assert {p.device for p in staged.stages[name].parameters()} == {dev}
    two = StagedRestorationPipeline(
        **_models(stages), config=PipelineConfig(**cfg),
        devices=["cpu", torch.device("cpu")])
    assert list(two.placement.values()) == [CPU] * 3
    assert (two.upscale_factor, two.out_channels) == (2, 2)


def test_staged_rejects_forked_dataflow(stages):  # noqa: F811
    """JAX tests/test_pipeline.py:332: source-rate stereo and int8 are
    rejected, naming the field."""
    for field in ("stereo_source_rate", "quantize_int8"):
        cfg = dataclasses.replace(PipelineConfig(), **{field: True})
        with pytest.raises(ValueError, match=field):
            StagedRestorationPipeline(**_models(stages), config=cfg,
                                      devices=["cpu"])


def test_staged_mid_exact_matches_batch(stages):  # noqa: F811
    """JAX tests/test_pipeline.py:346: mid-exact behaves identically in
    staged serving."""
    cfg = dict(CHUNKED, max_chunks_per_program=8, stereo_mid_exact=True)
    audio = _audio(4000, seed=4)
    plain, staged = _pair(stages, **cfg)
    _close(staged.restore(audio, RATE)[0], plain.restore(audio, RATE)[0])


def test_staged_subchunked_stereo_matches_batch(stages):  # noqa: F811
    """JAX tests/test_pipeline.py:605: sub-chunked stereo windows run the
    same stereo stage as the fused pipeline."""
    cfg = dict(CHUNKED, stereo_chunk_seconds=400 / RATE,
               max_chunks_per_program=8)
    audio = _audio(4000, seed=5)
    plain, staged = _pair(stages, **cfg)
    _close(staged.restore(audio, RATE)[0], plain.restore(audio, RATE)[0])


def test_staged_bf16_matches_batch(stages):  # noqa: F811
    """bf16: each stage's f32 output cast back to bf16 at the next stage is
    exact, so staged equals the fused bf16 pipeline."""
    cfg = dict(CHUNKED, compute_dtype="bfloat16")
    audio = _audio(3000, seed=6)
    plain, staged = _pair(stages, devices=("cpu",), **cfg)
    _close(staged.restore(audio, RATE)[0], plain.restore(audio, RATE)[0])


def test_staged_chunk_count_is_bucketed(stages, monkeypatch):  # noqa: F811
    """JAX tests/test_pipeline.py:720: the slab size is bucketed like the
    plain pipeline's, so 9, 10 and 11 chunks share one shape (12), and the
    bucket padding is masked out."""
    frames = []
    framing = restore_mod.frame_structured

    def spy(audio, n, chunk, hop):
        frames.append(n)
        return framing(audio, n, chunk, hop)

    # the slab loop both pipelines run (restore.py::run_slabs)
    monkeypatch.setattr(restore_mod, "frame_structured", spy)
    cfg = dict(sample_rate=8000, chunk_seconds=0.25, overlap_seconds=0.05,
               max_chunks_per_program=16)
    plain, staged = _pair(stages, **cfg)
    for n in (9, 10, 11):
        audio = _audio(2000 + (n - 1) * 1600, seed=n)
        _close(staged.restore(audio, 8000)[0], plain.restore(audio, 8000)[0])
    assert set(frames) == {12}


def test_staged_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default devices are usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StagedRestorationPipeline(denoiser=torch.nn.Identity())
