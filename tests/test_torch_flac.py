"""The port's numpy FLAC codec (audio/flac.py) against the JAX package's.

The port's copy must write the JAX package's bytes for the same input
(the Levinson-Durbin and quantization steps are float64 numpy, and
STREAMINFO's MD5 covers the interleaved PCM), across mono and stereo, 16
and 24 bits, every stereo mode and bitstream feature, with and without a
SEEKTABLE; and its decoder must read the JAX package's files to the same
samples, including seek reads and a CRC fault. Signals are 0.3 s. Then
FLAC through restore_file and restore_directory.
"""
import numpy as np
import pytest

from ml_audio_restoration_tpu.audio import flac as jflac
from ml_audio_restoration_tpu.audio import load_audio as jload_audio
from ml_audio_restoration_tpu.audio import \
    load_audio_chunk as jload_audio_chunk
from ml_audio_restoration_torch.audio import (
    flac, load_audio, load_audio_chunk, save_audio)
from ml_audio_restoration_torch.config import PipelineConfig
from ml_audio_restoration_torch.pipeline import RestorationPipeline
from test_torch_models import jax_model, port_model
from test_torch_pipeline import CHUNKED, SMALL

SR = 22050


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(7)
    t = np.arange(int(SR * 0.3)) / SR
    return np.stack([
        0.5 * np.sin(2 * np.pi * 440 * t) + 0.04 * rng.normal(size=t.size),
        0.4 * np.sin(2 * np.pi * 660 * t) + 0.04 * rng.normal(size=t.size),
    ], axis=1).astype(np.float32)


WRITER_CASES = {
    "mono16": (1, {}),
    "stereo16": (2, {}),
    "mono24": (1, dict(bits=24)),
    "stereo24": (2, dict(bits=24)),
    "independent": (2, dict(stereo_mode="independent")),
    "left_side": (2, dict(stereo_mode="left_side")),
    "right_side": (2, dict(stereo_mode="right_side")),
    "mid_side": (2, dict(stereo_mode="mid_side")),
    "lpc8": (1, dict(lpc_order=8)),
    "verbatim_escape": (2, dict(force_verbatim=True, use_escape=True)),
    "seektable2_blocks1024": (2, dict(seektable_every=2, block_size=1024)),
    "no_seektable": (2, dict(seektable_every=0)),
}


@pytest.mark.parametrize("case", list(WRITER_CASES))
def test_writer_bytes_equal_jax(tmp_path, signal, case):
    ch, kw = WRITER_CASES[case]
    data = signal[:, :ch]
    jflac.write_flac(tmp_path / "jax.flac", data, SR, **kw)
    flac.write_flac(tmp_path / "port.flac", data, SR, **kw)
    assert ((tmp_path / "port.flac").read_bytes()
            == (tmp_path / "jax.flac").read_bytes())


def test_writer_int_input_and_wasted_bits_equal_jax(tmp_path):
    w = (np.random.default_rng(0).integers(-100, 100, size=(3000, 1))
         * 64).astype(np.int32)
    jflac.write_flac(tmp_path / "jax.flac", w, SR)
    flac.write_flac(tmp_path / "port.flac", w, SR)
    assert ((tmp_path / "port.flac").read_bytes()
            == (tmp_path / "jax.flac").read_bytes())
    got, _ = flac.read_flac(tmp_path / "jax.flac", dtype=None)
    np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("case", ["stereo16", "mono24", "no_seektable",
                                  "seektable2_blocks1024", "mid_side"])
def test_decoder_equals_jax_on_jax_files(tmp_path, signal, case):
    """Full reads (float and raw ints), STREAMINFO, and seek reads through
    the SEEKTABLE or by skip-decoding, on files the JAX package wrote."""
    ch, kw = WRITER_CASES[case]
    path = tmp_path / "jax.flac"
    jflac.write_flac(path, signal[:, :ch], SR, **kw)
    got, want = flac.flac_info(path), jflac.flac_info(path)
    for field in ("sample_rate", "channels", "bits", "frames", "md5",
                  "first_frame_offset", "seektable"):
        assert getattr(got, field) == getattr(want, field), field
    for args in ({}, dict(dtype=None), dict(start=3001, frames=1500),
                 dict(start=6000), dict(always_2d=False)):
        g, gsr = flac.read_flac(path, **args)
        w, wsr = jflac.read_flac(path, **args)
        assert gsr == wsr == SR and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_crc_fault_raises_like_jax(tmp_path, signal):
    path = tmp_path / "ok.flac"
    jflac.write_flac(path, signal, SR)
    raw = bytearray(path.read_bytes())
    raw[jflac.flac_info(path).first_frame_offset + 40] ^= 0xFF
    bad = tmp_path / "bad.flac"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError) as want:
        jflac.read_flac(bad)
    with pytest.raises(ValueError) as got:
        flac.read_flac(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24"])
def test_save_and_load_audio_flac_equal_jax(tmp_path, signal, subtype):
    """save_audio writes FLAC by extension at 16 or 24 bits; load_audio
    (the C++ codec) and the JAX package's load_audio read it alike, with
    and without a resample and a mono mix."""
    path = tmp_path / "a.flac"
    save_audio(path, signal.T, SR, subtype=subtype)
    assert flac.flac_info(path).bits == (24 if subtype == "PCM_24" else 16)
    for rate, mono in ((SR, False), (16000, True)):
        got, gsr = load_audio(path, rate, mono=mono)
        want, wsr = jload_audio(path, rate, mono=mono)
        assert gsr == wsr
        np.testing.assert_array_equal(got, want)


def test_load_audio_chunk_seeks_flac_like_jax(tmp_path, signal):
    path = tmp_path / "a.flac"
    jflac.write_flac(path, signal, SR, seektable_every=1, block_size=512)
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    for chunk in (700, 2205, 10000):  # seek reads, then the whole file
        got = load_audio_chunk(path, chunk, rng, SR, mono=False)
        want = jload_audio_chunk(path, chunk, jrng, SR, mono=False)
        np.testing.assert_array_equal(got, want)


def test_restore_directory_takes_flac(tmp_path):
    """A FLAC beside a WAV in a directory restores into
    `<stem>_restored.wav`, as the JAX package names outputs, equal to
    restore_file's output for it; restore_file writes FLAC by extension."""
    params = jax_model("denoiser", 0, np.random.default_rng(0),
                       **SMALL["denoiser"])[1]
    pipe = RestorationPipeline(denoiser=port_model("denoiser", *params),
                               config=PipelineConfig(**CHUNKED), device="cpu")
    rng = np.random.default_rng(1)
    for name in ("a.flac", "b.wav"):
        save_audio(tmp_path / "in" / name,
                   (0.2 * rng.normal(size=(1, 3000))).astype(np.float32), SR)
    out = pipe.restore_directory(tmp_path / "in", tmp_path / "out")
    assert [p.name for p, _ in out] == ["a_restored.wav", "b_restored.wav"]
    pipe.restore_file(tmp_path / "in" / "a.flac", tmp_path / "a.flac")
    got, _ = load_audio(tmp_path / "out" / "a_restored.wav", None)
    want, rate = load_audio(tmp_path / "a.flac", None)
    assert rate == SR and flac.flac_info(tmp_path / "a.flac").frames == 3000
    np.testing.assert_array_equal(got, want)
