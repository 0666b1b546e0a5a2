"""The port's C++ codec (csrc/wavio.cpp + csrc/flacio.cpp through
audio/native.py) against the JAX package's native library and the numpy
codec, bit for bit: headers, full, partial and mono reads of WAV (PCM
16/24, float) and FLAC, the batch reader with its zero padding, and the
PCM-16 writer. Both libraries are loaded in this one process (each local
to its handle); the port's is built by ops/_build.py under build/, never
at the JAX package's native/libwavio.so. A failed build raises with the
compiler's output.
"""
import numpy as np
import pytest

from ml_audio_restoration_tpu.audio import native as jnative
from ml_audio_restoration_torch.audio import (
    flac, load_audio, native, read_wav, write_wav)
from ml_audio_restoration_torch.ops import _build

SR = 22050


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """WAVs in PCM 16, PCM 24 and float, and 16- and 24-bit FLACs, stereo
    and mono, of 4,000 frames."""
    root = tmp_path_factory.mktemp("codec")
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.8, 0.8, (4000, 2)).astype(np.float32)
    out = {}
    for sub in ("PCM_16", "PCM_24", "FLOAT"):
        out[f"wav_{sub}"] = root / f"{sub}.wav"
        write_wav(out[f"wav_{sub}"], x, SR, subtype=sub)
    out["wav_mono"] = root / "mono.wav"
    write_wav(out["wav_mono"], x[:, :1], SR)
    for bits in (16, 24):
        out[f"flac_{bits}"] = root / f"f{bits}.flac"
        flac.write_flac(out[f"flac_{bits}"], x, SR, bits=bits,
                        block_size=1024, seektable_every=2)
    out["flac_mono"] = root / "mono.flac"
    flac.write_flac(out["flac_mono"], x[:, :1], SR)
    return out


def _numpy_read(path, **kw):
    if str(path).endswith(".flac"):
        return flac.read_flac(path, **kw)
    return read_wav(path, **kw)


def test_library_is_the_ports_own():
    lib = _build.library_path(native.LIBRARY)
    assert native.available() and lib.exists()
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libwavio_")
    assert "native" not in lib.parts[-3:]
    assert [p.name for p in _build.sources(_build.CSRC / "wavio.cpp")] == [
        "wavio.cpp", "flacio.h"]


@pytest.mark.parametrize("name", ["wav_PCM_16", "wav_PCM_24", "wav_FLOAT",
                                  "wav_mono", "flac_16", "flac_24",
                                  "flac_mono"])
def test_reads_equal_jax_library_and_numpy(files, name):
    path = files[name]
    assert native.info(path) == jnative.info(path)
    for start, frames in ((0, -1), (1234, 777), (3900, 500)):
        got, sr = native.read(path, start=start, frames=frames)
        want, _ = jnative.read(path, start=start, frames=frames)
        plain, psr = _numpy_read(path, start=start, frames=frames)
        assert sr == psr == SR and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain.astype(np.float32))
    mono, _ = native.read(path, mono=True)
    np.testing.assert_array_equal(mono, jnative.read(path, mono=True)[0])


def test_batch_reader_with_padding_equals_jax(files):
    paths = [files["wav_PCM_16"], files["flac_16"], files["flac_mono"],
             files["wav_FLOAT"]]
    starts = [0, 1500, 3700, 3999]
    got = native.read_batch_mono(paths, starts, 600, threads=3)
    want = jnative.read_batch_mono(paths, starts, 600, threads=1)
    np.testing.assert_array_equal(got, want)
    for row, path, start in zip(got, paths, starts):
        mono, _ = native.read(path, start=start, frames=600, mono=True)
        np.testing.assert_array_equal(row[:mono.shape[0]], mono)
        assert not np.any(row[mono.shape[0]:])  # zero padding past the end
    assert got[3, 0] != 0 and not np.any(got[3, 1:])


def test_pcm16_writer_bytes_equal_jax(tmp_path):
    x = np.random.default_rng(1).uniform(-1.2, 1.2, (1001, 2)).astype(
        np.float32)
    assert native.write_pcm16(tmp_path / "port.wav", x, 44100)
    assert jnative.write_pcm16(tmp_path / "jax.wav", x, 44100)
    assert ((tmp_path / "port.wav").read_bytes()
            == (tmp_path / "jax.wav").read_bytes())


def test_unreadable_file(tmp_path, files):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFxxxxWAVE")
    assert native.info(bad) is None and native.read(bad) is None
    assert native.read_batch_mono([files["wav_mono"], bad], [0, 0], 10) is None
    with pytest.raises(ValueError, match="cannot decode"):
        load_audio(bad)
    raw = bytearray(files["flac_16"].read_bytes())
    raw[flac.flac_info(files["flac_16"]).first_frame_offset + 40] ^= 0xFF
    (tmp_path / "bad.flac").write_bytes(bytes(raw))
    assert native.read(tmp_path / "bad.flac") is None  # CRC checked


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for unit in _build.HOST_LIBRARIES["wavio"]:
        (csrc / unit).write_text("int broken(;\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for wavio:\n.*"
                                           r"error"):
        _build.build("wavio")
    assert not list((tmp_path / "build").glob("*.so"))
