"""The port's mp3/ogg codecs (audio/codecs.py, the system libmpg123 /
libvorbisfile decoders and lame / vorbisenc encoders through ctypes)
against the JAX package's: decodes equal on the same file, seek reads
included, through load_audio too; the encoders write the JAX package's
bytes. Each class skips when its system library is absent, as
tests/test_codecs.py does. Without a decoder, load_audio raises the JAX
package's ValueError; without an encoder, save_audio raises."""
import numpy as np
import pytest

from ml_audio_restoration_tpu.audio import codecs as jcodecs
from ml_audio_restoration_tpu.audio import load_audio as jload_audio
from ml_audio_restoration_torch.audio import codecs, io, load_audio, save_audio

SR = 44100


@pytest.fixture(scope="module")
def signal():
    t = np.arange(SR // 2) / SR
    return np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                     0.4 * np.sin(2 * np.pi * 660 * t)],
                    axis=1).astype(np.float32)


@pytest.mark.skipif(not codecs.mp3_available(), reason="libmpg123 missing")
def test_mp3_equals_jax(tmp_path, signal):
    path = tmp_path / "a.mp3"
    assert jcodecs.write_mp3(path, signal, SR)
    assert codecs.write_mp3(tmp_path / "port.mp3", signal, SR)
    assert (tmp_path / "port.mp3").read_bytes() == path.read_bytes()
    for start, frames in ((0, -1), (10000, 500)):
        got, sr = codecs.read_mp3(path, start, frames)
        want, wsr = jcodecs.read_mp3(path, start, frames)
        assert sr == wsr == SR
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(load_audio(path, 22050)[0],
                                  jload_audio(path, 22050)[0])


@pytest.mark.skipif(not codecs.ogg_available(),
                    reason="libvorbisfile missing")
def test_ogg_equals_jax(tmp_path, signal):
    path = tmp_path / "a.ogg"
    save_audio(path, signal.T, SR)  # through the encoder
    for start, frames in ((0, -1), (7000, 900)):
        got, sr = codecs.read_ogg(path, start, frames)
        want, wsr = jcodecs.read_ogg(path, start, frames)
        assert sr == wsr == SR
        np.testing.assert_array_equal(got, want)
    got, _ = load_audio(path, SR, mono=False)
    np.testing.assert_array_equal(got, jload_audio(path, SR, mono=False)[0])
    n = min(got.shape[1], signal.shape[0])
    assert np.corrcoef(got[0, :n], signal[:n, 0])[0, 1] > 0.99


def test_missing_libraries_raise(tmp_path, signal, monkeypatch):
    path = tmp_path / "a.mp3"
    path.write_bytes(b"\xff\xfb" + b"\x00" * 64)
    monkeypatch.setattr(codecs, "read", lambda *a, **k: None)
    monkeypatch.setattr(jcodecs, "read", lambda *a, **k: None)
    with pytest.raises(ValueError) as got:
        load_audio(path)
    with pytest.raises(ValueError) as want:
        jload_audio(path)
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(codecs, "write_ogg", lambda *a: False)
    with pytest.raises(ValueError, match="vorbis encoder is unavailable"):
        save_audio(tmp_path / "b.ogg", signal.T, SR)
    assert io.codecs is codecs
