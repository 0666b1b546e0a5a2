"""train_audio_s_per_s: seconds of audio in every training step the
window completed over the window's seconds (host clock)."""
from benchmark.harness.reading import audio_rate


def read(rec):
    return audio_rate(rec)
