"""xrt: seconds of audio restored per second of the window (host clock;
each restore ends with its output on the host)."""
from benchmark.harness.reading import audio_rate


def read(rec):
    return audio_rate(rec)
