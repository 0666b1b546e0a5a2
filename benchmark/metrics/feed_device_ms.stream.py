"""Device ms busy a traced feed; its gap to the feed's wall time is the
host's share."""
from benchmark.harness.reading import device_ms_per_step


def read(rec):
    return device_ms_per_step(rec)
