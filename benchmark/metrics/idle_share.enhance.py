"""Share (%) of the traced stretch with nothing running on the device."""
from benchmark.harness.reading import idle_share


def read(rec):
    return idle_share(rec)
