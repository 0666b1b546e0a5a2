"""Program spans: device ms a traced restore in `enhance.bands`, the
enhancer's per-band layers (band split; final norm and mask estimators),
over the `restore` spans."""
from benchmark.harness.spans import per_unit, records


def read(rec):
    return per_unit(records(), "restore", ("enhance.bands",), "device")
