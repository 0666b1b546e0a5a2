"""Program spans: device ms a traced restore in `enhance.time`, the
enhancer's transformers along time (with the layout change in front of
each), over the `restore` spans."""
from benchmark.harness.spans import per_unit, records


def read(rec):
    return per_unit(records(), "restore", ("enhance.time",), "device")
