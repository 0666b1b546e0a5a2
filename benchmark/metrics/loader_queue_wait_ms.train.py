"""Program span: host ms a traced training step in `loader.wait` (the
port's loader waiting on its queue for the next batch), over the
`train.step` spans."""
from benchmark.harness.spans import per_unit, records


def read(rec):
    return per_unit(records(), "train.step", ("loader.wait",), "host")
