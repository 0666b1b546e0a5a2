"""Program span: device ms a traced training step in `train.update`
(gradient clipping, the Adam step, the EMA), over the `train.step`
spans."""
from benchmark.harness.spans import per_unit, records


def read(rec):
    return per_unit(records(), "train.step", ("train.update",), "device")
