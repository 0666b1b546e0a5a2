"""Program span: device ms a traced restore in `restore.stereo` (the stereo
stage: encoder, K1, decoders), over the `restore` spans."""
from benchmark.harness.spans import per_unit, records


def read(rec):
    return per_unit(records(), "restore", ("restore.stereo",), "device")
