"""Program span: device ms a traced restore in `restore.denoise` (the
denoiser of every program of the restore, between each span's CUDA
events), over the `restore` spans."""
from benchmark.harness.spans import per_unit, records


def read(rec):
    return per_unit(records(), "restore", ("restore.denoise",), "device")
