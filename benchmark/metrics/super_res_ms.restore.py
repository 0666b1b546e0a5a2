"""Program span: device ms a traced restore in `restore.super_resolution`
(the super-resolution net of every program of the restore), over the
`restore` spans."""
from benchmark.harness.spans import per_unit, records


def read(rec):
    return per_unit(records(), "restore", ("restore.super_resolution",),
                    "device")
