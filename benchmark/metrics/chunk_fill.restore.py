"""Program span counts: the real chunks (`rows_real`) of the traced
`restore` spans over the chunk rows they computed (`rows_run`: the bucket,
or the slabs' rows), in %: the share of the rows computed that is not
bucket or slab padding."""
from benchmark.harness.spans import count_share, records


def read(rec):
    return count_share(records(), "restore", "rows_real", "rows_run")
