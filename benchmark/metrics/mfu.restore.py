"""Model FLOPs (benchmark/counts/models.py, from shapes) of the untraced
window over its seconds, as a share (%) of the peak of the cell's compute
type (benchmark/counts/peaks.json)."""
from benchmark.harness.reading import mfu


def read(rec):
    return mfu(rec)
