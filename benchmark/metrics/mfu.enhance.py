"""Model FLOPs of the untraced window (the three stages and the enhancer,
benchmark/counts/models.py and bs_roformer.py, from shapes) over its
seconds, as a share (%) of the peak of the cell's compute type
(benchmark/counts/peaks.json)."""
from benchmark.harness.reading import mfu


def read(rec):
    return mfu(rec)
