"""feed_p95_ms: the 95th percentile of the window's feeds, each from the
call of `feed` to the return of its host array (host clock)."""
from benchmark.harness.reading import unit_p95_ms


def read(rec):
    return unit_p95_ms(rec)
