"""K1's share (%) of its roofline: the bound of the recurrence over the
real chunks' rows (benchmark/counts/kernels.py) over K1's device time."""
from benchmark.harness.reading import roofline


def read(rec):
    return roofline(rec, "k1_bound_ms", "lstm_recurrence_kernel")
