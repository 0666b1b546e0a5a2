"""K1's share (%) of its roofline over a feed's two walks (the emitted
frames and the lookahead's), over K1's device time."""
from benchmark.harness.reading import roofline


def read(rec):
    return roofline(rec, "k1_bound_ms", "lstm_recurrence_kernel")
