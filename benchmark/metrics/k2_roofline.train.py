"""K2's share (%) of its roofline: the training forward's bound at the
step's shape over K2's device time."""
from benchmark.harness.reading import roofline


def read(rec):
    return roofline(rec, "k2_bound_ms", "lstm_train_fwd_kernel")
