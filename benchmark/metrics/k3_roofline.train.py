"""K3's share (%) of its roofline: the training backward's bound over the
device time of its reverse walk and its dW_hh pass."""
from benchmark.harness.reading import roofline


def read(rec):
    return roofline(rec, "k3_bound_ms", "lstm_train_bwd_kernel",
                    "dw_partial_kernel", "dw_sum_kernel")
