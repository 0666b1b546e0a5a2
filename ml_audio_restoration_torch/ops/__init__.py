"""Ops of the PyTorch port: eval convs, interpolation, chunking, the LSTM."""
from .chunking import (
    crossfade_window, frame_structured, num_chunks, overlap_add)
from .conv import (
    batch_norm,
    conv1d,
    conv_transpose1d,
    leaky_relu,
    max_pool1d,
    moving_average,
)
from .interp import interp_linear, upsample_linear
# `lstm` the function stays in ops.lstm: exporting it here would shadow
# the submodule of the same name
from .lstm import lstm_recurrence, lstm_recurrence_plain, stacked_lstm

__all__ = [
    "batch_norm", "conv1d", "conv_transpose1d", "crossfade_window",
    "frame_structured", "interp_linear", "leaky_relu", "lstm_recurrence",
    "lstm_recurrence_plain", "max_pool1d", "moving_average", "num_chunks",
    "overlap_add", "stacked_lstm", "upsample_linear",
]
