"""Ops of the PyTorch port: convs and batch norm, interpolation, chunking,
the LSTM and the STFT."""
from .chunking import (
    crossfade_window, frame_structured, num_chunks, overlap_add)
from .conv import (
    batch_norm,
    batch_norm_train,
    conv1d,
    conv_transpose1d,
    leaky_relu,
    max_pool1d,
    moving_average,
)
from .interp import interp_linear, upsample_linear
# `lstm` the function stays in ops.lstm: exporting it here would shadow
# the submodule of the same name
from .lstm import (
    LSTMRecurrenceTrain, lstm_recurrence, lstm_recurrence_bwd_plain,
    lstm_recurrence_plain, lstm_recurrence_train_plain, stacked_lstm)
from .stft import frame, hann_window, stft, stft_magnitude

__all__ = [
    "LSTMRecurrenceTrain", "batch_norm", "batch_norm_train", "conv1d",
    "conv_transpose1d", "crossfade_window", "frame", "frame_structured",
    "hann_window", "interp_linear", "leaky_relu", "lstm_recurrence",
    "lstm_recurrence_bwd_plain", "lstm_recurrence_plain",
    "lstm_recurrence_train_plain", "max_pool1d", "moving_average",
    "num_chunks", "overlap_add", "stacked_lstm", "stft", "stft_magnitude",
    "upsample_linear",
]
