"""Ops of the PyTorch port: convs and batch norm, interpolation, chunking,
the LSTM, the STFT and the IIR filters."""
from .chunking import (
    chunk_signal, crossfade_window, frame_structured, num_chunks,
    overlap_add)
from .conv import (
    batch_norm,
    batch_norm_train,
    conv1d,
    conv1d_epilogue,
    conv_transpose1d,
    conv_transpose1d_epilogue,
    leaky_relu,
    max_pool1d,
    moving_average,
)
from .interp import interp_linear, upsample_linear
# `lstm` the function stays in ops.lstm: exporting it here would shadow
# the submodule of the same name
from .lstm import (
    LSTMRecurrenceTrain, lstm_init, lstm_recurrence, lstm_recurrence_bwd_plain,
    lstm_recurrence_plain, lstm_recurrence_train_plain, stacked_lstm)
from .filters import (
    bank_select, butter_bank, butter_coeffs, butter_filtfilt, butter_sos,
    filtfilt, lfilter, sosfilt, sosfiltfilt)
from .stft import frame, hann_window, istft, stft, stft_magnitude

__all__ = [
    "LSTMRecurrenceTrain", "bank_select", "batch_norm", "batch_norm_train",
    "butter_bank", "butter_coeffs", "butter_filtfilt", "butter_sos",
    "chunk_signal", "conv1d", "conv1d_epilogue", "conv_transpose1d",
    "conv_transpose1d_epilogue", "crossfade_window",
    "filtfilt", "frame", "frame_structured", "hann_window", "interp_linear",
    "istft", "leaky_relu", "lfilter", "lstm_init", "lstm_recurrence",
    "lstm_recurrence_bwd_plain", "lstm_recurrence_plain",
    "lstm_recurrence_train_plain", "max_pool1d", "moving_average",
    "num_chunks", "overlap_add", "sosfilt", "sosfiltfilt", "stacked_lstm",
    "stft", "stft_magnitude", "upsample_linear",
]
