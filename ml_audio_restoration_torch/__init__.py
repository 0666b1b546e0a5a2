"""PyTorch / CUDA port of the 78rpm audio restoration framework.

Offline restoration (denoise -> super-resolution x2 -> stereo) on an NVIDIA
H100, held against the JAX package ml_audio_restoration_tpu. Plain tensor
work is PyTorch; the LSTM recurrence is a hand-written CUDA kernel
(csrc/lstm_recurrence.cu) built with nvcc at first use.
"""
from .config import PipelineConfig
from .pipeline import RestorationPipeline, restore_audio

__all__ = ["PipelineConfig", "RestorationPipeline", "restore_audio"]
