"""Configuration dataclasses of the port.

The port's own copy of the model and pipeline configs of
ml_audio_restoration_tpu/config.py, with the same fields and defaults, so a
config written for one package reads the same in the other. Fields that
only select TPU layouts or kernels (`packed_convs`, `quantize_int8`,
`int8_scope`, `lstm_impl`) are accepted and ignored: the port computes the
plain path, which the packed TPU path equals up to float reassociation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class DenoiserConfig:
    in_channels: int = 1
    out_channels: int = 1
    features: Tuple[int, ...] = (32, 64, 128)


@dataclass
class SuperResolutionConfig:
    upscale_factor: int = 2
    channels: int = 1
    base_channels: int = 32
    num_residual_blocks: int = 4


@dataclass
class StereoSeparatorConfig:
    base_channels: int = 32
    lstm_hidden: int = 64
    num_lstm_layers: int = 1


@dataclass
class PipelineConfig:
    sample_rate: int = 22050
    chunk_seconds: float = 2.0
    overlap_seconds: float = 0.05
    enable_super_resolution: bool = True
    whole_file: bool = False  # one chunk spanning the recording
    compute_dtype: str = "float32"
    # not ported yet: the pipeline raises when one of these is set
    stereo_chunk_seconds: Optional[float] = None
    stereo_mid_exact: bool = False
    stereo_source_rate: bool = False
    # longer recordings run in slabs of this many chunks, then crossfade
    max_chunks_per_program: int = 64
    # TPU-only switches, accepted and ignored
    packed_convs: bool = True
    quantize_int8: bool = False
    int8_scope: str = "packed"
    lstm_impl: Optional[str] = None
