"""The three eval models of the restoration chain, as nn.Modules."""
from .common import (
    cast_model, cast_params, count_params, fold_conv_bn, init_params)
from .denoiser import AudioDenoiser
from .stereo_separator import StereoSeparator
from .super_resolution import AudioSuperResolution

__all__ = ["AudioDenoiser", "AudioSuperResolution", "StereoSeparator",
           "cast_model", "cast_params", "count_params", "fold_conv_bn",
           "init_params"]
