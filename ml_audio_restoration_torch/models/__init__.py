"""The three eval models of the restoration chain, as nn.Modules."""
from .common import cast_model, count_params, fold_conv_bn, init_params
from .denoiser import AudioDenoiser
from .stereo_separator import StereoSeparator
from .super_resolution import AudioSuperResolution

__all__ = ["AudioDenoiser", "AudioSuperResolution", "StereoSeparator",
           "cast_model", "count_params", "fold_conv_bn", "init_params"]
