"""The three eval models of the restoration chain and the optional fourth
stage, BS-RoFormer, as nn.Modules."""
from .bs_roformer import BSRoformer
from .common import (
    cast_model, cast_params, count_params, epilogue_convs, fold_conv_bn,
    init_params)
from .denoiser import AudioDenoiser
from .stereo_separator import StereoSeparator
from .super_resolution import AudioSuperResolution

__all__ = ["AudioDenoiser", "AudioSuperResolution", "BSRoformer",
           "StereoSeparator", "cast_model", "cast_params", "count_params",
           "epilogue_convs", "fold_conv_bn", "init_params"]
