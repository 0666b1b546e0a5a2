"""Configuration dataclasses of the port, and their YAML overlay.

The port's own copy of ml_audio_restoration_tpu/config.py, with the same
fields and defaults, so a config written for one package reads the same in
the other. PipelineConfig's fields fall in three kinds:

- computed: `sample_rate`, `chunk_seconds`, `overlap_seconds`,
  `enable_super_resolution`, `whole_file`, `compute_dtype` ("float32" or
  "bfloat16"), `stereo_chunk_seconds`, `stereo_mid_exact`,
  `stereo_source_rate`, `max_chunks_per_program`, and `quantize_int8`
  (int8 serving, ops/quant.py: the conv stacks run s8 x s8 -> s32 with
  activation scales from a calibration pass; the output differs from f32
  by quantization noise, so it is opt-in);
- honoured under `quantize_int8` only: `packed_convs` and `int8_scope`.
  The int8 result is defined on the packed layout, so int8 runs the
  packed int8 forwards: `packed_convs=False` disables it (a warning, then
  float serving, as in the JAX package), and `int8_scope` picks what
  quantizes ("packed": the r>1 packed stages; "full": the C>=128
  plain-layout stages too, as r=1 packed convs). On the float path both
  are ignored: the port computes the plain layout, which the JAX
  package's packed float path equals up to float reassociation;
- accepted and ignored: `lstm_impl` (None, "scan" or "pallas"; the port
  routes the LSTM by device and grad mode, and rejects any other value, as
  the JAX pipeline does).

TrainConfig's `lstm_impl` and `packed_convs` are accepted and ignored.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
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
class ArtifactConfig:
    """Knobs of the 78rpm artifact simulator (data/artifacts.py), which
    the denoiser's `degrade` pairing runs inside the train step."""
    impulse_rate: float = 10.0
    impulse_amplitude: Tuple[float, float] = (0.1, 0.5)
    surface_noise_level: Tuple[float, float] = (0.015, 0.03)
    crackle_level: Tuple[float, float] = (0.01, 0.02)
    add_rumble: bool = True
    add_rolloff: bool = True
    rumble_level: Tuple[float, float] = (0.005, 0.015)
    rolloff_freq: Tuple[float, float] = (6000.0, 8000.0)


@dataclass
class DataConfig:
    data_dir: str = "data/raw"
    degraded_dir: Optional[str] = None
    sample_rate: int = 22050
    chunk_duration: float = 2.0
    val_split: float = 0.1
    synthetic_ratio: float = 0.7
    # False keeps the upstream quirk: a long file whose native rate differs
    # from sample_rate yields native-rate chunks (with a warning); True
    # reads a rate-scaled window and resamples it
    resample_chunks: bool = False
    artifacts: ArtifactConfig = field(default_factory=ArtifactConfig)


@dataclass
class TrainConfig:
    model: str = "denoiser"  # denoiser | super_resolution | stereo_separator
    batch_size: int = 4
    num_epochs: int = 100
    learning_rate: float = 1e-4
    save_every: int = 10
    seed: int = 0
    checkpoint_dir: str = "models/checkpoints"
    log_dir: str = "runs"
    test_audio_dir: Optional[str] = None
    test_output_dir: Optional[str] = None
    # plateau scheduler: patience 5, factor 0.5
    plateau_patience: int = 5
    plateau_factor: float = 0.5
    # loss weights; the optional terms are off at 0.0
    time_weight: float = 1.0
    spectral_weight: float = 0.5
    impulse_weight: float = 0.3
    clustering_weight: float = 0.1
    consistency_weight: float = 0.05
    balance_weight: float = 0.0
    decorrelation_weight: float = 0.0
    lf_centering_weight: float = 0.0
    stats_match_weight: float = 0.0
    si_sdr_weight: float = 0.0
    contrastive_weight: float = 0.0
    # global-norm gradient clipping before Adam (0 = off)
    max_grad_norm: float = 0.0
    # exponential moving average of the weights, used for validation and
    # rendering (0 = off)
    ema_decay: float = 0.0
    compute_dtype: str = "float32"
    # TPU-only switches, accepted and ignored
    lstm_impl: Optional[str] = None
    packed_convs: Optional[bool] = None
    # data-parallel mesh axis size (1 = one device)
    data_parallel: int = 1
    sync_batchnorm: bool = False


@dataclass
class PipelineConfig:
    sample_rate: int = 22050
    chunk_seconds: float = 2.0
    overlap_seconds: float = 0.05
    enable_super_resolution: bool = True
    whole_file: bool = False  # one chunk spanning the recording
    compute_dtype: str = "float32"  # or "bfloat16"
    # the stereo LSTM over shorter internal windows (seconds; None = the
    # whole chunk)
    stereo_chunk_seconds: Optional[float] = None
    # out = mid +/- the predicted side, the mid being the stereo stage's input
    stereo_mid_exact: bool = False
    # the stereo stage on the pre-SR signal; only its side is upsampled
    stereo_source_rate: bool = False
    # longer recordings run in slabs of at most this many chunks (balanced:
    # pipeline/restore.py::slab_plan), then crossfade
    max_chunks_per_program: int = 64
    # int8 serving (opt-in): the conv stacks in int8 on the packed layout;
    # packed_convs=False disables it, int8_scope is "packed" or "full"
    packed_convs: bool = True
    int8_scope: str = "packed"
    quantize_int8: bool = False
    # TPU-only switch, accepted and ignored
    lstm_impl: Optional[str] = None

    def __post_init__(self):
        check_pipeline_config(self)


SERVING_LSTM_IMPLS = (None, "scan", "pallas")
COMPUTE_DTYPES = ("float32", "bfloat16")
INT8_SCOPES = ("packed", "full")


def check_pipeline_config(cfg: "PipelineConfig") -> None:
    """Raise on what the port does not compute: an LSTM route other than
    None/"scan"/"pallas" (the JAX pipeline's rule: "pallas_train" is a
    training kernel), a compute dtype other than f32/bf16 and, under
    quantize_int8, an int8 scope other than "packed"/"full". Called when a
    PipelineConfig is made and again by the pipeline, since load_config
    sets fields after construction."""
    if cfg.quantize_int8 and cfg.int8_scope not in INT8_SCOPES:
        raise ValueError(f"PipelineConfig.int8_scope must be one of "
                         f"{INT8_SCOPES}, got {cfg.int8_scope!r}")
    if cfg.lstm_impl not in SERVING_LSTM_IMPLS:
        raise ValueError(
            f"PipelineConfig.lstm_impl={cfg.lstm_impl!r}: serving accepts "
            f"None (auto), 'scan' or 'pallas'")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"PipelineConfig.compute_dtype must be one of "
                         f"{COMPUTE_DTYPES}, got {cfg.compute_dtype!r}")


@dataclass
class Config:
    denoiser: DenoiserConfig = field(default_factory=DenoiserConfig)
    super_resolution: SuperResolutionConfig = field(
        default_factory=SuperResolutionConfig)
    stereo_separator: StereoSeparatorConfig = field(
        default_factory=StereoSeparatorConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)


def _overlay(obj, updates: dict):
    for key, value in updates.items():
        if not hasattr(obj, key):
            raise KeyError(
                f"unknown config field {key!r} for {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _overlay(current, value)
        else:
            if isinstance(current, tuple) and isinstance(value, list):
                value = tuple(value)
            setattr(obj, key, value)
    return obj


def load_config(path=None, overrides: dict | None = None) -> Config:
    """Defaults <- YAML file (optional) <- overrides dict (optional)."""
    cfg = Config()
    if path is not None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        _overlay(cfg, data)
    if overrides:
        _overlay(cfg, overrides)
    return cfg


def save_config(cfg: Config, path):
    import yaml

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
