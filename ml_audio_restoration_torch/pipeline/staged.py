"""Pipeline-parallel (staged) serving: one model stage per device.

Counterpart of ml_audio_restoration_tpu/pipeline/staged.py. Data
parallelism (`RestorationPipeline(mesh=...)`) shards the chunk batch and is
almost always the right scale-out. Staging the models across devices
(denoiser on the first, super-resolution on the second, stereo on the
third) pays only where the chunk batch is too small to shard, such as short
clips arriving one at a time: each stage keeps the whole batch, and stage k
of slab i can overlap stage k-1 of slab i+1.

Each stage's module sits on its device; a slab's activations move to the
next stage's device with a copy that does not wait for the host, and the
slab's overlap-add runs on the last device. The host enqueues every stage
of every slab without reading anything back, so the devices overlap.

Output contract: bit-identical to `RestorationPipeline.restore` for the
same config. The mixdown, the framing, the slab loop with its overlap-add
(restore.py::run_slabs) and the mid/side combine are the plain pipeline's
code, and each stage runs in the compute dtype with its output in f32,
which is exact for bf16.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import PipelineConfig, check_pipeline_config
from ..parallel.mesh import canonical, cuda_devices, replica
from ..utils.device import no_tf32, resolve_device
from .restore import (StageCopies, _framing, _mono, _upscale, apply_stereo,
                      combine_stereo, run_slabs, stereo_sub_cfg)


class StagedRestorationPipeline:
    """denoise | super-res | stereo staged across devices."""

    def __init__(self, denoiser: Optional[nn.Module] = None,
                 super_resolution: Optional[nn.Module] = None,
                 stereo: Optional[nn.Module] = None,
                 config: Optional[PipelineConfig] = None,
                 devices=None):
        """`devices` defaults to every CUDA device (none raises: staged
        serving never falls back to the CPU); stages wrap round-robin over
        them. A stage's module serves as given where it already lies on
        its device, else as a copy there: the caller's modules are never
        moved (parallel.mesh.replica)."""
        self.config = config or PipelineConfig()
        check_pipeline_config(self.config)
        # a linear per-device chain: source-rate stereo consumes the pre-SR
        # signal (a fork) and int8 needs calibration state, so both are
        # rejected rather than silently ignored
        for field in ("stereo_source_rate", "quantize_int8"):
            if getattr(self.config, field):
                raise ValueError(
                    f"StagedRestorationPipeline does not support "
                    f"config.{field}; use RestorationPipeline")
        devices = [canonical(resolve_device(d)) for d in (
            devices if devices is not None else cuda_devices())]
        if not devices:
            resolve_device("cuda")  # raises: no card
        no_tf32()
        stages = [s for s in (
            ("denoiser", denoiser),
            ("super_resolution", super_resolution
             if self.config.enable_super_resolution else None),
            ("stereo", stereo)) if s[1] is not None]
        if not stages:
            raise ValueError("no stages")
        self.placement = {}
        self.stages = {}
        for i, (name, model) in enumerate(stages):
            dev = devices[i % len(devices)]
            self.placement[name] = dev
            self.stages[name] = replica(model, dev).eval()
        self._copies = StageCopies(self.stages.get)

    @property
    def upscale_factor(self) -> int:
        return _upscale(self.stages.get("super_resolution"))

    @property
    def out_channels(self) -> int:
        return 2 if "stereo" in self.stages else 1

    def _stack(self, sample_rate: int):
        """The stage stack, chunks [N, chunk, 1] -> [N, C_out, chunk*f] f32
        on the last stage's device: each stage on its device, its input in
        the compute dtype and its output in f32, as the plain stack computes
        it (a bf16 -> f32 -> bf16 round trip at a seam is exact)."""
        cfg = self.config
        dtype = getattr(torch, cfg.compute_dtype)

        def stack(chunks):
            x = chunks.permute(0, 2, 1)
            for name, dev in self.placement.items():
                model = self._copies.get(name, dtype, dev)
                x = x.to(dev, non_blocking=True).to(dtype)
                if name != "stereo":
                    x = model(x).float()
                    continue
                sub = stereo_sub_cfg(cfg, x.shape[-1], self.upscale_factor,
                                     sample_rate=sample_rate)
                x = combine_stereo(x, apply_stereo(model, x, sub),
                                   mid_exact=cfg.stereo_mid_exact)
            return x

        return stack

    @torch.inference_mode()
    def restore(self, audio, sample_rate: Optional[int] = None):
        """audio [C, T] (mixed to mono if C > 1), numpy or tensor ->
        (tensor [out_ch, T*f] on the last stage's device, out_rate): the
        plain pipeline's mixdown, framing and slab loop (run_slabs) around
        this pipeline's stage stack."""
        cfg = self.config
        check_pipeline_config(cfg)
        sample_rate = sample_rate or cfg.sample_rate
        f = self.upscale_factor
        out = run_slabs(self._stack(sample_rate),
                        _mono(audio, next(iter(self.placement.values()))),
                        _framing(cfg, sample_rate), f,
                        max(cfg.max_chunks_per_program, 4),
                        lambda a, n: F.pad(a, (0, n)))
        return out, sample_rate * f
