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
same config. The framing, the stage arithmetic (each stage in the compute
dtype, its output in f32, which is exact for bf16) and the overlap-add are
the plain pipeline's, at the same shapes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import PipelineConfig, check_pipeline_config
from ..models import cast_model
from ..ops import frame_structured, num_chunks, overlap_add
from ..parallel.mesh import canonical, cuda_devices, replica
from .restore import (_bucket, apply_stereo, no_tf32, resolve_device,
                      stereo_sub_cfg)


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
        self._order = [name for name, _ in stages]
        self._cast: dict = {}  # compute dtype -> {stage: model in it}

    @property
    def upscale_factor(self) -> int:
        if "super_resolution" not in self.stages:
            return 1
        return 2 ** len(self.stages["super_resolution"].upsample_blocks)

    @property
    def out_channels(self) -> int:
        return 2 if "stereo" in self.stages else 1

    def _model(self, name: str):
        """Stage `name` in the compute dtype (the module itself in f32)."""
        dtype = self.config.compute_dtype
        if dtype not in self._cast:
            self._cast[dtype] = {n: cast_model(m, getattr(torch, dtype))
                                 for n, m in self.stages.items()}
        return self._cast[dtype][name]

    def _run_stage(self, name: str, x, sample_rate: int):
        """One stage on an NCW f32 batch on its device: the input in the
        compute dtype, the output in f32 (as the plain stack computes it:
        a bf16 -> f32 -> bf16 round trip at a seam is exact)."""
        cfg = self.config
        model = self._model(name)
        x = x.to(getattr(torch, cfg.compute_dtype))
        if name != "stereo":
            return model(x).float()
        sub = stereo_sub_cfg(cfg, x.shape[-1], self.upscale_factor,
                             sample_rate=sample_rate)
        y = apply_stereo(model, x, sub)
        if cfg.stereo_mid_exact:
            side = (y[:, 0:1] - y[:, 1:2]) * 0.5
            y = torch.cat([x + side, x - side], dim=1)
        return y.float()

    @torch.inference_mode()
    def restore(self, audio, sample_rate: Optional[int] = None):
        """audio [C, T] (mixed to mono if C > 1), numpy or tensor ->
        (tensor [out_ch, T*f] on the last stage's device, out_rate).
        Slabs of chunks flow through the stages; the chunk count is
        bucketed as the plain pipeline buckets it, and `valid` masks the
        bucket padding out of each slab's crossfade."""
        cfg = self.config
        check_pipeline_config(cfg)
        sample_rate = sample_rate or cfg.sample_rate
        first = self.placement[self._order[0]]
        if not torch.is_tensor(audio):
            audio = torch.from_numpy(np.asarray(audio, np.float32))
        audio = audio.to(first, torch.float32)
        if audio.ndim == 1:
            audio = audio[None]
        if audio.shape[0] > 1:
            audio = audio.mean(dim=0, keepdim=True)

        t = audio.shape[1]
        f = self.upscale_factor
        chunk = int(round(cfg.chunk_seconds * sample_rate))
        ov = int(round(cfg.overlap_seconds * sample_rate))
        hop = chunk - ov
        n_real = num_chunks(t, chunk, hop)
        # one bucketed slab size for nearby clip lengths, as the plain
        # pipeline's shapes (the JAX package's compiled programs)
        s = min(max(cfg.max_chunks_per_program, 4),
                _bucket(max(n_real, 4), 4))
        num_slabs = -(-n_real // s)
        slab_len = (s - 1) * hop + chunk
        needed = (num_slabs - 1) * s * hop + slab_len
        padded = F.pad(audio, (0, needed - t))

        outs = []
        for i in range(num_slabs):
            seg = padded[:, i * s * hop:i * s * hop + slab_len]
            x = frame_structured(seg, s, chunk, hop).permute(0, 2, 1)
            for name in self._order:
                x = self._run_stage(name, x.to(self.placement[name],
                                                non_blocking=True),
                                    sample_rate)
            # on the last stage's device
            valid = min(max(n_real - i * s, 0), s)
            outs.append(overlap_add(x, hop * f, slab_len * f,
                                    overlap=ov * f, valid=valid))
        if num_slabs == 1:
            out = outs[0]
        else:
            out = overlap_add(torch.stack(outs), s * hop * f, needed * f,
                              overlap=ov * f)
        return out[:, :t * f], sample_rate * f
