"""Offline restoration: denoise -> super-resolution -> stereo.

Counterpart of the default branch of ml_audio_restoration_tpu/pipeline/
restore.py: the recording is framed into a batch of overlapping chunks, the
three eval models run over the batch, and the chunks are crossfaded back
together. The chunk count is bucketed up to a multiple of 4, bucket padding
gets zero crossfade weight, and recordings longer than
`max_chunks_per_program` chunks run in slabs whose outputs are crossfaded
exactly like chunks. `whole_file=True` runs one chunk spanning the
recording.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..audio import load_audio, normalize_audio, save_audio
from ..compat import load_pth, model_from_state_dict
from ..config import PipelineConfig
from ..ops import frame_structured, num_chunks, overlap_add


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU:
    a CUDA device without a usable card raises rather than falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def load_stage(path, name: str, device="cpu") -> Optional[nn.Module]:
    """Load one stage from an upstream `.pth`; None passes through."""
    if path is None:
        return None
    p = str(path)
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"{name} checkpoint not found: {p!r} - pass an upstream .pth or "
            f"disable the stage (--no-denoise/--no-super-res/--no-stereo)")
    if not p.endswith(".pth"):
        raise ValueError(f"{p!r}: the port loads .pth checkpoints only")
    return model_from_state_dict(name, load_pth(p), device)


def _bucket(n: int, granularity: int = 4) -> int:
    """Round the chunk count up to a multiple of `granularity`."""
    return max(granularity, ((n + granularity - 1) // granularity) * granularity)


_NOT_PORTED = ("stereo_chunk_seconds", "stereo_mid_exact",
               "stereo_source_rate")


class RestorationPipeline:
    """Holds the three stage models (any may be None) on one device."""

    def __init__(self, denoiser: Optional[nn.Module] = None,
                 super_resolution: Optional[nn.Module] = None,
                 stereo: Optional[nn.Module] = None,
                 config: Optional[PipelineConfig] = None,
                 device="cuda"):
        self.config = config or PipelineConfig()
        if self.config.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={self.config.compute_dtype!r}: the port "
                f"runs float32 only so far")
        for field in _NOT_PORTED:
            if getattr(self.config, field):
                raise NotImplementedError(f"PipelineConfig.{field} is not "
                                          f"ported yet")
        self.device = resolve_device(device)
        # The reference is full f32. cuDNN convolutions default to TF32 on
        # this card (about three decimal digits), which would break the
        # 1e-3 chain bar, so both TF32 switches are turned off here.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.denoiser, self.super_resolution, self.stereo = (
            None if m is None else m.to(self.device).eval()
            for m in (denoiser, super_resolution, stereo))

    @classmethod
    def from_checkpoints(cls, denoiser_path=None, super_res_path=None,
                         stereo_path=None, config=None, device="cuda"):
        """Load the stages from upstream `.pth` checkpoints."""
        dev = resolve_device(device)
        return cls(denoiser=load_stage(denoiser_path, "denoiser", dev),
                   super_resolution=load_stage(super_res_path,
                                               "super_resolution", dev),
                   stereo=load_stage(stereo_path, "stereo_separator", dev),
                   config=config, device=dev)

    @property
    def _has_sr(self) -> bool:
        return (self.super_resolution is not None
                and self.config.enable_super_resolution)

    @property
    def upscale_factor(self) -> int:
        if not self._has_sr:
            return 1
        return 2 ** len(self.super_resolution.upsample_blocks)

    @property
    def out_channels(self) -> int:
        return 2 if self.stereo is not None else 1

    def _stack(self, chunks):
        """The model stack over a chunk batch [N, chunk, 1] ->
        per-chunk outputs [N, C_out, chunk*f]."""
        x = chunks.permute(0, 2, 1)  # NCW
        if self.denoiser is not None:
            x = self.denoiser(x)
        if self._has_sr:
            x = self.super_resolution(x)
        if self.stereo is not None:
            x = self.stereo(x)
        return x

    def _process(self, audio_padded, n_chunks: int, chunk_size: int,
                 hop: int, overlap: int, valid: int):
        """frame -> stages -> overlap-add for one program's chunk batch."""
        f = self.upscale_factor
        chunks = frame_structured(audio_padded, n_chunks, chunk_size, hop)
        x = self._stack(chunks)
        total = (n_chunks - 1) * hop + chunk_size
        return overlap_add(x, hop * f, total * f, overlap=overlap * f,
                           valid=valid)

    @torch.inference_mode()
    def restore(self, audio, sample_rate: Optional[int] = None):
        """audio [C, T] (mixed to mono if C > 1), numpy or tensor ->
        (tensor [out_ch, T*f] on the pipeline's device, out_rate)."""
        cfg = self.config
        sample_rate = sample_rate or cfg.sample_rate
        if not torch.is_tensor(audio):
            audio = torch.from_numpy(np.asarray(audio, np.float32))
        audio = audio.to(self.device, torch.float32)
        if audio.ndim == 1:
            audio = audio[None]
        if audio.shape[0] > 1:
            audio = audio.mean(dim=0, keepdim=True)

        t = audio.shape[1]
        f = self.upscale_factor
        if cfg.whole_file:
            chunk_size, hop, overlap = t, t, 0
            n = n_real = 1
        else:
            chunk_size = int(round(cfg.chunk_seconds * sample_rate))
            overlap = int(round(cfg.overlap_seconds * sample_rate))
            hop = chunk_size - overlap
            n_real = num_chunks(t, chunk_size, hop)
            n = _bucket(n_real)

        max_n = max(cfg.max_chunks_per_program, 4)
        if cfg.whole_file or n <= max_n:
            total = (n - 1) * hop + chunk_size
            padded = torch.nn.functional.pad(audio, (0, total - t))
            out = self._process(padded, n, chunk_size, hop, overlap, n_real)
            return out[:, :t * f], sample_rate * f

        # Long recording: slabs of s chunks. Adjacent slabs share exactly
        # `overlap` input samples, so the slab crossfade reproduces the
        # single-shot chunk overlap-add; every slab holds a real chunk, and
        # `valid` masks the bucket padding of the last one.
        s = max_n
        num_slabs = -(-n_real // s)
        slab_len = (s - 1) * hop + chunk_size
        needed = (num_slabs - 1) * s * hop + slab_len
        padded = torch.nn.functional.pad(audio, (0, needed - t))
        outs = []
        for i in range(num_slabs):
            start = i * s * hop
            valid = min(max(n_real - i * s, 0), s)
            outs.append(self._process(padded[:, start:start + slab_len], s,
                                      chunk_size, hop, overlap, valid))
        out = overlap_add(torch.stack(outs), s * hop * f, needed * f,
                          overlap=overlap * f)
        return out[:, :t * f], sample_rate * f

    def restore_file(self, input_path, output_path,
                     sample_rate: Optional[int] = None,
                     normalize: bool = True):
        """WAV file to WAV file: load (mono, resampled), normalize, restore,
        normalize the output, save PCM_16."""
        sr_in = sample_rate or self.config.sample_rate
        audio, _ = load_audio(input_path, sample_rate=sr_in, mono=True)
        if normalize:
            audio = normalize_audio(audio)
        restored, out_rate = self.restore(audio, sr_in)
        save_audio(output_path, normalize_audio(restored.cpu().numpy()),
                   out_rate)
        return output_path, out_rate


def restore_audio(input_path, output_path, *,
                  denoiser_checkpoint="models/checkpoints/best_model.pth",
                  super_res_checkpoint="models/checkpoints/super_resolution/best_model.pth",
                  stereo_checkpoint="models/checkpoints/stereo/best_model.pth",
                  sample_rate: int = 22050,
                  enable_super_resolution: bool = True,
                  whole_file: bool = False,
                  chunk_seconds: float = 2.0,
                  overlap_seconds: float = 0.05,
                  device="cuda"):
    """Functional entry point: checkpoints in, one restored file out."""
    config = PipelineConfig(sample_rate=sample_rate,
                            chunk_seconds=chunk_seconds,
                            overlap_seconds=overlap_seconds,
                            enable_super_resolution=enable_super_resolution,
                            whole_file=whole_file)
    pipe = RestorationPipeline.from_checkpoints(
        denoiser_path=denoiser_checkpoint,
        super_res_path=(super_res_checkpoint if enable_super_resolution
                        else None),
        stereo_path=stereo_checkpoint, config=config, device=device)
    return pipe.restore_file(input_path, output_path)
