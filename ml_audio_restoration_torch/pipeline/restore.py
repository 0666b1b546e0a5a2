"""Offline restoration: denoise -> super-resolution -> stereo.

Counterpart of ml_audio_restoration_tpu/pipeline/restore.py: the recording
is framed into a batch of overlapping chunks, the three eval models run over
the batch, and the chunks are crossfaded back together. The chunk count is
bucketed up to a multiple of 4, bucket padding gets zero crossfade weight,
and recordings longer than `max_chunks_per_program` chunks run in the fewest
slabs that cap allows, all of one bucketed size (`slab_plan`: the real
chunks spread evenly over them, so the padding is under a bucket a slab),
whose outputs are crossfaded exactly like chunks. `whole_file=True` runs one
chunk spanning the recording.

The serving options of PipelineConfig: `compute_dtype="bfloat16"` (a bf16
copy of each model; K1 keeps its state in f32), `stereo_chunk_seconds` (the
stereo stage over shorter internal windows, `stereo_sub_cfg` and
`apply_stereo`), `stereo_mid_exact`, `stereo_source_rate` and
`quantize_int8`. All of them live in `_stage_stack`, which both `restore`
and the coalesced `restore_many` run, so the two compute the same function.

int8 serving (`quantize_int8`, ops/quant.py) runs the denoiser, SR and
stereo conv stacks through the packed int8 forwards (`apply_packed` under a
QuantCtx; csrc/int8_conv.cu on the card), with activation scales that
`calibrate_int8` collects from one f32 pass, automatically on the first
recording unless `load_int8_scales` ran. It rides the packed layout, so it
shares the JAX package's gates, which warn and serve float:
`packed_convs=False`, an unpackable checkpoint, a chunk length off the
packing grid (whole_file), and, for the stereo stage only, sub-chunked
stereo windows.

The stage layer below RestorationPipeline, StreamingRestorer and
StagedRestorationPipeline is written once, here: the stage models in a
compute dtype on a device (`StageCopies`), the int8 state (`Int8State`),
the mid/side combine (`combine_stereo`), and the mixdown, framing and slab
loop (`_mono`, `_framing`, `run_slabs`).

Multi-device serving (`mesh=`, parallel/mesh.py; the 'data' axis of the
JAX package's mesh): the chunk count is bucketed to a multiple of
lcm(4, data), the chunk batch is split over the mesh's devices (an uneven
split is allowed: a 64-chunk slab over 3 devices runs 22, 21 and 21 rows),
each shard runs on its device with that device's copy of the models, and
the outputs are gathered on the pipeline's device, where the overlap-add
runs. The int8 scales are calibrated once, on the pipeline's device, and
every device quantizes with them. A mesh whose 'model' axis is above 1
also splits each chunk's time over its row's devices (sequence
parallelism, `_sequence_stack`): the stages in front of the stereo LSTM run
on overlapping windows, time is gathered before the LSTM, and the decoders
run on windows again. With whole_file, data=1 and model=N that serves one
long recording across N devices.
"""
from __future__ import annotations

import math
import os
import time
import warnings
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio import find_audio_files, load_audio, normalize_audio, save_audio
from ..compat import load_pth, model_from_state_dict, state_dict_from_jax
from ..config import PipelineConfig, check_pipeline_config
from ..models import cast_model
from ..models import denoiser as denoiser_mod
from ..models import stereo_separator as stereo_mod
from ..models import super_resolution as sr_mod
from ..ops import (frame_structured, gemm, num_chunks, overlap_add,
                   upsample_linear)
from ..parallel.mesh import canonical, replica, shard_batch
from ..utils.device import no_tf32, resolve_device
from ..utils.profiling import annotate


def load_stage(path, name: str, device="cpu") -> Optional[nn.Module]:
    """Load one stage from an upstream `.pth` or a JAX package `.msgpack`
    checkpoint (dispatch on the extension: anything but `.pth` is a
    native checkpoint, as in the JAX package); None passes through. The
    `enhancer` (BS-RoFormer) loads from a `.pth` / `.ckpt` state dict under
    lucidrains's keys with its widths in the YAML beside it
    (models.bs_roformer.load_enhancer)."""
    if path is None:
        return None
    p = str(path)
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"{name} checkpoint not found: {p!r} - pass an upstream .pth or "
            f"a JAX .msgpack checkpoint, or disable the stage (--no-denoise/"
            f"--no-super-res/--no-stereo)")
    if name == "enhancer":
        from ..models.bs_roformer import load_enhancer

        return load_enhancer(p, device)
    if p.endswith(".pth"):
        return model_from_state_dict(name, load_pth(p), device)
    from ..train.checkpoints import load_native

    sd = state_dict_from_jax(name, *load_native(p))
    return model_from_state_dict(name, sd, device)


# pipeline attribute -> the model name load_stage takes
STAGE_MODELS = {"denoiser": "denoiser", "super_resolution": "super_resolution",
                "stereo": "stereo_separator", "enhancer": "enhancer"}


class Int8LengthGateError(ValueError):
    """The one per-recording int8 gate: a length off the packing grid
    (Int8State.check). Under whole_file a later recording may align, so
    restore() retries after it (its don't-retry flag keys on this type)."""


def _denoiser_packable(dn) -> bool:
    return (len(dn.encoder) == 3 and dn.encoder[0][0].in_channels == 1
            and dn.final_conv.out_channels == 1)


def _sr_packable(sr) -> bool:
    return (len(sr.upsample_blocks) >= 1 and sr.initial[0].in_channels == 1
            and sr.reconstruction.out_channels == 1)


def _upscale(sr) -> int:
    """The rate factor of an SR stage (1 without one): 2 an upsample block."""
    return 1 if sr is None else 2 ** len(sr.upsample_blocks)


def _bucket(n: int, granularity: int = 4) -> int:
    """Round the chunk count up to a multiple of `granularity`."""
    return max(granularity, ((n + granularity - 1) // granularity) * granularity)


def slab_plan(n_real: int, cap: int, granularity: int = 4):
    """(slabs, rows a slab) for `n_real` chunks at most `cap` rows a slab:
    the fewest slabs, ceil(n_real / cap), each of one size, the bucket of
    their even share of the chunks (at most `cap`). Every slab holds a real
    chunk, and the padding, all in the last slab, is under `granularity`
    rows a slab."""
    num_slabs = -(-n_real // cap)
    return num_slabs, min(cap, _bucket(-(-n_real // num_slabs), granularity))


def stereo_sub_cfg(cfg: PipelineConfig, stage_len: int, f: int,
                   sample_rate: Optional[int] = None):
    """The stereo stage's internal windows: (sub, hop, overlap) in samples
    at the stage's input rate, or None to run it on the whole stage input.

    The window is `stereo_chunk_seconds` at `sample_rate` (the rate of the
    audio being restored, default cfg.sample_rate) times the stage's rate
    factor f, rounded down to a multiple of 4 as the JAX package rounds it
    (so both compute the same windows); the overlap is `overlap_seconds`,
    at most a quarter of the window. A window that covers the stage input
    is no window at all."""
    if cfg.stereo_chunk_seconds is None:
        return None
    rate = sample_rate or cfg.sample_rate
    sub = int(round(cfg.stereo_chunk_seconds * rate * f))
    sub = max(4, (sub // 4) * 4)
    sub_ov = min(int(round(cfg.overlap_seconds * rate * f)), sub // 4)
    if sub >= stage_len:
        return None
    return (sub, sub - sub_ov, sub_ov)


def apply_stereo(st: nn.Module, x, sub_cfg, q=None, spread=None):
    """The stereo stage over [N, 1, T2] -> [N, 2, T2]. With `sub_cfg`
    (stereo_sub_cfg) each row is reframed into M windows, the model runs on
    the [N*M, 1, sub] batch (or `spread` runs it, over several devices)
    and each channel is crossfaded back. `q`, an int8 context
    (ops/quant.py), runs the packed int8 forward (or its calibration) where
    the window is a multiple of 4."""
    stage_len = sub_cfg[0] if sub_cfg is not None else x.shape[-1]
    if q is not None and stage_len % 4 == 0:
        st = partial(_ncw, stereo_mod.apply_packed, st, q=q)
    if sub_cfg is None:
        return st(x)
    sub, sub_hop, sub_ov = sub_cfg
    n, _, t2 = x.shape
    m = num_chunks(t2, sub, sub_hop)
    total2 = (m - 1) * sub_hop + sub
    rows = F.pad(x[:, 0, :], (0, total2 - t2))  # [N, total2]
    # frame_structured frames each of its "channels" (here the N rows):
    # [M, sub, N] -> [N*M, 1, sub], row-major in (n, m)
    frames = frame_structured(rows, m, sub, sub_hop)
    batch = frames.permute(2, 0, 1).reshape(n * m, 1, sub)
    y = (st if spread is None else spread)(batch)  # [N*M, 2, sub]
    y = y.reshape(n, m, 2, sub).permute(1, 0, 2, 3).reshape(m, n * 2, sub)
    out = overlap_add(y, sub_hop, t2, overlap=sub_ov)  # [N*2, T2]
    return out.reshape(n, 2, t2)


def _to_host(outs, into=None):
    """Start the copies of [(tensor, rate)] to host memory: into pinned
    buffers (`into`, one per output, or new ones), so each copy queues
    behind its program on the device's current stream without holding the
    host. Returns them with an event recorded after the copies (None on the
    CPU, where the outputs pass through), so the host can write an earlier
    batch while the card runs this one."""
    host, dev = [], None
    for i, (o, r) in enumerate(outs):
        if o.device.type == "cuda":
            dev = o.device
            buf = (into[i] if into is not None
                   and into[i].shape == o.shape and into[i].dtype == o.dtype
                   else torch.empty(o.shape, dtype=o.dtype, pin_memory=True))
            o = buf.copy_(o, non_blocking=True)
        host.append((o, r))
    event = None
    if dev is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    return host, event


def _ncw(fn, model, x, q, **kw):
    """The NWC int8 forward `fn` of `model` under the int8 context `q`, on
    an NCW [N, C, T] tensor."""
    return fn(model, x.permute(0, 2, 1), q=q, **kw).permute(0, 2, 1)


def combine_stereo(mid, y, f: int = 1, source_rate: bool = False,
                   mid_exact: bool = False, emit=slice(None)):
    """The one mid/side combine: a stage stack's output, f32, over the time
    slice `emit`, from the mid (the denoised and super-resolved [N, 1, T*f])
    and the stereo stage's output y ([N, 2, T*f], [N, 2, T] under
    source-rate; None without stereo): y itself, or under mid-exact the mid
    +/- the predicted side (the mid is the stage's input exactly), or under
    source-rate the same with the side upsampled by f over the whole of y,
    then sliced (the interpolation's clamped edges outside `emit`)."""
    mid = mid[..., emit]
    if y is None:
        return mid.float()
    if not source_rate:
        y = y[..., emit]
        if not mid_exact:
            return y.float()
    side = (y[:, 0:1] - y[:, 1:2]) * 0.5
    if source_rate:
        if f > 1:
            side = upsample_linear(side, f)
        side = side[..., emit].to(mid.dtype)
    return torch.cat([mid + side, mid - side], dim=1).float()


def _mono(audio, device):
    """[C, T] or [T], numpy or tensor -> [1, T] f32 on `device`, mixed
    down: the one mixdown of every restore entry. A pinned f32 host tensor
    uploads without holding the host (a pageable one waits for the
    device's queued work); the caller leaves it unchanged until the
    restore's output is ready."""
    if not torch.is_tensor(audio):
        audio = torch.from_numpy(np.asarray(audio, np.float32))
    audio = audio.to(device, torch.float32, non_blocking=audio.is_pinned())
    if audio.ndim == 1:
        audio = audio[None]
    if audio.shape[0] > 1:
        audio = audio.mean(dim=0, keepdim=True)
    return audio


def _framing(cfg: PipelineConfig, sample_rate: int):
    """(chunk, hop, overlap) in samples at `sample_rate`."""
    chunk_size = int(round(cfg.chunk_seconds * sample_rate))
    overlap = int(round(cfg.overlap_seconds * sample_rate))
    return chunk_size, chunk_size - overlap, overlap


def _crossfade(x, framing, f: int, valid):
    """One program's stack outputs [N, C_out, chunk*f] overlap-added."""
    chunk_size, hop, overlap = framing
    return overlap_add(x, hop * f, ((len(x) - 1) * hop + chunk_size) * f,
                       overlap=overlap * f, valid=valid)


def run_slabs(stack, audio, framing, f: int, cap: int, pad_end,
              granularity: int = 4, span=None):
    """The one slab loop: a recording [1, T] through `stack` (chunks
    [N, chunk, 1] -> [N, C_out, chunk*f] f32) -> [C_out, T*f]. The chunk
    count is bucketed to a multiple of `granularity`; a bucket past `cap`
    runs as balanced slabs (slab_plan), which share exactly `overlap` input
    samples, so their crossfade reproduces the single-shot one. `valid`
    masks the bucket padding, all of it in the last slab. `pad_end(audio,
    n)` extends the recording by n samples; `span` counts the real chunks
    (`rows_real`) and the chunk rows computed (`rows_run`)."""
    chunk_size, hop, overlap = framing
    t = audio.shape[1]
    n_real = num_chunks(t, chunk_size, hop)
    n = _bucket(n_real, granularity)
    num_slabs, s = (1, n) if n <= cap else slab_plan(n_real, cap,
                                                       granularity)
    if span is not None:
        span.count(rows_real=n_real, rows_run=num_slabs * s)
    slab_len = (s - 1) * hop + chunk_size
    needed = (num_slabs - 1) * s * hop + slab_len
    padded = pad_end(audio, needed - t)
    outs = [_crossfade(stack(frame_structured(
        padded[:, i * s * hop:i * s * hop + slab_len], s, chunk_size, hop)),
        framing, f, min(max(n_real - i * s, 0), s)) for i in range(num_slabs)]
    if n > cap:
        outs = [overlap_add(torch.stack(outs), s * hop * f, needed * f,
                            overlap=overlap * f)]
    return outs[0][:, :t * f]


class StageCopies:
    """The one owner of "stage S in compute dtype d on device v": the module
    itself in f32 on the device it lies on, else a copy (parallel.mesh.
    replica, then models.cast_model), made on first use and kept until
    `reset` (a hot reload). `source` maps a stage name to its module."""

    def __init__(self, source):
        self.source = source
        self.copies: dict = {}  # (stage, dtype, device) -> module

    def get(self, stage: str, dtype: torch.dtype, device):
        key = (stage, dtype, canonical(device))
        if key not in self.copies:
            self.copies[key] = cast_model(
                replica(self.source(stage), key[2]), dtype)
        return self.copies[key]

    def reset(self):
        self.copies = {}


class Int8State:
    """The int8 serving state that RestorationPipeline and
    StreamingRestorer hold: per-stage {point: scales} (one scales file
    format for both), a version, the int8 contexts keyed by it, the gates
    int8 must pass and the calibration pass that collects the scales."""

    def __init__(self):
        self.scales = None
        self.version = 0
        self.contexts: dict = {}

    def set(self, scales):
        """New scales (None: none) under a new version, with no contexts."""
        self.scales = scales
        self.version += 1
        self.contexts = {}
        return scales

    def save(self, path, missing: str):
        """Write the scales (ops/quant.py::save_scales_file, the JAX
        package's format), or assert `missing` without them."""
        from ..ops.quant import save_scales_file

        assert self.scales is not None, missing
        return save_scales_file(path, self.scales)

    def load(self, path):
        from ..ops.quant import load_scales_file

        return self.set(load_scales_file(path))

    def discard_uncovered(self, enabled: dict, when: str):
        """Discard scales that lack a stage enabled in `enabled` ({stage:
        bool}; they would raise KeyError inside the forward), with a
        warning; the entry then recalibrates on its `when`."""
        missing = [k for k, on in enabled.items() if on
                   and self.scales is not None and k not in self.scales]
        if missing:
            warnings.warn(
                f"int8 scales lack stage(s) {missing} — calibrated with "
                f"those stages disabled? Recalibrating on the {when}")
            self.set(None)

    @staticmethod
    def check(packed_off, dn, sr, length: int, entry: str = "serving",
              unit: str = "chunk", hint: str = ""):
        """Raise ValueError on what int8 cannot run: packed convs off
        (`packed_off` says how), an unpackable denoiser or SR checkpoint,
        or a `unit` length off the packing grid (Int8LengthGateError)."""
        if packed_off:
            raise ValueError(f"int8 {entry} rides the packed conv paths: "
                             f"{packed_off}")
        if dn is not None and not _denoiser_packable(dn):
            raise ValueError("denoiser checkpoint is not packable "
                             "(non-default layout); int8 unavailable")
        if sr is not None and not _sr_packable(sr):
            raise ValueError("super-resolution checkpoint is not packable "
                             "(non-default layout); int8 unavailable")
        if length % 4 != 0:
            raise Int8LengthGateError(
                f"int8 {entry} rides the packed path: {unit} length "
                f"{length} must be a multiple of 4{hint}")

    def calibrate(self, x, dn, sr, st=None, sub_cfg=None,
                  source_rate: bool = False):
        """Store and return the scales from one f32 pass of the packed
        forwards over x [N, T, 1]: the denoiser's, SR's and the stereo
        stage's amax (apply_stereo on `sub_cfg`), the stereo stage's on the
        denoised signal under source-rate stereo, else the super-resolved."""
        from ..ops.quant import QuantCtx, amax_to_host, scales_from_amax

        amax = {}

        def forward(stage, mod, model, v):
            q = QuantCtx()
            v = mod.apply_packed(model, v, q=q)
            amax[stage] = q.amax
            return v

        def stereo(v):
            q = QuantCtx()
            apply_stereo(st, v.permute(0, 2, 1), sub_cfg, q=q)
            amax["stereo"] = q.amax

        with torch.inference_mode():
            if dn is not None:
                x = forward("denoiser", denoiser_mod, dn, x)
            if st is not None and source_rate:
                stereo(x)
            if sr is not None:
                x = forward("super_resolution", sr_mod, sr, x)
            if st is not None and not source_rate:
                stereo(x)
        return self.set({stage: scales_from_amax(amax_to_host(d))
                         for stage, d in amax.items()})

    def ctx(self, stage: str, scope: str, dtype, device):
        """The int8 context of one stage on `device` (the denoiser's float
        layers skipped), built once per scales version, scope, compute dtype
        and device, so its folded, packed and quantized kernels are too.
        Every device takes the same scales."""
        from ..ops.quant import QuantCtx

        key = (stage, scope, dtype, self.version, canonical(device))
        if key not in self.contexts:
            self.contexts[key] = QuantCtx(
                self.scales[stage], scope, skip=denoiser_mod.INT8_FLOAT_LAYERS
                if stage == "denoiser" else frozenset())
        return self.contexts[key]


class _Stages(NamedTuple):
    """The stage stack of one device, in pieces: `front` (denoiser, SR),
    the stereo stage whole (`stereo`) or as encoder, LSTM and decoders
    (`encode`, `recur`, `decode`: the sequence-parallel path runs them on
    different devices), `combine` (mid-exact, source-rate) and the
    optional `enhance` (BS-RoFormer on the combined output). `stack`
    composes them over a chunk batch."""
    dn: Optional[nn.Module]
    sr: Optional[nn.Module]
    st: Optional[nn.Module]
    dtype: torch.dtype
    f: int
    src_rate: bool
    st_f: int  # stage-rate samples an input sample
    sub_cfg: Optional[tuple]
    int8: bool
    int8_stereo: bool
    q: dict  # stage -> its int8 context, or None
    mid_exact: bool
    en: Optional[nn.Module] = None

    def front(self, x, offset: int = 0, total: Optional[int] = None):
        """x NCW [N, 1, t] in the compute dtype, samples [offset, offset +
        t) of a chunk of `total` (default t) -> (mid: the denoised and
        super-resolved signal [N, 1, t*f]; the stereo stage's input: the
        mid, or under source-rate the denoised signal)."""
        if self.dn is not None:
            q = self.q["denoiser"]
            with annotate("restore.denoise", device_ms=True):
                x = (self.dn(x) if q is None
                     else _ncw(denoiser_mod.apply_packed, self.dn, x, q))
        st_in = x
        if self.sr is not None:
            q = self.q["super_resolution"]
            window = dict(offset=offset, total=total)
            with annotate("restore.super_resolution", device_ms=True):
                x = (self.sr(x, **window) if q is None else _ncw(
                    sr_mod.apply_packed, self.sr, x, q, **window))
        return x, (st_in if self.src_rate else x)

    def _stereo_input(self, v):
        # the int8 denoiser / SR exit in the compute dtype; the int8
        # stereo stage takes f32, as the JAX package hands it
        if self.int8:
            v = v.float() if self.int8_stereo else v.to(self.dtype)
        return v

    def _packed_stereo(self, v) -> bool:
        # apply_stereo's gate: int8 on a length the packing takes
        return self.q["stereo"] is not None and v.shape[-1] % 4 == 0

    def stereo(self, v, spread=None):
        """The stereo stage on its input [N, 1, T2] -> [N, 2, T2]."""
        with annotate("restore.stereo", device_ms=True):
            return apply_stereo(self.st, self._stereo_input(v), self.sub_cfg,
                                q=self.q["stereo"], spread=spread)

    def encode(self, v):
        """The stereo encoder on (a window of) its input -> [N, 4C, T2]."""
        v = self._stereo_input(v)
        if self._packed_stereo(v):
            return _ncw(stereo_mod.encode_packed, self.st, v,
                        self.q["stereo"])
        return self.st.encode(v)

    def recur(self, h):
        """The stereo LSTM over the encoder output -> [N, H, T2]."""
        if self._packed_stereo(h):
            return stereo_mod.lstm_packed(self.st, h.permute(0, 2, 1)
                                          ).permute(0, 2, 1)
        return self.st.recur(h)

    def decode(self, h):
        """The stereo decoders on (a window of) the LSTM output ->
        [N, 2, T2]."""
        if self._packed_stereo(h):
            return _ncw(stereo_mod.decode_packed, self.st, h,
                        self.q["stereo"])
        return self.st.decode(h)

    def combine(self, mid, y):
        """The stack's output from the mid and the stereo stage's output
        (None without stereo): [N, C_out, T*f] f32 (combine_stereo)."""
        return combine_stereo(mid, y, self.f, self.src_rate, self.mid_exact)

    def enhance(self, x):
        """The enhancer on the combined output [N, C_out, T] f32 -> the
        same shape, f32. Its span counts the tokens each of its
        transformers attends over (rows x STFT frames x bands) and the
        TF32x3 GEMM's launches in the forward (`gemm_launches`: 4 a
        transformer on a CUDA f32 forward, else 0)."""
        tokens = self.en.num_tokens(x.shape[0], x.shape[-1])
        with annotate("restore.enhance", device_ms=True,
                      tokens=tokens) as span:
            before = gemm.gemm_launch_count
            out = self.en(x.to(self.dtype)).float()
            span.count(gemm_launches=gemm.gemm_launch_count - before)
            return out

    def stack(self, chunks):
        """The whole stack on a chunk batch [N, chunk, 1] -> [N, C_out,
        chunk*f] f32."""
        mid, st_in = self.front(chunks.permute(0, 2, 1).to(self.dtype))
        out = self.combine(mid, None if self.st is None
                           else self.stereo(st_in))
        return out if self.en is None else self.enhance(out)


class RestorationPipeline:
    """Holds the three stage models (any may be None) and the optional
    fourth, the enhancer, on one device, and serves on it or, under a
    mesh, on the mesh's devices."""

    def __init__(self, denoiser: Optional[nn.Module] = None,
                 super_resolution: Optional[nn.Module] = None,
                 stereo: Optional[nn.Module] = None,
                 config: Optional[PipelineConfig] = None,
                 device="cuda", mesh=None,
                 enhancer: Optional[nn.Module] = None):
        """`mesh`: a parallel.mesh.Mesh; the chunk batch is sharded over
        its 'data' axis and each chunk's time over its 'model' axis. It
        may also be assigned to `pipe.mesh` later (the
        CLI does): every cache below is keyed by device, and the stage
        stack is built for the mesh of each call. `enhancer`: a
        models.BSRoformer of one stem run on every chunk's output after
        the stereo stage (`_Stages.enhance`); it takes as many channels as
        the pipeline puts out, and no int8 or 'model' mesh axis."""
        self.config = config or PipelineConfig()
        check_pipeline_config(self.config)
        self.device = resolve_device(device)
        self.mesh = mesh
        no_tf32()
        self.denoiser, self.super_resolution, self.stereo, self.enhancer = (
            None if m is None else m.to(self.device).eval()
            for m in (denoiser, super_resolution, stereo, enhancer))
        self._check_enhancer(self.enhancer, self.stereo)
        self._copies = StageCopies(partial(getattr, self))
        self._warmed: set = set()  # stack shapes warmup has run
        # int8 serving: its scales and contexts, and the don't-retry flag
        # of a gate that can never pass
        self._int8 = Int8State()
        self._int8_failed = False

    @classmethod
    def from_checkpoints(cls, denoiser_path=None, super_res_path=None,
                         stereo_path=None, config=None, device="cuda",
                         enhancer_path=None):
        """Load the stages from upstream `.pth` or JAX `.msgpack`
        checkpoints, and the enhancer from its state dict and YAML
        (load_stage)."""
        dev = resolve_device(device)
        return cls(denoiser=load_stage(denoiser_path, "denoiser", dev),
                   super_resolution=load_stage(super_res_path,
                                               "super_resolution", dev),
                   stereo=load_stage(stereo_path, "stereo_separator", dev),
                   config=config, device=dev,
                   enhancer=load_stage(enhancer_path, "enhancer", dev))

    def reload_stages(self, paths: dict) -> list:
        """Hot swap of stage checkpoints: {attribute: path}, the attributes
        being `denoiser`, `super_resolution`, `stereo` and `enhancer`. Every
        stage is loaded (load_stage) onto the pipeline's device in eval mode
        and the enhancer checked against the stages it joins before any is
        swapped, so a bad path leaves the pipeline as it was. The
        compute-dtype models on every device (StageCopies: in f32 on the
        pipeline's device the old modules themselves, elsewhere copies of
        them) and the int8 contexts of every device go with the old
        weights, and int8 calibration, which depends on the weights,
        starts over. Returns the swapped attributes, sorted."""
        loaded = {name: load_stage(path, STAGE_MODELS[name], self.device)
                  for name, path in paths.items()}
        stages = {name: getattr(self, name) for name in STAGE_MODELS}
        stages.update(loaded)
        self._check_enhancer(stages["enhancer"], stages["stereo"])
        for name, model in loaded.items():
            setattr(self, name, model.eval())
        self._copies.reset()
        self._int8.set(None)
        self._int8_failed = False
        return sorted(loaded)

    def _check_enhancer(self, enhancer, stereo):
        """Raise ValueError where the enhancer cannot join the stack: more
        than one stem, channels other than the stack puts out, int8
        serving, or a mesh whose 'model' axis splits each chunk's time
        (the transformers attend over the whole chunk)."""
        if enhancer is None:
            return
        out_channels = 2 if stereo is not None else 1
        problem = None
        if enhancer.num_stems != 1:
            problem = f"it has {enhancer.num_stems} stems, the stage one"
        elif enhancer.audio_channels != out_channels:
            problem = (f"it takes {enhancer.audio_channels} channel(s) and "
                       f"the stages before it put out {out_channels}")
        elif self.config.quantize_int8:
            problem = "int8 serving (quantize_int8) does not cover it"
        elif self.mesh is not None and self.mesh.shape["model"] > 1:
            problem = ("a mesh 'model' axis above 1 splits each chunk's "
                       "time, and it attends over the whole chunk")
        if problem:
            raise ValueError(f"the enhancer stage cannot run: {problem}")

    @property
    def _has_sr(self) -> bool:
        return (self.super_resolution is not None
                and self.config.enable_super_resolution)

    @property
    def upscale_factor(self) -> int:
        return _upscale(self.super_resolution if self._has_sr else None)

    @property
    def out_channels(self) -> int:
        return 2 if self.stereo is not None else 1

    def _models(self, device=None, names=("denoiser", "super_resolution",
                                           "stereo")):
        """The stages `names` in the compute dtype on `device` (default the
        pipeline's), from StageCopies; super-resolution is None where it
        is switched off."""
        return tuple(None if name == "super_resolution" and not self._has_sr
                     else self._copies.get(
                         name, getattr(torch, self.config.compute_dtype),
                         self.device if device is None else device)
                     for name in names)

    def _stereo_layout(self, chunk_size: int, sample_rate: Optional[int]):
        """(source-rate, stage-rate samples an input sample, sub-windows) of
        the stereo stage at `chunk_size`: source-rate stereo takes the pre-SR
        signal, and only its side is upsampled around the SR output."""
        if self.stereo is None:
            return False, self.upscale_factor, None
        src_rate = self.config.stereo_source_rate
        st_f = 1 if src_rate else self.upscale_factor
        return src_rate, st_f, stereo_sub_cfg(
            self.config, chunk_size * st_f, st_f, sample_rate=sample_rate)

    def _granularity(self) -> int:
        """The chunk-count bucket: a multiple of 4, and of the mesh's data
        axis, so every bucket splits evenly over it (as in the JAX
        package)."""
        if self.mesh is None:
            return 4
        return math.lcm(4, self.mesh.shape["data"])

    def _stage_stack(self, chunk_size: int,
                     sample_rate: Optional[int] = None):
        """The per-chunk model stack: fn(chunks [N, chunk, 1] f32 on the
        pipeline's device) -> [N, C_out, chunk*f] f32 there. Every option
        lives here, so `restore` and `restore_many` compute the same
        function. `sample_rate` is the rate of the audio in the chunks (it
        sizes the stereo sub-window). Checks the config again: a caller may
        have set a field since.

        Under a mesh the batch is split over its 'data' axis (shard_batch),
        each shard runs the stack of its device, and the outputs are
        gathered here. Every shard is enqueued before any output is
        gathered, and nothing in the stack reads the device from the host,
        so the devices run together. A batch with fewer rows than the mesh
        has devices (whole_file's one chunk) runs on the first ones. A mesh
        whose 'model' axis is above 1 also splits each chunk's time over
        its row (_sequence_stack)."""
        check_pipeline_config(self.config)
        self._check_enhancer(self.enhancer, self.stereo)
        if self.mesh is None:
            return self._device_stages(self.device, chunk_size,
                                       sample_rate).stack
        if self.mesh.shape["model"] > 1:
            return self._sequence_stack(chunk_size, sample_rate)
        devices = self.mesh.data_devices
        stacks = {d: self._device_stages(d, chunk_size, sample_rate).stack
                  for d in dict.fromkeys(devices)}
        gather = dict(non_blocking=self.device.type == "cuda")

        def sharded(chunks):
            outs = [stacks[d](part) for d, part in zip(
                devices, shard_batch(self.mesh, chunks)) if len(part)]
            return torch.cat([o.to(self.device, **gather) for o in outs])

        return sharded

    def _sequence_stack(self, chunk_size: int, sample_rate: Optional[int]):
        """_stage_stack under a mesh with model > 1: sequence parallelism,
        JAX's P("data", "model", None). The chunk batch is split over the
        data rows; in each row the chunks' time is cut into cores on the
        stages' grid (parallel.mesh.time_shards), one a device of the row
        (fewer when the chunk is shorter than the row's grid units), and:

        1. the stages in front of the LSTM (denoiser, SR, stereo encoder)
           run on each core's window (parallel.sequence: one input halo
           for all three), on its device, cropped to the core;
        2. time is gathered on the row's first device, which runs the
           LSTM (K1 on the card) over the whole chunk;
        3. the decoders run on windows of the LSTM output, one a device,
           cropped and gathered; mid-exact and source-rate combine the
           gathered stereo output with the gathered mid elementwise there.
           Sub-chunked stereo gathers its input instead and spreads its
           windows over the row's devices.

        Every window of every row is enqueued before any output is
        gathered, and nothing reads the device from the host."""
        from ..parallel import sequence
        from ..parallel.mesh import time_shards

        stages = {d: self._device_stages(d, chunk_size, sample_rate)
                  for d in dict.fromkeys(self.mesh.flat_devices)}
        one = stages[self.mesh.data_devices[0]]
        has_st, sub = one.st is not None, one.sub_cfg is not None
        plan = sequence.plan(one.dn, one.sr, one.st,
                             source_rate=one.src_rate, stereo_windows=sub,
                             packed=one.int8)
        f, st_f, t = one.f, one.st_f, chunk_size
        front_w = sequence.windows(time_shards(self.mesh, t, plan.grid),
                                   plan.front_halo, t)
        back_w = sequence.windows([(w.lo * st_f, w.hi * st_f)
                                   for w in front_w], plan.back_halo,
                                  t * st_f)
        gather = dict(non_blocking=self.device.type == "cuda")

        def cat_on(dev, parts):
            return torch.cat([p.to(dev, **gather) for p in parts], dim=-1)

        def row_front(row, x):
            """Step 1 on every window of one row's chunks [n, 1, t]."""
            mids, ins = [], []
            for dev, w in zip(row, front_w):
                g = stages[dev]
                xw = x[..., w.start:w.stop].to(dev, **gather).to(g.dtype)
                mid, st_in = g.front(xw, offset=w.start, total=t)
                mids.append(sequence.crop(mid, w, f))
                if has_st:
                    ins.append(sequence.crop(
                        st_in if sub else g.encode(st_in), w, st_f))
            return mids, ins

        def spread(row):
            """The sub-chunked stereo windows [M, 1, sub] over the row."""
            def run(batch):
                outs = [stages[dev].st(part.to(dev, **gather))
                        for dev, part in zip(row, torch.tensor_split(
                            batch, len(row))) if len(part)]
                return torch.cat([o.to(row[0], **gather) for o in outs])
            return run

        def sharded(chunks):
            rows = [(row, part.permute(0, 2, 1)) for row, part in zip(
                self.mesh.rows, torch.tensor_split(
                    chunks, self.mesh.shape["data"])) if len(part)]
            fronts = [row_front(row, x) for row, x in rows]
            outs = []
            for (row, _), (mids, ins) in zip(rows, fronts):
                d0, g0 = row[0], stages[row[0]]
                mid = cat_on(d0, mids)
                y = None
                if has_st and sub:
                    y = g0.stereo(cat_on(d0, ins), spread=spread(row))
                elif has_st:
                    h = g0.recur(cat_on(d0, ins))
                    ys = [sequence.crop(stages[dev].decode(
                        h[..., w.start:w.stop].to(dev, **gather)), w)
                          for dev, w in zip(row, back_w)]
                    y = cat_on(d0, ys)
                outs.append(g0.combine(mid, y))
            return torch.cat([o.to(self.device, **gather) for o in outs])

        return sharded

    def _device_stages(self, device, chunk_size: int,
                       sample_rate: Optional[int]):
        """The stage stack's pieces on one device: its models and int8
        contexts, tensors on that device (_Stages)."""
        cfg = self.config
        dn, sr, st, en = self._models(device, (
            "denoiser", "super_resolution", "stereo", "enhancer"))
        src_rate, st_f, sub_cfg = self._stereo_layout(chunk_size,
                                                      sample_rate)
        # int8 rides the packed forwards, so it takes their gate, and needs
        # scales (restore() calibrates first); the stereo stage runs int8 on
        # whole windows only, as in the JAX package
        packed = (cfg.packed_convs and chunk_size % 4 == 0
                  and (dn is None or _denoiser_packable(dn))
                  and (sr is None or _sr_packable(sr)))
        int8 = cfg.quantize_int8 and packed and self._int8.scales is not None
        int8_stereo = int8 and sub_cfg is None
        q = dict.fromkeys(("denoiser", "super_resolution", "stereo"))
        for name, model in (("denoiser", dn), ("super_resolution", sr),
                            ("stereo", st if int8_stereo else None)):
            if int8 and model is not None:
                q[name] = self._int8.ctx(name, cfg.int8_scope,
                                         cfg.compute_dtype, device)
        return _Stages(dn, sr, st, getattr(torch, cfg.compute_dtype),
                       self.upscale_factor, src_rate, st_f, sub_cfg, int8,
                       int8_stereo, q, cfg.stereo_mid_exact, en)

    def _pad_end(self, audio, n: int):
        """[C, T] with n samples after its end, where the last chunk (and
        any slab padding) runs past the recording: zeros; with an enhancer,
        the recording reflected about its last sample (period 2(T-1)), as
        upstream BS-RoFormer inference pads a short last part. Its per-band
        RMSNorm scales a band to unit RMS whatever its energy, so the
        rounding noise of a silent tail's bands would become unit-scale
        features that attention spreads over the whole chunk."""
        if self.enhancer is None or n <= 0:
            return F.pad(audio, (0, n))
        t = audio.shape[-1]
        period = max(2 * (t - 1), 1)
        m = torch.arange(t, t + n, device=audio.device) % period
        return torch.cat([audio, audio[:, torch.where(m < t, m, period - m)]],
                         dim=1)

    @torch.inference_mode()
    def restore(self, audio, sample_rate: Optional[int] = None):
        """audio [C, T] (mixed to mono if C > 1), numpy or tensor ->
        (tensor [out_ch, T*f] on the pipeline's device, out_rate). Its
        span, `restore`, counts the real chunks (`rows_real`) and the chunk
        rows computed (`rows_run`: the bucket, or the slabs' rows)."""
        with annotate("restore") as span:
            return self._restore(audio, sample_rate, span)

    def _restore(self, audio, sample_rate, span):
        cfg = self.config
        sample_rate = sample_rate or cfg.sample_rate
        audio = _mono(audio, self.device)
        self._ensure_int8(audio, sample_rate)
        t = audio.shape[1]
        framing = (t, t, 0) if cfg.whole_file else _framing(cfg, sample_rate)
        stack = self._stage_stack(framing[0], sample_rate)
        out = run_slabs(stack, audio, framing, self.upscale_factor,
                        max(cfg.max_chunks_per_program, 4), self._pad_end,
                        1 if cfg.whole_file else self._granularity(), span)
        return out, sample_rate * self.upscale_factor

    @torch.inference_mode()
    def restore_many(self, audios, sample_rate: Optional[int] = None):
        """Coalesced restore of several recordings: their chunk frames are
        packed one after another into one chunk batch, the model stack runs
        once over it, and each recording is crossfaded from its own rows.
        Returns [(tensor [out_ch, T_i*f], rate)] in input order, each equal
        to `restore(audios[i])` up to the convolutions' batch-size-dependent
        summation order: the stack is the same function (`_stage_stack`)
        and rows outside a recording (bucket padding, or a neighbour's
        chunks that its bucketed slice overhangs) get zero crossfade weight.

        Groups are capped at `max_chunks_per_program` rows counted on the
        bucketed coverage (a group such as [61, 2] chunks at 64 splits);
        a recording whose own bucket exceeds the cap, and a group of one,
        take `restore`."""
        cfg = self.config
        audios = list(audios)
        if not audios:
            return []
        sample_rate = sample_rate or cfg.sample_rate
        if cfg.whole_file or len(audios) == 1:
            return [self.restore(a, sample_rate) for a in audios]

        f = self.upscale_factor
        framing = _framing(cfg, sample_rate)
        chunk_size, hop, _ = framing
        prepped = [_mono(a, self.device) for a in audios]
        self._ensure_int8(prepped[0], sample_rate)
        max_n = max(cfg.max_chunks_per_program, 4)
        gran = self._granularity()
        metas = []  # (n_real, n_bucket) per recording
        solo = []  # too long to coalesce: restore() with its slabs
        # cur_cover is max(offset_i + n_bucket_i): the combined batch must
        # cover every member's bucketed slice, so the cap applies to that
        groups, cur, cur_n, cur_cover = [], [], 0, 0
        for i, x in enumerate(prepped):
            n_real = num_chunks(x.shape[1], chunk_size, hop)
            metas.append((n_real, _bucket(n_real, gran)))
            if metas[i][1] > max_n:
                solo.append(i)
                continue
            cover = max(cur_cover, cur_n + metas[i][1])
            if cur and _bucket(max(cur_n + n_real, cover), gran) > max_n:
                groups.append(cur)
                cur, cur_n = [], 0
                cover = metas[i][1]
            cur.append(i)
            cur_n += n_real
            cur_cover = cover
        if cur:
            groups.append(cur)

        results: list = [None] * len(audios)
        for i in solo:
            results[i] = self.restore(prepped[i], sample_rate)
        stack = self._stage_stack(chunk_size, sample_rate)
        for grp in groups:
            if len(grp) == 1:
                results[grp[0]] = self.restore(prepped[grp[0]], sample_rate)
                continue
            offs, rows = [], 0
            for i in grp:
                offs.append(rows)
                rows += metas[i][0]
            n_total = _bucket(max(rows, max(o + metas[i][1]
                                            for o, i in zip(offs, grp))),
                              gran)
            # each member framed as restore frames it, the rows one after
            # another, zero rows up to the bucket
            frames = []
            for i in grp:
                n_real, x = metas[i][0], prepped[i]
                total = (n_real - 1) * hop + chunk_size
                frames.append(frame_structured(
                    self._pad_end(x, total - x.shape[1]), n_real, chunk_size,
                    hop))
            frames.append(torch.zeros((n_total - rows, chunk_size, 1),
                                      device=self.device))
            big = stack(torch.cat(frames))
            for o, i in zip(offs, grp):
                n_real, nb = metas[i]
                out = _crossfade(big[o:o + nb], framing, f, n_real)
                t = prepped[i].shape[1]
                results[i] = (out[:, :t * f], sample_rate * f)
        return results

    def restore_file(self, input_path, output_path,
                     sample_rate: Optional[int] = None,
                     normalize: bool = True):
        """File to file: load (any of AUDIO_EXTENSIONS; mono, resampled),
        normalize, restore, normalize the output and save it in the
        container its extension names (16-bit WAV or FLAC, mp3, ogg)."""
        sr_in = sample_rate or self.config.sample_rate
        audio, _ = load_audio(input_path, sample_rate=sr_in, mono=True)
        if normalize:
            audio = normalize_audio(audio)
        restored, out_rate = self.restore(audio, sr_in)
        save_audio(output_path, normalize_audio(restored.cpu().numpy()),
                   out_rate)
        return output_path, out_rate

    def restore_directory(self, input_dir, output_dir,
                          sample_rate: Optional[int] = None,
                          suffix: str = "_restored",
                          normalize: bool = True,
                          coalesce: int = 4):
        """Restore every audio file in `input_dir` (WAV, FLAC, mp3, ogg; not
        recursive) into `output_dir` as `<stem><suffix>.wav`, as the JAX
        package names them, files equal to restore_file's.

        `coalesce` files go to the card as one batch (`restore_many`; 1 =
        one `restore` a file). One thread decodes the next batch while the
        card runs this one, and the outputs of the batch before are copied
        back and written meanwhile. Returns [(path, rate)] in file order."""
        from concurrent.futures import ThreadPoolExecutor
        from pathlib import Path

        sr_in = sample_rate or self.config.sample_rate
        out_dir = Path(output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        files = find_audio_files(input_dir, recursive=False)
        if not files:
            return []
        step = max(1, int(coalesce))
        groups = [files[i:i + step] for i in range(0, len(files), step)]

        def load(fs):
            out = []
            for path in fs:
                audio, _ = load_audio(path, sample_rate=sr_in, mono=True)
                out.append(normalize_audio(audio) if normalize else audio)
            return out

        results = []
        pending: list = []  # (paths, host outputs, event) awaiting write

        def write_pending():
            while pending:
                # pop before writing: a failed write is not retried
                paths, host, event = pending.pop(0)
                if event is not None:
                    event.synchronize()
                for path, (out, rate) in zip(paths, host):
                    save_audio(path, normalize_audio(out.numpy()), rate)
                    results.append((path, rate))

        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(load, groups[0])
            try:
                for gi, grp in enumerate(groups):
                    audios = fut.result()
                    if gi + 1 < len(groups):
                        fut = ex.submit(load, groups[gi + 1])
                    outs = (self.restore_many(audios, sr_in)
                            if len(audios) > 1
                            else [self.restore(audios[0], sr_in)])
                    host = _to_host(outs)
                    write_pending()
                    pending.append(([out_dir / f"{p.stem}{suffix}.wav"
                                     for p in grp], *host))
            finally:
                # a failure on one batch keeps the outputs of the batch
                # before it
                write_pending()
        return results

    # ------------------------------------------------------- int8 serving
    def calibrate_int8(self, audio, sample_rate: Optional[int] = None,
                       max_chunks: int = 8):
        """Collect the per-point activation scales of int8 serving from one
        f32 pass of the f32 models over up to `max_chunks` chunks of
        `audio`, framed as restore() frames it (source-rate stereo on the
        pre-SR signal). Stores and returns {stage: {point: scales}}. Raises
        ValueError on a gate int8 cannot pass (Int8LengthGateError for a
        whole_file length off the packing grid)."""
        cfg = self.config
        sample_rate = sample_rate or cfg.sample_rate
        sr = self.super_resolution if self._has_sr else None
        audio = _mono(audio, self.device)
        t = audio.shape[1]
        chunk_size, hop, _ = _framing(cfg, sample_rate)
        if cfg.whole_file:
            chunk_size = t
            hop = t - int(round(cfg.overlap_seconds * sample_rate))
        self._int8.check(None if cfg.packed_convs
                         else "config.packed_convs is off",
                         self.denoiser, sr, chunk_size)
        n = min(max(num_chunks(t, chunk_size, hop), 1), max_chunks)
        total = (n - 1) * hop + chunk_size
        audio = F.pad(audio, (0, max(total - t, 0)))[:, :total]
        src_rate, _, sub_cfg = self._stereo_layout(chunk_size, sample_rate)
        return self._int8.calibrate(
            frame_structured(audio, n, chunk_size, hop), self.denoiser, sr,
            self.stereo, sub_cfg, src_rate)

    def save_int8_scales(self, path):
        """Write the scales (Int8State.save) for later processes."""
        return self._int8.save(path, "calibrate_int8 first")

    def load_int8_scales(self, path):
        scales = self._int8.load(path)
        self._int8_failed = False  # new scales: give int8 another try
        return scales

    def _int8_uncalibrated(self) -> bool:
        """Under quantize_int8: discard loaded scales that lack an enabled
        stage (an SR checkpoint under enable_super_resolution=False is not
        enabled), then whether calibration is due: no scales, and no gate
        has failed for good."""
        if not self.config.quantize_int8:
            return False
        enabled = {"denoiser": self.denoiser is not None,
                   "super_resolution": self._has_sr,
                   "stereo": self.stereo is not None}
        self._int8.discard_uncovered(enabled, "next recording")
        return self._int8.scales is None and not self._int8_failed

    def _ensure_int8(self, audio, sample_rate):
        """Before a restore: calibrate on this recording where it is due.
        A gate failure warns and serves float; only whole_file's length
        gate is retried on the next recording."""
        if self._int8_uncalibrated():
            try:
                self.calibrate_int8(audio, sample_rate)
            except ValueError as e:
                warnings.warn(f"int8 serving disabled: {e}")
                self._int8_failed = not (self.config.whole_file and isinstance(
                    e, Int8LengthGateError))

    def warmup(self, coalesce: int = 1,
               sample_rate: Optional[int] = None) -> dict:
        """Run zero audio through every chunk-count bucket before traffic
        arrives: the CUDA kernels are built and loaded, cuDNN picks its
        algorithms for each batch shape and the caching allocator grows to
        the largest, so a first request pays none of it, on every device of
        the mesh. The buckets run in steps of the granularity (4, or
        lcm(4, data) under a mesh) up to `max_chunks_per_program`, and
        every slab size is one of the buckets (slab_plan); with `coalesce`
        > 1 the coalesced stack runs at each too.

        `whole_file` mode has one shape per recording length: a no-op with
        a warning. So is `quantize_int8` with no scales loaded (the first
        recording calibrates; warm after load_int8_scales or
        calibrate_int8), after discarding scales that lack an enabled
        stage. Returns {"programs": shapes run for the first time,
        "seconds": wall, "buckets": the chunk counts covered}."""
        cfg = self.config
        if cfg.whole_file:
            warnings.warn("warmup is a no-op in whole_file mode: programs "
                          "are compiled per recording length")
            return {"programs": 0, "seconds": 0.0, "buckets": []}
        if self._int8_uncalibrated():
            warnings.warn(
                "warmup skipped: quantize_int8 is set but no scales are "
                "loaded — the first recording calibrates. "
                "load_int8_scales() or calibrate_int8() on a representative "
                "recording first")
            return {"programs": 0, "seconds": 0.0, "buckets": []}
        t0 = time.monotonic()
        if self.device.type == "cuda":
            from ..ops import _build

            _build.load("lstm_recurrence")
            _build.load("conv_epilogue")
            if cfg.quantize_int8 and self._int8.scales is not None:
                _build.load("int8_conv")
        sample_rate = sample_rate or cfg.sample_rate
        framing = _framing(cfg, sample_rate)
        chunk_size, hop, _ = framing
        max_n = max(cfg.max_chunks_per_program, 4)
        gran = self._granularity()
        buckets = sorted({*range(gran, max_n + 1, gran), max_n})
        before = len(self._warmed)
        stack = self._stage_stack(chunk_size, sample_rate)
        grid = ((self.device,),) if self.mesh is None else self.mesh.devices
        key = (cfg.compute_dtype, self._int8.version, grid)
        with torch.inference_mode():
            for n in buckets:
                total = (n - 1) * hop + chunk_size
                zeros = torch.zeros((1, total), device=self.device)
                _crossfade(stack(frame_structured(zeros, n, chunk_size, hop)),
                           framing, self.upscale_factor, n)
                self._warmed.add(("rec", n, chunk_size, hop, sample_rate)
                                 + key)
                if coalesce > 1:
                    stack(torch.zeros((n, chunk_size, 1), device=self.device))
                    self._warmed.add(("chunks", n, chunk_size, sample_rate)
                                     + key)
        for dev in dict.fromkeys(d for row in grid for d in row):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return {"programs": len(self._warmed) - before,
                "seconds": time.monotonic() - t0, "buckets": buckets}


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
