"""Streaming (block-by-block) restoration with exact recurrent state.

Counterpart of ml_audio_restoration_tpu/pipeline/streaming.py. A recording
is fed in blocks of any size as they arrive, and the output matches the
single-shot forward everywhere but the first `context` samples:

- the convolutional stages (denoiser, SR, the stereo encoder and decoders)
  get `context` samples of history recomputed before each block and
  `lookahead` samples held back after it, so every emitted sample sees its
  whole receptive field;
- the stereo LSTM consumes each feature frame once, its (h, c) carried from
  feed to feed through K1's carry in and out; a second, speculative K1 run
  over the lookahead frames starts from the new carry and is not kept.

    s = StreamingRestorer(denoiser=dn, super_resolution=sr, stereo=st)
    for block in blocks:          # any block sizes
        out.append(s.feed(block)) # [2, n*f] as samples become final
    out.append(s.flush())

`batch=B` runs B lockstep streams as one batch (the LSTM batch dimension);
outputs are then [B, ch, n*f], and each stream's output equals a
single-stream restorer's fed the same samples. With `mesh=` (parallel/
mesh.py) the streams are split evenly over the mesh's 'data' axis: each
data row's first device runs its own streams with its copy of the models
and holds their LSTM carries and decoder history, and the outputs are
gathered on the restorer's device. A 'model' axis above 1 leaves the rest
of each row idle: the JAX package shards the stream batch over 'data' and
replicates it over 'model', which computes the same output.

`quantize_int8=True` runs the denoiser and SR through their packed int8
forwards (scope "packed"; the stereo stage stays float), with scales that
calibrate on the first drained window (the whole batch, on the restorer's
device; every shard quantizes with them) unless `int8_scales` (a dict, or a
path written by either serving object: one file format) gives them. A gate
int8 cannot pass (packed=False, an unpackable checkpoint, a window off the
packing grid) warns and serves float.
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import COMPUTE_DTYPES, SERVING_LSTM_IMPLS
from ..models import cast_model
from ..models import denoiser as denoiser_mod
from ..models import super_resolution as sr_mod
from ..ops import upsample_linear
from ..ops.lstm import stacked_lstm
from ..parallel.mesh import canonical, replica
from .restore import (_denoiser_packable, _sr_packable, load_stage, no_tf32,
                      resolve_device)


class StreamingRestorer:
    """Stateful block-wise denoise -> super-res -> stereo."""

    def __init__(self, denoiser=None, super_resolution=None, stereo=None,
                 context: int = 1024, lookahead: int = 512, batch: int = 1,
                 mid_exact: bool = False, packed: bool = True,
                 source_rate: bool = False, quantize_int8: bool = False,
                 int8_scales=None, mesh=None,
                 lstm_impl: Optional[str] = None,
                 compute_dtype: str = "float32", device="cuda"):
        """context/lookahead in input-rate samples; both must exceed the
        convolutions' receptive field (~400 samples for the default
        models). batch: the number of lockstep streams. mid_exact mirrors
        PipelineConfig.stereo_mid_exact (out = mid +/- the predicted side),
        source_rate PipelineConfig.stereo_source_rate (the stereo stage on
        the pre-SR signal, its side upsampled around the exact SR mid; it
        implies mid-exact). compute_dtype "bfloat16" runs bf16 copies of
        the models; K1 keeps its state in f32, the carries cross feeds in
        bf16 and the emitted audio is f32. `quantize_int8` runs the
        denoiser and SR int8 (module docstring), `int8_scales` preloads
        their scales (a dict or a scales file); `packed=False` disables
        int8 (a warning, then float) and is otherwise ignored, as is
        `lstm_impl` (None, "scan" or "pallas"). `mesh` shards the streams
        over its 'data' axis (each row's first device); `batch` must
        divide evenly over it."""
        if mesh is not None and int(batch) % mesh.shape["data"]:
            raise ValueError(
                f"batch {batch} must divide evenly over the 'data' mesh "
                f"axis ({mesh.shape['data']} devices)")
        if lstm_impl not in SERVING_LSTM_IMPLS:
            raise ValueError(
                f"lstm_impl must be pallas|scan|None, got {lstm_impl!r}")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be float32|bfloat16, got "
                             f"{compute_dtype}")
        self.device = resolve_device(device)
        no_tf32()
        self.compute_dtype = getattr(torch, compute_dtype)
        self.denoiser, self.super_resolution, self.stereo = (
            None if m is None else m.to(self.device).eval()
            for m in (denoiser, super_resolution, stereo))
        self._dn, self._sr, self._st = (
            cast_model(m, self.compute_dtype)
            for m in (self.denoiser, self.super_resolution, self.stereo))
        self.batch = int(batch)
        # the shards: (device, first stream, end stream), one a data device
        # of the mesh, each with its device's copies of the models
        devices = ([canonical(self.device)] if mesh is None
                   else mesh.data_devices)
        per = self.batch // len(devices)
        self._shards = [(dev, k * per, (k + 1) * per)
                        for k, dev in enumerate(devices)]
        self._replicas = {dev: tuple(replica(m, dev) for m in (
            self._dn, self._sr, self._st)) for dev in dict.fromkeys(devices)}
        self.mid_exact = bool(mid_exact)
        self.source_rate = bool(source_rate)
        self.packed = bool(packed)
        self.quantize_int8 = bool(quantize_int8)
        self._int8_scales = None
        self._int8_version = 0
        self._int8_ready = False  # gates not yet run on a drained window
        self._qctx: dict = {}  # (scales version, device) -> (dn, SR) ctxs
        if int8_scales is not None:
            if isinstance(int8_scales, dict):
                self._int8_scales = int8_scales
            else:
                self.load_int8_scales(int8_scales)
        # the U-Net pools by 8, so window starts stay on the pooling grid
        # (the model is shift-variant modulo 8): context and emission
        # lengths are kept multiples of the alignment
        self._align = 8 if denoiser is not None else 1
        self.context = -(-context // self._align) * self._align
        self.lookahead = lookahead
        self.f = (2 ** len(self.super_resolution.upsample_blocks)
                  if self.super_resolution is not None else 1)
        # rate factor at the stereo stage: 1 on the pre-SR signal
        self._g = 1 if self.source_rate else self.f
        # window lengths the step ran: the convolutions' shapes, for which
        # cuDNN builds its plans (K1 costs nothing per shape)
        self._shapes: set = set()
        self.reset()

    def reset(self):
        """Forget every stream: no history, zero LSTM state. The carries
        and decoder history are per shard, on its device."""
        self._in_buffer = np.zeros((self.batch, 0), np.float32)  # unemitted
        self._warm = 0  # samples of valid history in front of the buffer
        self._fed = 0
        self._emitted = 0
        self._dec_hist_buf = [None] * len(self._shards)
        self._lstm_carry = [None] * len(self._shards)
        if self.stereo is not None:
            for k, (dev, lo, hi) in enumerate(self._shards):
                zeros = [torch.zeros((hi - lo, layer["w_hh"].shape[0]),
                                     dtype=self.compute_dtype, device=dev)
                         for layer in self._replicas[dev][2].lstm.layers()]
                self._lstm_carry[k] = [(z, z) for z in zeros]

    def reset_stream(self, i: int):
        """Recycle slot i for a new stream: zero its input history, LSTM
        carry and decoder history (on the device of the shard that holds
        it). The slot then behaves like a fresh stream whose start is the
        batch clock; the other streams are untouched."""
        if not 0 <= i < self.batch:
            raise IndexError(f"stream {i} out of range (batch {self.batch})")
        self._in_buffer[i] = 0.0
        if self.stereo is not None:
            k = i // (self.batch // len(self._shards))
            dev, lo, hi = self._shards[k]
            # a mask in the carries' dtype, which must not promote them
            mask = torch.ones((hi - lo, 1), dtype=self.compute_dtype,
                              device=dev)
            mask[i - lo, 0] = 0.0
            self._lstm_carry[k] = [(h * mask, c * mask)
                                   for h, c in self._lstm_carry[k]]
            if self._dec_hist_buf[k] is not None:
                self._dec_hist_buf[k] = (self._dec_hist_buf[k]
                                         * mask[:, :, None])

    @classmethod
    def from_checkpoints(cls, denoiser_path=None, super_res_path=None,
                         stereo_path=None, device="cuda", **kwargs):
        """Load the stages from upstream `.pth` or JAX `.msgpack`
        checkpoints (load_stage); other kwargs go to the constructor."""
        dev = resolve_device(device)
        return cls(denoiser=load_stage(denoiser_path, "denoiser", dev),
                   super_resolution=load_stage(super_res_path,
                                               "super_resolution", dev),
                   stereo=load_stage(stereo_path, "stereo_separator", dev),
                   device=dev, **kwargs)

    def _step(self, window, ctx: int, n: int):
        """One feed's computation. window [B, L] f32 (on the host or a
        device), L >= ctx + n + lookahead; emits [B, ch, n*f] f32 on the
        restorer's device from the middle and advances the LSTM carries
        and the decoder history by n frames. Each shard's rows are copied
        to its device before any shard's work is enqueued (a pageable
        upload waits for the work queued before it), each shard runs
        there, and the outputs are gathered."""
        self._shapes.add(window.shape[1])
        parts = [window[lo:hi].to(dev) for dev, lo, hi in self._shards]
        outs = [self._shard_step(k, part, ctx, n)
                for k, part in enumerate(parts)]
        gather = dict(non_blocking=self.device.type == "cuda")
        return torch.cat([o.to(self.device, **gather) for o in outs])

    def _shard_step(self, k: int, window, ctx: int, n: int):
        """_step on shard k: window [b, L] f32 on its device."""
        f, g = self.f, self._g
        dev = self._shards[k][0]
        dn, sr, st = self._replicas[dev]
        x = window[:, None, :].to(self.compute_dtype)  # NCW
        q_dn, q_sr = self._int8_ctxs(window.shape[1], dev)
        if dn is not None:
            x = (dn(x) if q_dn is None else denoiser_mod.apply_packed(
                dn, x.permute(0, 2, 1), q=q_dn).permute(0, 2, 1))
        x_src = x  # the pre-SR signal (source-rate stereo input)
        if sr is not None:
            x = (sr(x) if q_sr is None else sr_mod.apply_packed(
                sr, x.permute(0, 2, 1), q=q_sr).permute(0, 2, 1))
        emit = slice(ctx * f, (ctx + n) * f)
        if st is None:
            return x[:, :, emit].float()
        feats = st.encode(x_src if self.source_rate else x).transpose(1, 2)
        layers = st.lstm.layers()
        # the LSTM consumes each new frame once; the carry holds the past
        lstm_out, carries = stacked_lstm(
            feats[:, ctx * g:(ctx + n) * g], layers,
            carries=self._lstm_carry[k], return_carries=True)
        # the decoders are centred convolutions: the left side of the
        # emitted frames comes from the decoder history, the right side from
        # a run over the lookahead frames that starts from the new carry and
        # is not kept (those frames are consumed for real next feed)
        lstm_future = stacked_lstm(feats[:, (ctx + n) * g:], layers,
                                   carries=carries)
        dec_hist = self._dec_hist(k)
        stereo = st.decode(torch.cat([dec_hist, lstm_out, lstm_future],
                                     dim=1).transpose(1, 2))  # [B, 2, L*g]
        if self.source_rate:
            # the side over the whole window, upsampled, then sliced: the
            # half-pixel interpolation of a window that starts at absolute
            # frame (warm - ctx) reproduces the single-shot interpolation at
            # every emitted sample, and ctx/lookahead keep the clamped
            # edges out of the emitted region
            side = (stereo[:, 0:1] - stereo[:, 1:2]) * 0.5
            if f > 1:
                side = upsample_linear(side, f)
            mid = x[:, :, emit].to(side.dtype)
            side = side[:, :, emit]
            out = torch.cat([mid + side, mid - side], dim=1)
        else:
            out = stereo[:, :, emit]
            if self.mid_exact:
                mid = x[:, :, emit].to(out.dtype)
                side = (out[:, 0:1] - out[:, 1:2]) * 0.5
                out = torch.cat([mid + side, mid - side], dim=1)
        self._lstm_carry[k] = carries
        self._dec_hist_buf[k] = torch.cat([dec_hist, lstm_out],
                                          dim=1)[:, -ctx * g:]
        return out.float()

    # ------------------------------------------------------- int8 serving
    def _int8_ctxs(self, window_len: int, device):
        """(denoiser, SR) int8 contexts of a step on `device` over a window
        of `window_len` samples, or None for a stage that runs float. Scope
        "packed"; built once per scales version and device."""
        if not (self.quantize_int8 and self._int8_scales is not None
                and window_len % 4 == 0):
            return None, None
        from ..ops.quant import QuantCtx

        key = (self._int8_version, device)
        if key not in self._qctx:
            self._qctx = {k: v for k, v in self._qctx.items()
                          if k[0] == self._int8_version}
            sc = self._int8_scales
            dn, sr, _ = self._replicas[device]
            self._qctx[key] = (
                None if dn is None else QuantCtx(
                    sc["denoiser"], "packed",
                    skip=denoiser_mod.INT8_FLOAT_LAYERS),
                None if sr is None else QuantCtx(
                    sc["super_resolution"], "packed"))
        return self._qctx[key]

    def _int8_gates(self, window_len: int):
        """Raise ValueError on what int8 cannot run, for preloaded scales as
        for calibration, so _drain can warn and serve float."""
        dn, sr = self.denoiser, self.super_resolution
        if not self.packed:
            raise ValueError("int8 streaming rides the packed conv paths: "
                             "packed=False")
        if dn is not None and not _denoiser_packable(dn):
            raise ValueError("denoiser checkpoint is not packable "
                             "(non-default layout); int8 unavailable")
        if sr is not None and not _sr_packable(sr):
            raise ValueError("super-resolution checkpoint is not packable "
                             "(non-default layout); int8 unavailable")
        if window_len % 4 != 0:
            raise ValueError(
                f"int8 streaming rides the packed path: window length "
                f"{window_len} must be a multiple of 4 (choose "
                f"context/lookahead/block sizes accordingly)")

    def _calibrate_int8(self, window: np.ndarray):
        """Denoiser and SR scales from one f32 pass of the f32 models over
        the first drained window (as RestorationPipeline.calibrate_int8)."""
        from ..ops.quant import QuantCtx, amax_to_host, scales_from_amax

        self._int8_gates(window.shape[1])
        amax = {}
        with torch.inference_mode():
            x = torch.from_numpy(window).to(self.device)[:, :, None]
            if self.denoiser is not None:
                q = QuantCtx()
                x = denoiser_mod.apply_packed(self.denoiser, x, q=q)
                amax["denoiser"] = q.amax
            if self.super_resolution is not None:
                q = QuantCtx()
                x = sr_mod.apply_packed(self.super_resolution, x, q=q)
                amax["super_resolution"] = q.amax
        self._int8_scales = {stage: scales_from_amax(amax_to_host(d))
                             for stage, d in amax.items()}
        self._int8_version += 1
        return self._int8_scales

    def save_int8_scales(self, path):
        """Write the scales (ops/quant.py::save_scales_file, the file
        RestorationPipeline writes too)."""
        from ..ops.quant import save_scales_file

        assert self._int8_scales is not None, "no scales calibrated yet"
        return save_scales_file(path, self._int8_scales)

    def load_int8_scales(self, path):
        from ..ops.quant import load_scales_file

        self._int8_scales = load_scales_file(path)
        self._int8_version += 1
        self._int8_ready = False  # the gates run again on the next drain
        return self._int8_scales

    def _ensure_int8(self, window: np.ndarray):
        """On the first drained window: discard scales lacking an enabled
        stage, then calibrate (or gate preloaded scales); a failure warns
        and serves float."""
        if self._int8_scales is not None:
            need = [k for k, m in (("denoiser", self.denoiser),
                                   ("super_resolution",
                                    self.super_resolution))
                    if m is not None]
            missing = [k for k in need if k not in self._int8_scales]
            if missing:
                warnings.warn(
                    f"int8 scales lack stage(s) {missing} — calibrated "
                    f"with those stages disabled? Recalibrating on the "
                    f"first window")
                self._int8_scales = None
                self._int8_version += 1
        try:
            if self._int8_scales is None:
                self._calibrate_int8(window)
            else:
                self._int8_gates(window.shape[1])
            self._int8_ready = True
        except ValueError as e:
            warnings.warn(f"int8 streaming unavailable — serving float "
                          f"instead: {e}")
            self.quantize_int8 = False

    def _dec_hist(self, k: int):
        """Shard k's last ctx*g LSTM outputs [b, ctx*g, H] (zeros at the
        start)."""
        if self._dec_hist_buf[k] is None:
            dev, lo, hi = self._shards[k]
            self._dec_hist_buf[k] = torch.zeros(
                (hi - lo, self.context * self._g,
                 self._st.lstm.hidden_size),
                dtype=self.compute_dtype, device=dev)
        return self._dec_hist_buf[k]

    def warmup(self, block: int, max_feeds: int = 64) -> dict:
        """Run the window lengths a frontend feeding `block`-sample blocks
        will hit before real streams arrive: the kernels are built, cuDNN
        builds its plans for each window and the allocator grows. Zero
        blocks are fed until no new window has run for max(4, alignment)
        feeds after the lookahead filled (a block off the pooling grid
        cycles through the remainders it leaves, with a window for each),
        then the windows a stream's `flush` can run, then the restorer is
        `reset()`: call it before serving, never with streams in flight. A
        short last block runs a window of its own. With `quantize_int8` and
        no scales it is skipped with a warning: the first window would
        calibrate on the warmup's silence. Returns {"programs": windows run
        for the first time, "seconds": wall}."""
        if self.quantize_int8 and self._int8_scales is None:
            warnings.warn(
                "streaming warmup skipped: quantize_int8 is set but no "
                "scales are loaded — the first drained window would "
                "calibrate on warmup silence. load_int8_scales() first")
            return {"programs": 0, "seconds": 0.0}
        t0 = time.monotonic()
        if self.device.type == "cuda" and self.stereo is not None:
            from ..ops import _build

            _build.load("lstm_recurrence")
        block = int(block)
        ctx, la, a = self.context, self.lookahead, self._align
        before = len(self._shapes)
        z = np.zeros((self.batch, block), np.float32)
        idle = 0  # consecutive feeds that ran no new window
        for i in range(max_feeds):
            had = len(self._shapes)
            self.feed(z)
            idle = idle + 1 if len(self._shapes) == had else 0
            if (i + 1) * block > la + block and idle >= max(4, a):
                break
        # a feed leaves lookahead + (less than the alignment) samples
        # unemitted; flush pads them up to the grid and emits them from a
        # window of ctx + n + lookahead, right-padded to 8
        with torch.inference_mode():
            for n in sorted({-(-(la + r) // a) * a for r in range(a)} - {0}):
                length = ctx + n + la
                self._step(torch.zeros((self.batch, length + -length % 8),
                                       device=self.device), ctx, n)
        self.reset()
        return {"programs": len(self._shapes) - before,
                "seconds": time.monotonic() - t0}

    def feed(self, block) -> np.ndarray:
        """Append input samples for every stream; return the finished
        output samples ([out_ch, m*f], or [B, out_ch, m*f] for batch > 1;
        m may be 0 while the lookahead fills)."""
        block = np.asarray(block, np.float32)
        if self.batch > 1:
            # a 1-D block whose size divides B would smear one stream's
            # samples across all of them
            if block.ndim != 2 or block.shape[0] != self.batch:
                raise ValueError(
                    f"feed() with batch={self.batch} requires a "
                    f"[{self.batch}, n] block, got shape {block.shape}")
        elif block.ndim not in (1, 2) or (block.ndim == 2
                                          and block.shape[0] != 1):
            # a [2, n] stereo block (a forgotten mixdown) would otherwise
            # become one stream of twice the length
            raise ValueError(
                f"feed() takes mono samples: a 1-D array or [1, n], "
                f"got shape {block.shape}")
        block = block.reshape(self.batch, -1)
        self._fed += block.shape[1]
        self._in_buffer = np.concatenate([self._in_buffer, block], axis=1)
        return self._drain()

    def flush(self) -> np.ndarray:
        """Zero-pad the lookahead and emit everything still buffered."""
        remaining = self._fed - self._emitted
        aligned = -(-remaining // self._align) * self._align
        pad = np.zeros((self.batch,
                        self.lookahead + (aligned - remaining)), np.float32)
        self._in_buffer = np.concatenate([self._in_buffer, pad], axis=1)
        out = self._drain()
        excess = (self._emitted - self._fed) * self.f  # alignment padding
        return out[..., :out.shape[-1] - excess] if excess > 0 else out

    @torch.inference_mode()
    def _drain(self) -> np.ndarray:
        ctx, la = self.context, self.lookahead
        outs = []
        while True:
            avail = self._in_buffer.shape[1]
            n = avail - self._warm - la  # emittable samples
            n -= n % self._align  # keep window starts on the pooling grid
            if n <= 0:
                break
            # history shorter than ctx at a stream's start: zeros before it
            window = self._in_buffer[:, max(0, self._warm - ctx):]
            deficit = ctx - min(ctx, self._warm)
            # right-pad to a multiple of 8, as the JAX restorer does to keep
            # its packed layouts: the zeros lie beyond the lookahead, which
            # covers the receptive field, so no emitted sample sees them
            pad = -(deficit + window.shape[1]) % 8
            window = np.pad(window, ((0, 0), (deficit, pad)))
            if self.quantize_int8 and not self._int8_ready:
                self._ensure_int8(window)
            out = self._step(torch.from_numpy(window), ctx, n)
            outs.append(out.cpu().numpy())  # [B, ch, n*f]
            self._warm += n
            self._emitted += n
            # drop history that is never needed again
            keep_from = max(0, self._warm - ctx)
            self._in_buffer = self._in_buffer[:, keep_from:]
            self._warm -= keep_from
        if not outs:
            ch = 2 if self.stereo is not None else 1
            full = np.zeros((self.batch, ch, 0), np.float32)
        else:
            full = np.concatenate(outs, axis=2)
        return full[0] if self.batch == 1 else full
