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
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..config import COMPUTE_DTYPES, SERVING_LSTM_IMPLS
from ..models import denoiser as denoiser_mod
from ..models import super_resolution as sr_mod
from ..ops.lstm import stacked_lstm
from ..parallel.mesh import canonical
from ..utils.device import no_tf32, resolve_device
from ..utils.profiling import annotate
from .restore import (Int8State, StageCopies, _ncw, _upscale,
                      combine_stereo, load_stage)


class StreamingRestorer:
    """Stateful block-wise denoise -> super-res -> stereo."""

    def __init__(self, denoiser=None, super_resolution=None, stereo=None,
                 context: int = 1024, lookahead: int = 512, batch: int = 1,
                 mid_exact: bool = False, packed: bool = True,
                 source_rate: bool = False, quantize_int8: bool = False,
                 int8_scales=None, mesh=None,
                 lstm_impl: Optional[str] = None,
                 compute_dtype: str = "float32", device="cuda",
                 enhancer=None):
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
        divide evenly over it. `enhancer` (RestorationPipeline's fourth
        stage) is refused: its transformers attend over a whole 8 s chunk,
        which a block does not hold."""
        if enhancer is not None:
            raise ValueError("streaming does not serve the enhancer stage "
                             "(BS-RoFormer attends over whole chunks); "
                             "restore with RestorationPipeline")
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
        self._copies = StageCopies(partial(getattr, self))
        self.batch = int(batch)
        # the shards: (device, first stream, end stream), one a data device
        # of the mesh, each with its device's copies of the models
        devices = ([canonical(self.device)] if mesh is None
                   else mesh.data_devices)
        per = self.batch // len(devices)
        self._shards = [(dev, k * per, (k + 1) * per)
                        for k, dev in enumerate(devices)]
        self.mid_exact = bool(mid_exact)
        self.source_rate = bool(source_rate)
        self.packed = bool(packed)
        self.quantize_int8 = bool(quantize_int8)
        self._int8 = Int8State()
        self._int8_ready = False  # gates not yet run on a drained window
        if isinstance(int8_scales, dict):
            self._int8.set(int8_scales)
        elif int8_scales is not None:
            self.load_int8_scales(int8_scales)
        # the U-Net pools by 8, so window starts stay on the pooling grid
        # (the model is shift-variant modulo 8): context and emission
        # lengths are kept multiples of the alignment
        self._align = 8 if denoiser is not None else 1
        self.context = -(-context // self._align) * self._align
        self.lookahead = lookahead
        self.f = _upscale(self.super_resolution)
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
                         for layer in self.stereo.lstm.layers()]
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
        with annotate("stream.upload", device_ms=True):
            parts = [window[lo:hi].to(dev) for dev, lo, hi in self._shards]
        outs = [self._shard_step(k, part, ctx, n)
                for k, part in enumerate(parts)]
        gather = dict(non_blocking=self.device.type == "cuda")
        return torch.cat([o.to(self.device, **gather) for o in outs])

    def _shard_step(self, k: int, window, ctx: int, n: int):
        """_step on shard k: window [b, L] f32 on its device."""
        f, g = self.f, self._g
        dev = self._shards[k][0]
        dn, sr, st = (self._copies.get(name, self.compute_dtype, dev)
                      for name in ("denoiser", "super_resolution", "stereo"))
        x = window[:, None, :].to(self.compute_dtype)  # NCW
        q_dn = q_sr = None  # int8 (scope "packed") where its gates pass
        if (self.quantize_int8 and self._int8.scales is not None
                and window.shape[1] % 4 == 0):
            q_dn, q_sr = (None if m is None else self._int8.ctx(
                name, "packed", self.compute_dtype, dev)
                for name, m in (("denoiser", dn), ("super_resolution", sr)))
        if dn is not None:
            x = (dn(x) if q_dn is None
                 else _ncw(denoiser_mod.apply_packed, dn, x, q_dn))
        x_src = x  # the pre-SR signal (source-rate stereo input)
        if sr is not None:
            x = sr(x) if q_sr is None else _ncw(sr_mod.apply_packed, sr, x,
                                                q_sr)
        emit = slice(ctx * f, (ctx + n) * f)
        if st is None:
            return combine_stereo(x, None, emit=emit)
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
        self._lstm_carry[k] = carries
        self._dec_hist_buf[k] = torch.cat([dec_hist, lstm_out],
                                          dim=1)[:, -ctx * g:]
        # source-rate: the half-pixel interpolation of a window that starts
        # at absolute frame (warm - ctx) reproduces the single-shot one at
        # every emitted sample; ctx/lookahead keep its clamped edges out
        return combine_stereo(x, stereo, f, self.source_rate,
                              self.mid_exact, emit)

    # ------------------------------------------------------- int8 serving
    def save_int8_scales(self, path):
        """Write the scales (the file RestorationPipeline writes too)."""
        return self._int8.save(path, "no scales calibrated yet")

    def load_int8_scales(self, path):
        self._int8_ready = False  # the gates run again on the next drain
        return self._int8.load(path)

    def _ensure_int8(self, window: np.ndarray):
        """On the first drained window: discard scales lacking an enabled
        stage, run the gates, and calibrate the denoiser and SR on the
        window where no scales are loaded; a failure warns, serves float."""
        dn, sr = self.denoiser, self.super_resolution
        self._int8.discard_uncovered({"denoiser": dn is not None,
                                      "super_resolution": sr is not None},
                                     "first window")
        try:
            self._int8.check(
                None if self.packed else "packed=False", dn, sr,
                window.shape[1], "streaming", "window",
                " (choose context/lookahead/block sizes accordingly)")
            if self._int8.scales is None:
                self._int8.calibrate(
                    torch.from_numpy(window).to(self.device)[:, :, None],
                    dn, sr)
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
                 self.stereo.lstm.hidden_size),
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
        if self.quantize_int8 and self._int8.scales is None:
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
        m may be 0 while the lookahead fills). Its span is `stream.feed`."""
        with annotate("stream.feed"):
            return self._feed(block)

    def _feed(self, block) -> np.ndarray:
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
        with annotate("stream.buffer"):
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
            with annotate("stream.buffer"):
                # history shorter than ctx at a stream's start: zeros before
                # it
                window = self._in_buffer[:, max(0, self._warm - ctx):]
                deficit = ctx - min(ctx, self._warm)
                # right-pad to a multiple of 8, as the JAX restorer does to
                # keep its packed layouts: the zeros lie beyond the
                # lookahead, which covers the receptive field, so no emitted
                # sample sees them
                pad = -(deficit + window.shape[1]) % 8
                window = np.pad(window, ((0, 0), (deficit, pad)))
            if self.quantize_int8 and not self._int8_ready:
                self._ensure_int8(window)
            out = self._step(torch.from_numpy(window), ctx, n)
            with annotate("stream.download", device_ms=True):
                outs.append(out.cpu().numpy())  # [B, ch, n*f]
            self._warm += n
            self._emitted += n
            with annotate("stream.buffer"):
                # drop history that is never needed again
                keep_from = max(0, self._warm - ctx)
                self._in_buffer = self._in_buffer[:, keep_from:]
                self._warm -= keep_from
        if not outs:
            ch = 2 if self.stereo is not None else 1
            full = np.zeros((self.batch, ch, 0), np.float32)
        else:
            with annotate("stream.buffer"):
                full = np.concatenate(outs, axis=2)
        return full[0] if self.batch == 1 else full
