"""Driver `stream`: lockstep live streams through the program's
`StreamingRestorer.feed`, a closed loop: every stream has its next block
due as soon as the last feed returns.

The mix gives `streams`, `block_seconds`, `context` and `lookahead`. Each
stream is an endless seeded signal (`benchmark/harness/signals.py`): feed
i's blocks are made on the device from `seed_seq(seed, 1, i)` and copied
to the host before the feed, whatever the rate of feeds. Set-up warms the
restorer for the block (`StreamingRestorer.warmup`, which resets it). A
unit is one feed of one block for every stream, timed from the call to
the return of its host array; there is no flush in the window. The check compares everything
the window emitted for `check_streams` streams drawn from the seed, past
their first `context` samples, with the plain whole-stream reference
(`benchmark/reference/stream.py`); only those streams' inputs and output
are kept.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark.counts import kernels as K
from benchmark.counts import models as C
from benchmark.harness import compare
from benchmark.harness.signals import seed_seq, stream_block
from benchmark.harness.system import Phases, build_models, snapshots
from benchmark.reference import models as RM
from benchmark.reference import stream as RS

MARGIN = 4096  # input past the last feed, for the reference's halo


class Session:
    def __init__(self, ctx):
        from ml_audio_restoration_torch.ops import lstm as L
        from ml_audio_restoration_torch.pipeline.streaming import (
            StreamingRestorer)

        self.ctx, self.cfg, mix = ctx, ctx.config, ctx.traffic
        self.launches = L
        self.phases = Phases()
        p = self.cfg["pipeline"]
        self.dtype = p["compute_dtype"]
        self.rate = rate = p["sample_rate"]
        self.f = self.cfg["super_resolution"]["upscale_factor"]
        self.n = mix["streams"]
        self.block = int(round(mix["block_seconds"] * rate))
        self.lookahead = mix["lookahead"]
        models = build_models(self.cfg, ctx.device, ctx.seed)
        self.sds = snapshots(models)
        self.restorer = StreamingRestorer(
            models["denoiser"], models["super_resolution"],
            models["stereo_separator"], context=mix["context"],
            lookahead=mix["lookahead"], batch=self.n,
            compute_dtype=self.dtype, device=ctx.device)
        self.context = self.restorer.context
        self.phases.mark("models")
        self.gen = torch.Generator(device=ctx.device)
        self._inputs(0)  # the generator's kernels, warmed
        self.phases.mark("inputs")
        self.restorer.warmup(self.block)
        self.phases.mark("warm-up")
        self.hidden = self.cfg["stereo_separator"]["lstm_hidden"]
        self.pick = np.sort(np.random.default_rng(seed_seq(ctx.seed, 3))
                            .choice(self.n, size=mix["check_streams"],
                                    replace=False))
        self.ins, self.outs = [], []
        self.k1 = []

    def _inputs(self, i: int) -> np.ndarray:
        """Feed i's blocks [streams, block] on the host."""
        self.gen.manual_seed(seed_seq(self.ctx.seed, 1, i))
        return stream_block(self.n, self.block, i * self.block, self.rate,
                            self.gen).cpu().numpy()

    def unit(self) -> dict:
        x = self._inputs(len(self.outs))
        before = self.launches.launch_count
        t0 = time.perf_counter()
        out = self.restorer.feed(x)
        t = time.perf_counter() - t0
        self.k1.append(self.launches.launch_count - before)
        self.ins.append(x[self.pick])
        self.outs.append(out[self.pick])
        n = out.shape[-1] // self.f  # input samples emitted a stream
        g = self.f
        # K1's bound over the feed's two walks: the emitted frames and the
        # lookahead's (counted at its nominal length)
        bound = (K.k1(n * g, self.n, self.hidden, self.dtype)["bound_ms"]
                 + K.k1(self.lookahead * g, self.n, self.hidden,
                        self.dtype)["bound_ms"])
        return {"t": t, "audio_s": self.n * n / self.rate,
                "flops": self.n * C.chain(self.cfg, n) if n else 0.0,
                "k1_bound_ms": bound if n else 0.0}

    def info(self) -> dict:
        return {"set-up s by phase": self.phases.done,
                "K1 launches a feed": sorted(set(self.k1))}

    def check(self, control: bool) -> dict:
        """The sampled streams' output past `context` input samples against
        the reference's: the widest gap over the reference's peak
        (out_err), the RMS gap over its RMS (out_rms_err)."""
        dev = self.ctx.device
        del self.restorer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        prog = np.concatenate(self.outs, axis=-1)
        emit = prog.shape[-1] // self.f
        fed = len(self.ins)
        ahead = [self._inputs(fed + j)[self.pick]
                 for j in range(math.ceil(MARGIN / self.block))]
        x = torch.from_numpy(np.concatenate(self.ins + ahead,
                                            axis=-1)).to(dev)
        skip = self.context * self.f
        ref = RS.stream(self.cfg, self.sds, x, emit)[..., skip:]
        prog = torch.from_numpy(prog[..., skip:])
        out = {"out_err": compare.peak_gap(prog, ref),
               "out_rms_err": compare.rms_gap(prog, ref)}
        if control:
            with RM.tf32():
                ctl = RS.stream(self.cfg, self.sds, x, emit)[..., skip:]
            out["out_err.control"] = compare.peak_gap(ctl, ref)
            out["out_rms_err.control"] = compare.rms_gap(ctl, ref)
        return out
