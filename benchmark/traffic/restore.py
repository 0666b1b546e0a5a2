"""Driver `restore`: a closed loop of one client restoring whole
recordings, back to back, through `RestorationPipeline.restore`.

The mix file gives `side_seconds` {low, high, count}: the recordings are
`count` lengths spread evenly over [low, high], restored in one fixed
stratified order (any run of consecutive sides spans the range), the
same for every seed, so that every window holds the same work; the seed
draws the signals and the weights. A unit is one restore, from the host
input to the stereo output copied back to host memory, as a file write
needs it. The check restores a sample of the recordings the window
finished, the longest among them, with the plain reference
(`benchmark/reference/restore.py`) and compares the outputs.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark.counts import kernels as K
from benchmark.counts import models as C
from benchmark.harness import compare
from benchmark.harness.signals import seed_seq, side
from benchmark.harness.system import (Phases, build_models, pinned,
                                     snapshots, sync)
from benchmark.reference import models as RM
from benchmark.reference import restore as R


def stratified(k: int) -> list[int]:
    """0..k-1 in bit-reversed order (0, k/2, k/4, 3k/4, ...): every run of
    consecutive entries spreads over the range."""
    bits = max(1, (k - 1).bit_length())
    rev = sorted(range(2 ** bits),
                 key=lambda i: int(format(i, f"0{bits}b")[::-1], 2))
    return [i for i in rev if i < k]


class Session:
    def __init__(self, ctx):
        from ml_audio_restoration_torch import (PipelineConfig,
                                                RestorationPipeline)
        from ml_audio_restoration_torch.ops import lstm as L

        self.ctx, self.cfg, mix = ctx, ctx.config, ctx.traffic
        self.launches = L
        self.phases = Phases()
        p = self.cfg["pipeline"]
        self.dtype = p["compute_dtype"]
        self.rate = rate = p["sample_rate"]
        self.f = f = self.cfg["super_resolution"]["upscale_factor"]
        models = build_models(self.cfg, ctx.device, ctx.seed)
        self.sds = snapshots(models)
        self.pipe = RestorationPipeline(
            models["denoiser"], models["super_resolution"],
            models["stereo_separator"], config=PipelineConfig(**p),
            device=ctx.device)
        self.phases.mark("models")
        s = mix["side_seconds"]
        k = s["count"]
        self.lengths = [int(round((s["low"] + (s["high"] - s["low"])
                                   * (i + 0.5) / k) * rate))
                        for i in range(k)]
        self.order = stratified(k)
        gen = torch.Generator(device=ctx.device).manual_seed(
            seed_seq(ctx.seed, 2))
        self.inputs, self.outputs = [], []
        for n in self.lengths:
            host = pinned((1, n), ctx.device)
            host.copy_(side(n, rate, gen)[None])
            self.inputs.append(host)
            self.outputs.append(pinned((2, n * f), ctx.device))
        self.phases.mark("inputs")
        # the counts of a recording: model FLOPs of its real chunks, and
        # K1's bound over their rows (windows under stereo_chunk_seconds)
        chunk, hop, _ = R.framing(p["chunk_seconds"], p["overlap_seconds"],
                                  rate)
        self.chunk, self.hop = chunk, hop
        self.flops_chunk = C.chain(self.cfg, chunk)
        self.windows = C.stereo_windows(self.cfg, chunk * f, rate)
        self.hidden = self.cfg["stereo_separator"]["lstm_hidden"]
        # warm every shape the mix uses: the shortest and the longest
        # recording (the fewest and the most slabs)
        for i in {int(np.argmin(self.lengths)), int(np.argmax(self.lengths))}:
            self._restore(i)
        self.phases.mark("warm-up")
        self.done = [0] * k
        self.k = 0
        self.k1 = []

    def _restore(self, i: int):
        out, _ = self.pipe.restore(self.inputs[i], self.rate)
        self.outputs[i].copy_(out, non_blocking=True)
        sync(self.ctx.device)

    def unit(self) -> dict:
        i = int(self.order[self.k % len(self.order)])
        self.k += 1
        before = self.launches.launch_count
        self._restore(i)
        self.k1.append(self.launches.launch_count - before)
        self.done[i] += 1
        n = self.lengths[i]
        rows = R.count(n, self.chunk, self.hop)
        return {"audio_s": n / self.rate, "flops": rows * self.flops_chunk,
                "k1_bound_ms": K.k1(self.windows[0],
                                    rows * len(self.windows), self.hidden,
                                    self.dtype)["bound_ms"]}

    def info(self) -> dict:
        return {"set-up s by phase": self.phases.done,
                "K1 launches a restore": sorted(set(self.k1))}

    def check(self, control: bool) -> dict:
        """Over the longest recording the window finished and
        `check_sides` more drawn from the seed, the worst recording's
        widest gap from the float32 reference's output over the
        reference's peak (out_err) and its RMS gap over the reference's
        RMS (out_rms_err)."""
        dev = self.ctx.device
        del self.pipe
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done = [i for i, d in enumerate(self.done) if d]
        longest = max(done, key=lambda i: self.lengths[i])
        rest = [i for i in done if i != longest]
        rng = np.random.default_rng(seed_seq(self.ctx.seed, 3))
        pick = [longest] + [int(i) for i in rng.choice(
            rest, size=min(self.ctx.traffic["check_sides"], len(rest)),
            replace=False)]
        found: dict = {}
        for i in pick:
            x = self.inputs[i][0].to(dev)
            ref = R.restore(self.cfg, self.sds, x)
            outs = {"": self.outputs[i].to(dev)}
            if control:
                outs[".control"] = self._control(x)
            for tag, out in outs.items():
                got = {"out_err": compare.peak_gap(out, ref),
                       "out_rms_err": compare.rms_gap(out, ref)}
                for k, v in got.items():
                    found[k + tag] = max(found.get(k + tag, 0.0), v)
            del ref, outs
        return found

    def _control(self, x):
        """The reference in the precision below the configuration's:
        TF32 for float32; for bfloat16, the reference computed in bfloat16
        with every product's operands rounded to float8 e4m3."""
        if self.dtype == "bfloat16":
            sds = {k: RM.cast(v, torch.bfloat16) for k, v in self.sds.items()}
            return R.restore(self.cfg, sds, x.to(torch.bfloat16),
                             ops=RM.Ops("fp8"))
        with RM.tf32():
            return R.restore(self.cfg, self.sds, x)
