"""Driver `restore_enhance`: the `restore` driver's closed loop (one client
restoring whole recordings back to back in one fixed stratified order, a
unit being one restore to a stereo output in host memory) through a
`RestorationPipeline` that runs BS-RoFormer as its fourth stage, the
`enhancer`, built from the configuration's `bs_roformer` group
(`harness/roformer.py`) and seeded from the run's seed beside the three
upstream stages.

The check restores the longest recording the window finished and
`check_sides` more drawn from the seed with the plain reference
(`benchmark/reference/bs_roformer.py`: the three stages and BS-RoFormer
on every chunk, the attention scores written out), the control under
TF32, and compares the outputs.
"""
from __future__ import annotations

import gc
from pathlib import Path

import numpy as np
import torch

from benchmark.counts import bs_roformer as CB
from benchmark.counts import models as C
from benchmark.harness import compare
from benchmark.harness.manifest import load_module
from benchmark.harness.roformer import build_enhancer
from benchmark.harness.signals import seed_seq, side
from benchmark.harness.system import (Phases, build_models, pinned,
                                     snapshots)
from benchmark.harness.weights import snapshot
from benchmark.reference import bs_roformer as RB
from benchmark.reference import models as RM
from benchmark.reference import restore as R

base = load_module(Path(__file__).with_name("restore.py"))


class Session(base.Session):
    def __init__(self, ctx):
        # the program's enhancer first: a program without it stops here
        from ml_audio_restoration_torch.models import BSRoformer  # noqa
        from ml_audio_restoration_torch import (PipelineConfig,
                                                RestorationPipeline)
        from ml_audio_restoration_torch.ops import lstm as L
        from ml_audio_restoration_torch.pipeline.restore import slab_plan

        self.ctx, self.cfg, mix = ctx, ctx.config, ctx.traffic
        self.launches = L
        self.phases = Phases()
        p = self.cfg["pipeline"]
        self.dtype = p["compute_dtype"]
        self.rate = rate = p["sample_rate"]
        self.f = f = self.cfg["super_resolution"]["upscale_factor"]
        models = build_models(self.cfg, ctx.device, ctx.seed)
        enhancer = build_enhancer(self.cfg, ctx.device, ctx.seed)
        self.sds = snapshots(models)
        self.sds["bs_roformer"] = snapshot(enhancer)
        self.pipe = RestorationPipeline(
            models["denoiser"], models["super_resolution"],
            models["stereo_separator"], config=PipelineConfig(**p),
            device=ctx.device, enhancer=enhancer)
        del models, enhancer
        self.phases.mark("models")
        s = mix["side_seconds"]
        k = s["count"]
        self.lengths = [int(round((s["low"] + (s["high"] - s["low"])
                                   * (i + 0.5) / k) * rate))
                        for i in range(k)]
        self.order = base.stratified(k)
        gen = torch.Generator(device=ctx.device).manual_seed(
            seed_seq(ctx.seed, 2))
        self.inputs, self.outputs = [], []
        for n in self.lengths:
            host = pinned((1, n), ctx.device)
            host.copy_(side(n, rate, gen)[None])
            self.inputs.append(host)
            self.outputs.append(pinned((2, n * f), ctx.device))
        self.phases.mark("inputs")
        # the counts of a recording, over its real chunks: model FLOPs
        # (the three stages and the enhancer), K1's bound and the
        # attention kernels' bound
        chunk, hop, _ = R.framing(p["chunk_seconds"], p["overlap_seconds"],
                                  rate)
        self.chunk, self.hop = chunk, hop
        group = self.cfg["bs_roformer"]
        self.flops_chunk = (C.chain(self.cfg, chunk)
                            + CB.enhancer(group, chunk * f))
        self.attn_chunk_ms = CB.attention(group, chunk * f)["bound_ms"]
        self.windows = C.stereo_windows(self.cfg, chunk * f, rate)
        self.hidden = self.cfg["stereo_separator"]["lstm_hidden"]
        # warm every shape the mix uses: one recording for each number of
        # rows a program that the restore entry's slabs give the mix
        cap = max(p["max_chunks_per_program"], 4)
        shapes = {}
        for i, n in enumerate(self.lengths):
            shapes.setdefault(slab_plan(R.count(n, chunk, hop), cap), i)
        for i in shapes.values():
            self._restore(i)
        self.phases.mark("warm-up")
        self.done = [0] * k
        self.k = 0
        self.k1 = []

    def unit(self) -> dict:
        rec = super().unit()
        i = int(self.order[(self.k - 1) % len(self.order)])
        rows = R.count(self.lengths[i], self.chunk, self.hop)
        rec["attn_bound_ms"] = rows * self.attn_chunk_ms
        return rec

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
            ref = RB.restore(self.cfg, self.sds, x)
            outs = {"": self.outputs[i].to(dev)}
            if control:
                with RM.tf32():
                    outs[".control"] = RB.restore(self.cfg, self.sds, x)
            for tag, out in outs.items():
                got = {"out_err": compare.peak_gap(out, ref),
                       "out_rms_err": compare.rms_gap(out, ref)}
                for key, v in got.items():
                    found[key + tag] = max(found.get(key + tag, 0.0), v)
            del ref, outs
        return found
