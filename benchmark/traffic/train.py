"""Driver `train`: the stereo separator fitted by the program's public
`Trainer.train_epoch` over its `StereoDataset` and `DataLoader`.

The mix gives the corpus: `files` seeded stereo WAVs of `file_seconds`
(`benchmark/harness/signals.py::stereo_take`), written at set-up under
TMPDIR and removed at the end. The configuration's `train` and `data`
groups give the batch, the chunk, the learning rate and the loss weights.
Set-up builds one Trainer and runs its first epoch through `train_epoch`,
reading it through public surfaces alone: the loader hands the first
three steps out one a call (so `train_epoch` returns each one's loss) and
keeps their batches, a forward hook on the model keeps step 1's output,
an optimizer pre-step hook the gradients as Adam gets them at step 1, and
the parameters are read after steps 1 and 3. The window then runs whole
epochs on that same trainer. A unit is one epoch; its steps are the work
counted. The check replays the first three steps with the plain
reference (`benchmark/reference/train.py`) from the same weights, on
batches the reference works out again from the WAV files.
"""
from __future__ import annotations

import atexit
import gc
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.counts import kernels as K
from benchmark.counts import models as C
from benchmark.harness import compare
from benchmark.harness.signals import seed_seq, stereo_take, write_wav16
from benchmark.harness.system import Phases, build_models
from benchmark.harness.weights import snapshot
from benchmark.reference import batches as RB
from benchmark.reference import models as RM
from benchmark.reference import train as RT

FOLLOWED = 3  # steps the reference follows


class _TimedLoader:
    """The port's loader, with the host time spent in its `__next__` and
    the first `keep` batches' stereo arrays. With `cap` set, an iteration
    hands out at most that many batches and the next one goes on through
    the same pass of the port's loader."""

    def __init__(self, loader, keep: int):
        self.loader = loader
        self.dataset = loader.dataset
        self.wait_s = 0.0
        self.keep, self.kept = keep, []
        self.cap = None
        self._pass = None

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        if self._pass is None:
            self._pass = iter(self.loader)
        n = 0
        while self.cap is None or n < self.cap:
            t0 = time.perf_counter()
            try:
                batch = next(self._pass)
            except StopIteration:
                self._pass = None
                return
            finally:
                self.wait_s += time.perf_counter() - t0
            if len(self.kept) < self.keep:
                self.kept.append(np.array(batch["stereo"]))
            n += 1
            yield batch


class Session:
    def __init__(self, ctx):
        from ml_audio_restoration_torch.config import TrainConfig
        from ml_audio_restoration_torch.data import DataLoader, StereoDataset
        from ml_audio_restoration_torch.ops import lstm as L
        from ml_audio_restoration_torch.train.trainer import Trainer

        self.ctx, self.cfg, mix = ctx, ctx.config, ctx.traffic
        self.launches = L
        self.phases = Phases()
        tc, data = self.cfg["train"], self.cfg["data"]
        self.dtype = tc["compute_dtype"]
        rate = data["sample_rate"]
        self.chunk = int(rate * data["chunk_duration"])
        self.batch = tc["batch_size"]
        self.dir = Path(tempfile.mkdtemp(prefix="bench_corpus_"))
        atexit.register(shutil.rmtree, self.dir, True)
        frames = int(mix["file_seconds"] * rate)
        for i in range(mix["files"]):
            write_wav16(self.dir / f"take_{i:03d}.wav",
                        stereo_take(frames, seed_seq(ctx.seed, 10, i), rate),
                        rate)
        self.phases.mark("corpus")
        self.seeds = (seed_seq(ctx.seed, 4), seed_seq(ctx.seed, 5))
        dataset = StereoDataset(self.dir, rate, data["chunk_duration"],
                                seed=self.seeds[0])
        self.loader = _TimedLoader(DataLoader(dataset, self.batch,
                                              seed=self.seeds[1]), FOLLOWED)
        model = build_models(self.cfg, ctx.device, ctx.seed,
                             ("stereo_separator",))["stereo_separator"]
        self.sd0 = snapshot(model)
        self.trainer = Trainer(
            "stereo_separator", model, self.loader, None,
            config=TrainConfig(seed=seed_seq(ctx.seed, 6), **tc),
            sample_rate=rate, device=ctx.device)
        h = self.cfg["stereo_separator"]["lstm_hidden"]
        t2 = self.chunk  # the stereo net runs at the data rate here
        self.fwd_flops = self.batch * C.stereo_separator(
            t2, **self.cfg["stereo_separator"])
        self.k2 = K.k2(t2, self.batch, h, self.dtype)["bound_ms"]
        self.k3 = K.k3(t2, self.batch, h)["bound_ms"]
        self.seen = {"losses": []}
        self.phases.mark("trainer")
        self._first_epoch()
        self.phases.mark("first epoch")

    def _first_epoch(self):
        """The trainer's first epoch through train_epoch: its first
        FOLLOWED steps one a call, read by hooks as they pass, then the
        rest of the loader's pass."""
        tr, seen = self.trainer, self.seen
        named = dict(tr.model.named_parameters())

        def values():
            return {n: p.detach().clone() for n, p in named.items()}

        def keep_out(module, args, out):
            seen.setdefault("out1", out.detach().float().clone())

        def keep_grad(optimizer, args, kwargs):
            # a leaf with no gradient gets none from this step
            seen.setdefault("grad1", {
                n: torch.zeros_like(p) if p.grad is None
                else p.grad.detach().clone() for n, p in named.items()})

        hooks = [tr.model.register_forward_hook(keep_out),
                 tr.optimizer.register_step_pre_hook(keep_grad)]
        self.loader.cap = 1
        try:
            for k in range(FOLLOWED):
                seen["losses"].append(tr.train_epoch())
                if k == 0:
                    seen["params1"] = values()
            seen["params"] = values()
            # an optimizer that was never stepped got no gradient
            seen.setdefault("grad1", {n: torch.zeros_like(p)
                                      for n, p in named.items()})
        finally:
            self.loader.cap = None
            for h in hooks:
                h.remove()
        tr.train_epoch()
        self.steps0 = tr.global_step

    def unit(self) -> dict:
        tr = self.trainer
        n0, w0 = tr.global_step, self.loader.wait_s
        tr.train_epoch()
        n = tr.global_step - n0
        return {"steps": n, "audio_s": n * self.batch * self.chunk
                / self.cfg["data"]["sample_rate"],
                "flops": 3 * n * self.fwd_flops,
                "loader_wait_s": self.loader.wait_s - w0,
                "k2_bound_ms": n * self.k2, "k3_bound_ms": n * self.k3}

    def info(self) -> dict:
        return {"set-up s by phase": self.phases.done,
                "steps an epoch": self.steps0,
                "K2 launches a step": self.launches.train_fwd_launch_count
                / max(self.trainer.global_step, 1)}

    def check(self, control: bool) -> dict:
        """Step 1's output, each followed step's loss, the first gradient's
        norms and the norms of the parameters' change after step 1 and
        after the followed steps, each against the reference's."""
        dev = self.ctx.device
        seen = self.seen
        del self.trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        try:
            batches = RB.replay(self.dir, self.chunk, self.batch,
                                self.seeds[0], self.seeds[1], FOLLOWED)
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
        out = {"batch_gap": max(float(np.abs(a - b).max()) for a, b in
                                zip(self.loader.kept, batches))}
        tensors = [torch.from_numpy(b).to(dev) for b in batches]
        ref = RT.steps(self.cfg, self.sd0, tensors)
        out.update(self._gaps(seen, ref))
        if control:
            with RM.tf32():
                ctl = RT.steps(self.cfg, self.sd0, tensors)
            half = RT.steps(self.cfg, self.sd0, tensors,
                            rows=self.batch // 2)
            for tag, run in (("control", ctl), ("half_batch", half)):
                gaps = self._gaps(run, ref)
                out.update({f"{k}.{tag}": v for k, v in gaps.items()})
        return out

    def _gaps(self, run, ref) -> dict:
        """out1_gap: step 1's output, its widest gap over the reference's
        peak; loss1_gap: step 1's loss, relative; loss_gap: the worst
        followed step's; grad_gap: the worst leaf's gap of norms
        (compare.norm_gap) of the first gradient; change1_gap / change_gap:
        of the change after step 1 / after the followed steps;
        change_median_gap: the median leaf's, relative to its own
        reference norm."""
        g_ref = ref["grad1"]
        norms = {k: float(torch.linalg.vector_norm(g)) for k, g in
                 g_ref.items()}
        floor = 1e-3 * statistics.median(norms.values())
        # leaves whose reference gradient is nought to rounding (a conv
        # bias under batch norm) move under Adam by round-off alone
        moved = {k for k, n in norms.items() if n >= floor}

        def change(params):
            return {k: params[k] - self.sd0[k] for k in g_ref}

        losses = [float(x) for x in run["losses"]]
        c1, c1_ref = change(run["params1"]), change(ref["params1"])
        c, c_ref = change(run["params"]), change(ref["params"])
        return {"out1_gap": compare.peak_gap(run["out1"], ref["out1"]),
                "loss1_gap": abs(losses[0] - ref["losses"][0])
                / abs(ref["losses"][0]),
                "loss_gap": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, ref["losses"])),
                "grad_gap": compare.norm_gap(run["grad1"], g_ref),
                "change1_gap": compare.norm_gap(c1, c1_ref, moved),
                "change_gap": compare.norm_gap(c, c_ref, moved),
                "change_median_gap": compare.median_gap(c, c_ref, moved)}
