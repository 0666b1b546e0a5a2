"""Training runtime of the port: the denoiser, super-resolution and
stereo-separator families.

Counterpart of ml_audio_restoration_tpu/train/trainer.py. The pairings
derive (input, target) on the device from each host batch: `degrade` runs
the 78rpm simulator (data/artifacts.py) on the clean chunk inside the
step, with draws from a generator seeded from (seed, epoch, step) as the
JAX package folds them into its key, so a resumed run draws the same
degradations; `downsample` makes the SR input with the linear downsample
by the model's factor; `mono_target_stereo` takes the channel mean of a
stereo chunk; `identity` trains on clean pairs; `degrade_adaptive` runs
the simulator with each item's own impulse rate, amplitude bound and noise
level (AdaptiveArtifactDataset); `mixed` degrades the synthetic items of a
MixedRestorationDataset batch and trains on the semi-supervised loss
(supervised, consistency, cycle consistency through a re-degradation and
an eval-mode re-inference, and an optional contrastive term through
`encode`). The draws of one step come from the step's generator in a fixed
order: the derive, the cycle's re-degradation, the contrastive pair.
Adam with optional
global-norm clipping (optax's `clip_by_global_norm` semantics),
ReduceLROnPlateau (patience 5, factor 0.5) by mutating the optimizer's
`lr`, an optional EMA of the weights for validation and rendering,
checkpoint/resume with retention and a corrupt-file fallback (resume also
reads the JAX trainer's `.msgpack` checkpoints, Adam state included),
metrics every 50 steps.

`compute_dtype="bfloat16"` is JAX's AMP: each forward runs on bf16 casts
of the f32 parameters (`models.cast_params`; the BN running statistics stay
f32) and a bf16 input, and the output is cast back to f32 before the loss.
Parameters, Adam state, EMA and checkpoints stay f32. No autocast and no
loss scaling, as in JAX.

Under grad the stereo LSTM runs the training recurrence (K2 forward, K3
backward, csrc/lstm_train.cu; bf16 gates in bf16); validation and
rendering run the eval forward under no grad, which takes the inference
kernel K1. The denoiser and SR are convolutions only.

Data parallelism runs one process a device (parallel/distributed.py),
where the JAX package shards one step over a mesh: `data_parallel` must
equal the number of processes. Each process loads a disjoint stride of
the train files and feeds its share of the global batch; inside the train
step (`dist.global_batch()`) the degradation draws for the global batch
and keeps this rank's rows, train-mode BN normalizes by the global batch's
statistics, the masked means and the impulse threshold are the global
batch's, and one flattened all-reduce averages the gradients and the
logged values before clipping and Adam. So a step of W ranks is the step
of one process fed the ranks' batches in rank order, and every rank holds
the same weights, optimizer state and history. Validation is not sharded:
every rank evaluates the whole set with no collective, so the plateau
scheduler moves in lockstep. Only the primary writes checkpoints, metrics
and renders; an interrupt is agreed every 50 steps.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import signal
import time
import warnings
from functools import partial
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..compat.optim import LeafMap, adam_from_jax
from ..compat.weights import state_dict_from_jax
from ..config import ArtifactConfig, Config, PipelineConfig, TrainConfig
from ..data import artifacts
from ..losses import (
    contrastive_loss, restoration_loss, semi_supervised_loss, stereo_metrics,
    stereo_moments)
from ..models import (
    AudioDenoiser, AudioSuperResolution, StereoSeparator, cast_params,
    count_params, init_params)
from ..ops import interp_linear
from ..parallel import distributed as dist
from ..utils.device import no_tf32, resolve_device
from ..utils.profiling import annotate
from . import checkpoints as ckpt
from .metrics import MetricsLogger

MODELS = {"denoiser": AudioDenoiser,
          "super_resolution": AudioSuperResolution,
          "stereo_separator": StereoSeparator}
PAIRINGS = ("degrade", "identity", "downsample", "mono_target_stereo",
            "mixed", "degrade_adaptive")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the per-item simulator parameters of the degrade_adaptive pairing
ADAPTIVE_KEYS = ("impulse_rate", "impulse_amplitude_max", "noise_level")


def _nwc(x):
    """[B, C, T] host layout -> [B, T, C], the losses' layout."""
    return x.transpose(1, 2)


def _step_seed(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for one stream of draws: (seed, 2 * epoch,
    step) for a train step, (seed, 2 * epoch + 1, batch) for validation."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def _check_supported(model_name: str, cfg: TrainConfig, pairing: str):
    if model_name not in MODELS:
        raise ValueError(f"unknown model {model_name!r}")
    if pairing not in PAIRINGS:
        raise ValueError(f"unknown pairing {pairing!r}")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{tuple(COMPUTE_DTYPES)}, got {cfg.compute_dtype!r}")
    if cfg.data_parallel != dist.process_count():
        # the JAX package shards a step over the local devices too; the
        # port runs one device a process
        raise ValueError(
            f"data_parallel={cfg.data_parallel} with "
            f"{dist.process_count()} process(es): the port trains on one "
            f"device a process, so data_parallel must equal "
            f"--num-processes")


class Trainer:
    """Trains `model` (an nn.Module of family `model_name`) on `device`.

    The model is moved to the device and updated in place: parameters by
    the optimizer, BN running statistics by the train forward."""

    def __init__(self, model_name: str, model: nn.Module, train_loader,
                 val_loader=None, *,
                 config: Optional[TrainConfig] = None,
                 artifact_config: Optional[ArtifactConfig] = None,
                 sample_rate: int = 22050,
                 pairing: Optional[str] = None,
                 logger: Optional[MetricsLogger] = None,
                 device="cuda"):
        self.cfg = config or TrainConfig(model=model_name)
        self.artifact_cfg = artifact_config or ArtifactConfig()
        self.model_name = model_name
        self.sample_rate = sample_rate
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.pairing = pairing or getattr(
            getattr(train_loader, "dataset", None), "pairing", "degrade")
        _check_supported(model_name, self.cfg, self.pairing)
        self.compute_dtype = COMPUTE_DTYPES[self.cfg.compute_dtype]
        self.device = resolve_device(device)
        # full f32 as in the JAX package: cuDNN's TF32 default would keep
        # about three decimal digits in every convolution
        no_tf32()
        # cuDNN's default weight-gradient algorithms sum in an order that
        # changes from run to run, and the reference loss's spectral terms
        # amplify that over a few steps; its deterministic ones make two
        # runs from one seed equal, for 2-4% of a step (PERF.md)
        torch.backends.cudnn.deterministic = True
        self.model = model.to(self.device)
        self.logger = logger
        # SR derives its low-rate input from the high-rate target by the
        # model's own factor (2 per transpose-conv stage)
        self._sr_factor = (2 ** len(model.upsample_blocks)
                           if model_name == "super_resolution" else 2)
        # the degradation's draws, on the device; reseeded per step
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(_step_seed(self.cfg.seed))
        # encode() as a module's forward, for the contrastive term's
        # functional calls
        self._encoder = _Encoder(self.model)

        self.lr = self.cfg.learning_rate
        self.optimizer = self._make_optimizer()
        self.ema_params = None
        if self.cfg.ema_decay > 0:
            self.ema_params = {n: p.detach().clone()
                               for n, p in self.model.named_parameters()}

        self.epoch = 0
        self.global_step = 0
        self.best_val_loss = float("inf")
        self._plateau_wait = 0
        self.history = {"train_loss": [], "val_loss": [], "learning_rate": []}
        self.checkpoint_dir = Path(self.cfg.checkpoint_dir)
        # SIGINT -> checkpoint + clean exit, installed only during train()
        self.interrupted = False

    def _make_optimizer(self):
        return torch.optim.Adam(self.model.parameters(), lr=self.lr)

    # ------------------------------------------------------------ stepping
    def _on_sigint(self, sig, frame):
        print("\ninterrupt: finishing step, checkpointing, then exiting...")
        self.interrupted = True

    def _seeded(self, *stream: int) -> torch.Generator:
        """The trainer's generator, reseeded for one stream of draws."""
        return self._gen.manual_seed(_step_seed(self.cfg.seed, *stream))

    def _host(self, batch, key):
        """batch[key] as a tensor on the device."""
        return torch.as_tensor(batch[key]).to(self.device)

    def _simulate(self, gen, clean, overrides=None):
        """simulate_batch of [b, C, T] on the trainer's simulator. Inside a
        data-parallel train step the draws are the global batch's [W*b, C,
        T] (every rank's per-item overrides gathered first) and this rank
        keeps its rows [r*b, (r+1)*b): the draws of one process fed the
        ranks' batches in rank order."""
        if not dist.in_global_batch():
            return artifacts.simulate_batch(gen, clean, self.sample_rate,
                                            self.artifact_cfg,
                                            overrides=overrides)
        b, r = clean.shape[0], dist.process_index()
        if overrides is not None:
            overrides = {k: dist.gather_rows(v) for k, v in overrides.items()}
        draws = artifacts.draw_artifacts(
            gen, (dist.process_count() * b, *clean.shape[1:]),
            self.sample_rate, self.artifact_cfg, dtype=clean.dtype,
            overrides=overrides)
        draws = {k: v[r * b:(r + 1) * b].to(clean.device)
                 for k, v in draws.items()}
        return artifacts.apply_artifacts(clean, draws, self.sample_rate,
                                         self.artifact_cfg)

    def _derive(self, batch, generator: Optional[torch.Generator] = None):
        """(inputs, targets) [B, T, C] on the device from a host batch.
        The degradations draw from `generator` (default: the trainer's,
        where it stands)."""
        host = partial(self._host, batch)
        p = self.pairing
        gen = generator or self._gen
        if p == "degrade":
            clean = host("clean")
            return _nwc(self._simulate(gen, clean)), _nwc(clean)
        if p == "degrade_adaptive":
            clean = host("clean")
            degraded = self._simulate(
                gen, clean, {k: host(k) for k in ADAPTIVE_KEYS})
            return _nwc(degraded), _nwc(clean)
        if p == "mixed":
            # synthetic items arrive clean and are degraded here; real ones
            # are degraded recordings, their own (unused) target
            audio = host("audio")
            degraded = self._simulate(gen, audio)
            syn = host("is_synthetic")[:, None, None]
            return (_nwc(torch.where(syn > 0, degraded, audio)),
                    _nwc(audio))
        if p == "downsample":
            high = host("high")
            low = interp_linear(high, high.shape[-1] // self._sr_factor)
            return _nwc(low), _nwc(high)
        if p == "mono_target_stereo":
            stereo = _nwc(host("stereo"))
            return stereo.mean(dim=-1, keepdim=True), stereo
        x = _nwc(host("clean"))
        return x, x

    def _cast(self, params=None):
        """The parameters of a forward in the compute dtype: `params`
        ({name: tensor}; None for the live parameters) cast by
        models.cast_params under bf16, as given under f32."""
        if self.compute_dtype == torch.float32:
            return params
        return cast_params(self.model, self.compute_dtype, params)

    def _forward(self, inputs, params=None, *, buffers=None,
                 module=None, dtype=None):
        """Model output [B, T, C] for inputs [B, T, C], in the model's
        current mode: `params` ({name: tensor}) replaces its parameters and
        `buffers` its buffers. Under bf16 compute (`dtype`, default the
        trainer's) the input is cast to bf16 and the output back to f32
        (pass `params` from `_cast`). `module` runs another forward of the
        model (`self._encoder`)."""
        module = module or self.model
        prefix = "" if module is self.model else "model."
        x = inputs.transpose(1, 2)
        dtype = dtype or self.compute_dtype
        low = dtype != torch.float32
        if low:
            x = x.to(dtype)
        swap = {prefix + n: v
                for n, v in {**(params or {}), **(buffers or {})}.items()}
        out = (torch.func.functional_call(module, swap, (x,)) if swap
               else module(x))
        out = out.transpose(1, 2)
        return out.float() if low else out

    def _criterion(self, out, targets):
        c = self.cfg
        return restoration_loss(
            out, targets,
            time_weight=c.time_weight,
            si_sdr_weight=c.si_sdr_weight,
            spectral_weight=c.spectral_weight,
            impulse_weight=c.impulse_weight,
            clustering_weight=c.clustering_weight,
            consistency_weight=c.consistency_weight,
            balance_weight=c.balance_weight,
            decorrelation_weight=c.decorrelation_weight,
            lf_centering_weight=c.lf_centering_weight,
            stats_match_weight=c.stats_match_weight)

    def _loss(self, inputs, targets, params=None, batch=None,
              generator=None):
        """(total, (parts, out)), as JAX's `_loss` without the state: the
        train forward updates the BN buffers in place. `params` are the
        parameters to run on (None: the live ones), cast here once and
        shared by every forward of the step. The `mixed` pairing reads
        `batch` and draws its re-degradations from `generator`."""
        params = self._cast(params)
        pre_step = None
        if self.pairing == "mixed" and self.model.training:
            # JAX runs the re-inference and the encoder on model_state, the
            # statistics from before this step's train forward, which here
            # updates the buffers in place
            pre_step = {n: b.clone() for n, b in self.model.named_buffers()}
        out = self._forward(inputs, params)
        if self.pairing != "mixed":
            total, parts = self._criterion(out, targets)
            return total, (parts, out)
        total, parts = self._semi_supervised(out, inputs, targets, batch,
                                             params, pre_step,
                                             generator or self._gen)
        return total, (parts, out)

    def _semi_supervised(self, out, inputs, targets, batch, params, buffers,
                         gen):
        """The `mixed` pairing's loss (JAX's `_loss`): semi_supervised_loss
        with an eval-mode re-inference and a re-degradation drawn from
        `gen`, plus the contrastive term when its weight is above 0 and the
        batch carries pairs. The extra forwards run in eval mode on
        `params` and `buffers` (None: the model's own)."""
        host = partial(self._host, batch)
        was_training = self.model.training

        def eval_forward(x, module=None):
            self.model.eval()
            try:
                return self._forward(x, params, buffers=buffers,
                                     module=module)
            finally:
                self.model.train(was_training)

        def redegrade(x):
            return _nwc(self._simulate(gen, x.transpose(1, 2)))

        total, parts = semi_supervised_loss(
            out, inputs, targets, host("is_synthetic"),
            model_fn=eval_forward, redegrade_fn=redegrade)
        if self.cfg.contrastive_weight > 0 and "contrastive_pair" in batch:
            # the opposite-type pair: a synthetic-type pair arrives clean
            # and is degraded here, as the main input was
            pair = host("contrastive_pair")
            pair_syn = host("contrastive_pair_is_synthetic")[:, None, None]
            degraded = self._simulate(gen, pair)
            pair_in = _nwc(torch.where(pair_syn > 0, degraded, pair))
            # the time-pooled bottleneck features of both inputs
            emb_a, emb_b = (eval_forward(x, self._encoder).mean(dim=1)
                            for x in (inputs, pair_in))
            contr = contrastive_loss(emb_a, emb_b, host("contrastive_label"))
            parts["contrastive"] = contr
            total = total + self.cfg.contrastive_weight * contr
            parts["total"] = total
        return total, parts

    def _update(self):
        """Clip the gradients (if configured), take the Adam step, update
        the EMA. Runs on the device with no host sync."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        if self.cfg.max_grad_norm > 0:
            # optax.clip_by_global_norm: g * max/|g| when |g| >= max
            grads = [p.grad for p in params]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            clip = self.cfg.max_grad_norm
            scale = torch.where(norm < clip, torch.ones_like(norm),
                                clip / norm)
            for g in grads:
                g.mul_(scale)
        self.optimizer.step()
        if self.ema_params is not None:
            # d * e + (1 - d) * p with d rounded to f32 first, as in JAX
            d = np.float32(self.cfg.ema_decay)
            rest = float(np.float32(1.0) - d)
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    self.ema_params[name].mul_(float(d)).add_(p, alpha=rest)

    def _step(self, batch, train: bool, generator=None):
        # a train step under a process group spans the global batch
        with dist.global_batch() if train else contextlib.nullcontext():
            inputs, targets = self._derive(batch, generator)
            if train:
                self.model.train()
                self.optimizer.zero_grad(set_to_none=True)
                loss, (parts, out) = self._loss(inputs, targets, None,
                                                batch, generator)
                loss.backward()
            else:
                self.model.eval()
                with torch.no_grad():
                    loss, (parts, out) = self._loss(inputs, targets,
                                                    self.ema_params, batch,
                                                    generator)
            metrics = {k: v.detach() for k, v in parts.items()}
            metrics["loss"] = loss.detach()
            moments = (stereo_moments(out.detach()) if out.shape[-1] == 2
                       else None)
            if dist.in_global_batch():
                metrics, moments = self._average_over_ranks(metrics, moments)
        if train:
            with annotate("train.update", device_ms=True):
                self._update()
        if moments is not None:
            metrics.update(stereo_metrics(moments=moments))
        return metrics

    def _average_over_ranks(self, metrics, moments):
        """Average the gradients over the ranks, and with them the step's
        logged values and stereo moments (one all-reduce): the loss of the
        global batch is the mean of the ranks' losses, each rank's being
        the mean over an equal share."""
        keys = sorted(metrics)
        local = torch.stack([metrics[k] for k in keys])
        if moments is not None:
            local = torch.cat([local, moments])
        avg = dist.average_gradients(self.model.parameters(), local)
        return (dict(zip(keys, avg[:len(keys)].unbind(0))),
                None if moments is None else avg[len(keys):])

    def _train_step(self, batch, generator=None):
        return self._step(batch, True, generator)

    def _eval_step(self, batch, generator=None):
        return self._step(batch, False, generator)

    # ------------------------------------------------------------- epochs
    def train_epoch(self) -> float:
        # the loss is summed on the device and read back only at the logging
        # cadence and at the end, so the host runs ahead of the card
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        n = 0
        # several processes: a rank-local break would leave the others in
        # the next step's all-reduce, so the stop is agreed every 50 steps
        # (one small collective); one process checks every step
        multi = dist.process_count() > 1
        agreed_stop = False
        for i, batch in enumerate(self.train_loader):
            if multi:
                if i % 50 == 0:
                    agreed_stop = dist.agree_flag(self.interrupted)
                if agreed_stop:
                    self.interrupted = True
                    break
            elif self.interrupted:
                break
            with annotate("train.step"):
                metrics = self._train_step(batch,
                                           self._seeded(2 * self.epoch, i))
            total += metrics["loss"]
            n += 1
            if self.logger and self.global_step % 50 == 0:
                self.logger.add_scalar("Loss/train_batch",
                                       float(metrics["loss"]),
                                       self.global_step)
                self.logger.add_scalar("Learning_Rate", self.lr,
                                       self.global_step)
                for tag in ("correlation", "width"):
                    if tag in metrics:
                        self.logger.add_scalar(f"Stereo/{tag}",
                                               float(metrics[tag]),
                                               self.global_step)
            self.global_step += 1
        return float(total) / max(n, 1)

    def eval_state(self):
        """Parameters for validation, rendering and test outputs: the EMA
        when ema_decay > 0, else None (the live parameters)."""
        return self.ema_params

    def eval_model(self) -> nn.Module:
        """A detached eval-mode copy of the model carrying eval_state()."""
        m = copy.deepcopy(self.model).eval()
        if self.ema_params is not None:
            with torch.no_grad():
                for name, p in m.named_parameters():
                    p.copy_(self.ema_params[name])
        return m

    def validate(self) -> float:
        if self.val_loader is None:
            return 0.0
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        n = 0
        for i, batch in enumerate(self.val_loader):
            total += self._eval_step(
                batch, self._seeded(2 * self.epoch + 1, i))["loss"]
            n += 1
        return float(total) / max(n, 1)

    def _plateau_step(self, val_loss: float):
        """ReduceLROnPlateau(min, patience=5, factor=0.5) semantics."""
        if val_loss < self.best_val_loss - 1e-8:
            self._plateau_wait = 0
        else:
            self._plateau_wait += 1
            if self._plateau_wait > self.cfg.plateau_patience:
                self.lr *= self.cfg.plateau_factor
                self._plateau_wait = 0
                for group in self.optimizer.param_groups:
                    group["lr"] = self.lr
                if self.logger:
                    self.logger.add_text(
                        "lr", f"reduced to {self.lr:.2e}", self.global_step)

    def train(self, num_epochs: Optional[int] = None,
              save_every: Optional[int] = None, test_audio_fn=None):
        num_epochs = num_epochs or self.cfg.num_epochs
        save_every = save_every or self.cfg.save_every
        print(f"training {self.model_name} on {self.device} - "
              f"{count_params(self.model):,} params")
        prev_sigint = None
        try:
            prev_sigint = signal.signal(signal.SIGINT, self._on_sigint)
        except ValueError:  # not in the main thread (tests)
            pass
        try:
            return self._train_loop(num_epochs, save_every, test_audio_fn)
        finally:
            # surface a background checkpoint failure and let the last
            # async write land before the process can exit
            if hasattr(self, "_async_ckpt"):
                self._async_ckpt.wait()
            if prev_sigint is not None:
                signal.signal(signal.SIGINT, prev_sigint)

    def _train_loop(self, num_epochs, save_every, test_audio_fn):
        for epoch in range(self.epoch, num_epochs):
            self.epoch = epoch + 1
            start = time.time()
            train_loss = self.train_epoch()
            if self._interrupted_all():
                # checkpoint the partial epoch before anything else can fail
                self.save_checkpoint(ckpt.epoch_checkpoint_name(self.epoch))
                break
            val_loss = self.validate()
            self._plateau_step(val_loss)
            hook = getattr(getattr(self.train_loader, "dataset", None),
                           "on_epoch_end", None)
            if hook is not None:
                hook()

            self.history["train_loss"].append(train_loss)
            self.history["val_loss"].append(val_loss)
            self.history["learning_rate"].append(self.lr)

            took = time.time() - start
            if self.logger:
                self.logger.add_scalar("Loss/train_epoch", train_loss,
                                       self.epoch)
                if self.val_loader is not None:
                    self.logger.add_scalar("Loss/val_epoch", val_loss,
                                           self.epoch)
                self.logger.add_scalar("Time/epoch_duration", took,
                                       self.epoch)
            # the render calls no collective here (the JAX package's is a
            # program over the global mesh that every rank enters), so
            # only the primary, the one writer, renders
            if (self.epoch % 10 == 0 and self.val_loader is not None
                    and dist.is_primary()):
                self.log_audio_samples()
            val_txt = (f"val {val_loss:.6f}"
                       if self.val_loader is not None else "val -")
            print(f"epoch {self.epoch}/{num_epochs} {took:.2f}s "
                  f"train {train_loss:.6f} {val_txt}")

            if self.epoch % save_every == 0:
                self.save_checkpoint(ckpt.epoch_checkpoint_name(self.epoch))
                if test_audio_fn:
                    test_audio_fn(self, f"epoch_{self.epoch}")
            if self.val_loader is not None and val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.save_checkpoint(ckpt.BEST)
                if test_audio_fn:
                    test_audio_fn(self, "best")
            if self._interrupted_all():  # SIGINT in validation, logging
                self.save_checkpoint(ckpt.epoch_checkpoint_name(self.epoch))
                break
        return self.history

    def _interrupted_all(self) -> bool:
        """The interrupt state agreed over the ranks (the local one in one
        process). Every rank must reach each call site equally often: the
        agreement is a collective."""
        if dist.process_count() > 1:
            self.interrupted = dist.agree_flag(self.interrupted)
        return self.interrupted

    def _render(self, batch, generator=None):
        """(inputs, targets, restored) [B, T, C] of the eval forward on
        the f32 eval weights, whatever the compute dtype (JAX's `_render`
        does not cast)."""
        inputs, targets = self._derive(batch, generator)
        self.model.eval()
        with torch.no_grad():
            out = self._forward(inputs, self.eval_state(),
                                dtype=torch.float32)
        return inputs, targets, out

    def log_audio_samples(self):
        """Render one validation item and log its input, target and output
        as WAVs (and TensorBoard audio when available)."""
        if self.val_loader is None:
            return
        batch = next(iter(self.val_loader), None)
        if batch is None:
            return
        inputs, targets, out = self._render(
            batch, self._seeded(1_000_000 + self.epoch))
        if self.logger is None:
            return
        for tag, arr in (("degraded", inputs), ("clean", targets),
                         ("restored", out)):
            self.logger.add_audio(f"Audio/{tag}", arr[0].cpu().numpy().T,
                                  self.sample_rate, self.epoch)

    # --------------------------------------------------------- checkpoints
    def save_checkpoint(self, filename: str, async_: bool = False):
        # the ranks hold the same state: only the primary writes (every
        # rank writing one path on shared storage would race)
        if not dist.is_primary():
            return
        path = self.checkpoint_dir / filename
        payload = {
            "model_state_dict": self.model.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "epoch": self.epoch,
            "global_step": self.global_step,
            "best_val_loss": self.best_val_loss,
            "lr": self.lr,
            "history": {k: [float(v) for v in vals]
                        for k, vals in self.history.items()},
            "model_name": self.model_name,
            "plateau_wait": self._plateau_wait,
        }
        if self.ema_params is not None:
            payload["ema_params"] = self.ema_params

        def retain():
            # only after the new file's atomic rename has landed
            if filename.startswith("checkpoint_epoch_"):
                ckpt.cleanup_old_epochs(self.checkpoint_dir, path)

        if async_:
            if not hasattr(self, "_async_ckpt"):
                self._async_ckpt = ckpt.AsyncCheckpointer()
            self._async_ckpt.save(path, payload, on_done=retain)
            print(f"checkpoint saving (async): {path}")
        else:
            ckpt.save_checkpoint(path, payload)
            retain()
            print(f"checkpoint saved: {path}")

    def load_checkpoint(self, filename_or_path):
        """Resume from a checkpoint: the port's `.pth`, or a `.msgpack` the
        JAX trainer wrote (its params, BN statistics, Adam moments and
        step, EMA, LR, plateau counter and history carried over)."""
        path = Path(filename_or_path)
        if not path.exists():
            path = self.checkpoint_dir / filename_or_path
        # read and check EVERY key before mutating the trainer, so a
        # rejected checkpoint leaves it as it was and maybe_resume's
        # fallback walk cannot leave it half loaded
        if path.suffix == ".msgpack":
            payload = self._payload_from_jax(ckpt.load_msgpack(path), path)
        else:
            payload = ckpt.load_checkpoint(path)
        saved_name = str(payload["model_name"])
        if saved_name != self.model_name:
            raise ValueError(
                f"checkpoint {path} is for model {saved_name!r}; this "
                f"trainer trains {self.model_name!r}")
        sd = payload["model_state_dict"]
        own = self.model.state_dict()
        if set(sd) != set(own) or any(
                tuple(sd[k].shape) != tuple(v.shape) for k, v in own.items()):
            raise ValueError(f"checkpoint {path} does not match the model's "
                             f"parameters")
        optimizer = self._make_optimizer()
        optimizer.load_state_dict(payload["opt_state"])
        ema = None
        if self.cfg.ema_decay > 0:
            # a pre-EMA checkpoint seeds the average from its weights
            src = payload.get("ema_params") or {
                n: sd[n] for n, _ in self.model.named_parameters()}
            ema = {n: src[n].to(self.device).clone()
                   for n, _ in self.model.named_parameters()}
        epoch = int(payload["epoch"])
        global_step = int(payload["global_step"])
        best_val_loss = float(payload["best_val_loss"])
        lr = float(payload["lr"])
        plateau_wait = int(payload.get("plateau_wait", 0))
        history = {k: [float(v) for v in vals]
                   for k, vals in payload["history"].items()}

        self.model.load_state_dict(sd, strict=True)
        self.optimizer = optimizer
        self.ema_params = ema
        self.epoch = epoch
        self.global_step = global_step
        self.best_val_loss = best_val_loss
        self.lr = lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self._plateau_wait = plateau_wait
        self.history = history
        print(f"checkpoint loaded: {path} (epoch {self.epoch})")

    def _payload_from_jax(self, payload: dict, path) -> dict:
        """A JAX trainer's checkpoint payload as the port's: the weights and
        EMA through state_dict_from_jax, the optax leaves as Adam's state
        (compat/optim.py; the layout the trainer's clipping gives, else a
        ValueError), the rest as saved."""
        name = payload["model_name"]
        name = name.decode() if isinstance(name, bytes) else str(name)
        if name != self.model_name:
            raise ValueError(
                f"checkpoint {path} is for model {name!r}; this trainer "
                f"trains {self.model_name!r}")
        params, model_state = payload["params"], payload["model_state"]
        sd = state_dict_from_jax(name, params, model_state)
        lr = float(np.asarray(payload["lr"]))
        step, mu, nu = adam_from_jax(
            payload["opt_state"]["leaves"], LeafMap(name, self.model),
            clipped=self.cfg.max_grad_norm > 0, lr=lr)
        template = self._make_optimizer().state_dict()
        names = [n for n, _ in self.model.named_parameters()]
        opt_state = {"param_groups": template["param_groups"], "state": {
            i: {"step": torch.tensor(float(step)),
                "exp_avg": torch.from_numpy(mu[n]),
                "exp_avg_sq": torch.from_numpy(nu[n])}
            for i, n in enumerate(names)}}
        ema = payload.get("ema_params")
        if ema is not None:
            ema = state_dict_from_jax(name, ema, model_state)
            ema = {n: ema[n] for n in names}
        return {"model_name": name, "model_state_dict": sd,
                "opt_state": opt_state, "ema_params": ema,
                "epoch": int(np.asarray(payload["epoch"])),
                "global_step": int(np.asarray(payload["global_step"])),
                "best_val_loss": float(np.asarray(payload["best_val_loss"])),
                "lr": lr,
                "plateau_wait": int(np.asarray(payload.get("plateau_wait",
                                                           0))),
                "history": {k: np.asarray(v, np.float64).tolist()
                            for k, v in payload["history"].items()}}

    def maybe_resume(self):
        """Resume from the newest readable checkpoint. Saves are atomic, but
        a file corrupted at rest must not kill the restart: fall back
        through older epoch checkpoints, then best_model, warning for each
        skipped file.

        Several processes: the primary walks the list and broadcasts its
        choice, and every other rank loads exactly that file and raises if
        it cannot (a rank that fell back on its own would train other
        weights from another step)."""
        if dist.process_count() > 1:
            chosen = ""
            if dist.is_primary():
                chosen = self._resume_from_first_readable() or ""
            chosen = dist.broadcast_from_primary(chosen)
            if not chosen:
                return False
            if not dist.is_primary():
                self.load_checkpoint(self.checkpoint_dir / chosen)
            return True
        return self._resume_from_first_readable() is not None

    def _resume_from_first_readable(self):
        """Load the first readable checkpoint of the retention list; its
        file name, or None."""
        for path in ckpt.all_checkpoints(self.checkpoint_dir):
            try:
                self.load_checkpoint(path)
                return path.name
            except Exception as e:  # unreadable or foreign: try the next
                warnings.warn(f"skipping unreadable checkpoint {path}: {e}")
        return None


class _Encoder(nn.Module):
    """`model.encode` as the forward of a module holding the model, so
    torch.func.functional_call can run it on other parameters."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model.encode(x)


# -------------------------------------------------------------- test audio
def render_test_outputs(trainer: Trainer, suffix: str, test_audio_dir,
                        test_output_dir, sample_rate: int = 22050,
                        max_seconds: int = 30, chunk_seconds: float = 2.0):
    """Restore each test file with the trained stage (eval weights) in its
    own slot of the pipeline, every save interval: mono mix at
    `sample_rate`, first 30 s, chunked inference with no crossfade; writes
    _original/_degraded/_restored WAVs and keeps only the newest epoch's
    outputs."""
    from ..audio import find_audio_files, load_audio, save_audio
    from ..pipeline import RestorationPipeline

    test_dir = Path(test_audio_dir)
    out_dir = Path(test_output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = find_audio_files(test_dir, recursive=False)
    if not files:
        print(f"  no test audio in {test_dir}")
        return
    slot = {"denoiser": "denoiser", "super_resolution": "super_resolution",
            "stereo_separator": "stereo"}[trainer.model_name]
    pipe = RestorationPipeline(
        **{slot: trainer.eval_model()},
        config=PipelineConfig(sample_rate=sample_rate,
                              chunk_seconds=chunk_seconds,
                              overlap_seconds=0.0),
        device=trainer.device)
    for f in files:
        file_id = f.stem
        audio, _ = load_audio(f, sample_rate, mono=True)
        audio = audio[:, :sample_rate * max_seconds]
        original = out_dir / f"{file_id}_original.wav"
        if not original.exists():
            save_audio(original, audio, sample_rate)
        restored, out_rate = pipe.restore(audio, sample_rate)
        save_audio(out_dir / f"{file_id}_degraded_{suffix}.wav", audio,
                   sample_rate)
        save_audio(out_dir / f"{file_id}_restored_{suffix}.wav",
                   restored.cpu().numpy(), out_rate)
        if suffix.startswith("epoch_"):
            current = int(suffix.split("_")[1])
            for old in out_dir.glob(f"{file_id}_*_epoch_*.wav"):
                try:
                    if int(old.stem.rsplit("_epoch_", 1)[1]) != current:
                        old.unlink()
                except (ValueError, IndexError):
                    pass
    print(f"  test outputs -> {out_dir}")


# ---------------------------------------------------------------- frontend
def build_trainer(cfg: Config, steps_per_epoch: Optional[int] = None,
                  device="cuda", dataset_kind: str = "standard") -> Trainer:
    """The Trainer that train_from_config runs: the family's dataset and
    split, seeded loaders, the model initialized from `cfg.train.seed`
    (drawn on the CPU, so a seed gives the same weights on any device), the
    logger, and the checkpoint directory <checkpoint_dir>/<model>, resumed
    if it holds a readable checkpoint. dataset_kind: 'standard', or for the
    denoiser 'mixed' (synthetic + real degraded recordings from
    `data.degraded_dir`, semi-supervised) or 'adaptive' (artifact
    statistics fitted to those recordings); other families ignore it, as
    in the JAX package."""
    from ..data import (
        AdaptiveArtifactDataset, DataLoader, MixedRestorationDataset,
        RestorationDataset, StereoDataset, SuperResolutionDataset,
        train_val_split)

    name = cfg.train.model
    d = cfg.data
    if name == "denoiser":
        if dataset_kind == "mixed":
            dataset = MixedRestorationDataset(
                d.data_dir, d.degraded_dir, d.sample_rate, d.chunk_duration,
                synthetic_ratio=d.synthetic_ratio,
                resample_chunks=d.resample_chunks)
        elif dataset_kind == "adaptive":
            dataset = AdaptiveArtifactDataset(
                d.data_dir, d.degraded_dir, d.sample_rate, d.chunk_duration,
                resample_chunks=d.resample_chunks)
        else:
            dataset = RestorationDataset(d.data_dir, d.sample_rate,
                                         d.chunk_duration,
                                         resample_chunks=d.resample_chunks)
        model_kwargs = dataclasses.asdict(cfg.denoiser)
        model_kwargs["features"] = tuple(model_kwargs["features"])
    elif name == "super_resolution":
        dataset = SuperResolutionDataset(d.data_dir,
                                         chunk_duration=d.chunk_duration,
                                         resample_chunks=d.resample_chunks)
        model_kwargs = dataclasses.asdict(cfg.super_resolution)
    elif name == "stereo_separator":
        dataset = StereoDataset(d.data_dir, d.sample_rate, d.chunk_duration,
                                resample_chunks=d.resample_chunks)
        model_kwargs = dataclasses.asdict(cfg.stereo_separator)
    else:
        raise ValueError(f"unknown model {name!r}")
    tr_idx, va_idx = train_val_split(dataset, d.val_split, cfg.train.seed)
    if steps_per_epoch:
        tr_idx = tr_idx[:steps_per_epoch * cfg.train.batch_size]
    # several processes: each loads a disjoint stride of the train indices
    # and feeds its share of the global batch (the config's batch size).
    # Validation is not sharded: every process evaluates the same whole
    # set, so val_loss, which drives the plateau scheduler, is the same
    # on every rank
    tr_idx = dist.shard_indices_by_process(tr_idx)
    batch_size = dist.local_batch_size(cfg.train.batch_size)
    train_loader = DataLoader(dataset, batch_size, indices=tr_idx,
                              seed=cfg.train.seed + dist.process_index())
    if dist.process_count() > 1:
        shown = ", ".join(str(int(i)) for i in tr_idx[:8])
        print(f"process {dist.process_index()} of {dist.process_count()}: "
              f"{len(tr_idx)} train items ({shown}"
              f"{', ...' if len(tr_idx) > 8 else ''}), local batch "
              f"{batch_size}", flush=True)
    # the validation batch is clamped to the split, so a small split still
    # validates (and drives best-model tracking and the plateau scheduler),
    # and rounded down to a multiple of this process's share of the data
    # axis, as in the JAX package; one device a process makes that share 1
    share = max(1, cfg.train.data_parallel // dist.process_count())
    val_bs = (min(batch_size, len(va_idx)) // share) * share
    if val_bs == 0 and len(va_idx) > 0:
        print(f"validation disabled: split of {len(va_idx)} items cannot "
              f"fill one {share}-way sharded batch")
    val_loader = (DataLoader(dataset, val_bs, indices=va_idx,
                             shuffle=False, seed=cfg.train.seed)
                  if val_bs > 0 else None)

    model = init_params(MODELS[name](**model_kwargs),
                        torch.Generator().manual_seed(cfg.train.seed))
    # the primary is the one writer of metrics (checkpoints are gated in
    # Trainer.save_checkpoint, test renders in train_from_config)
    logger = (MetricsLogger(Path(cfg.train.log_dir) / name, name)
              if dist.is_primary() else None)
    trainer = Trainer(name, model, train_loader, val_loader,
                      config=cfg.train, artifact_config=d.artifacts,
                      sample_rate=d.sample_rate, logger=logger,
                      device=dist.device_for_rank(device))
    trainer.checkpoint_dir = Path(cfg.train.checkpoint_dir) / name
    trainer.maybe_resume()
    return trainer


def train_from_config(cfg: Config, steps_per_epoch: Optional[int] = None,
                      device="cuda", dataset_kind: str = "standard"):
    """Config-driven training: build_trainer, then train() with test-audio
    rendering (by the primary) when `cfg.train.test_audio_dir` is set.
    Returns the history. Leaves the process group, if any, on the way
    out."""
    try:
        trainer = build_trainer(cfg, steps_per_epoch, device, dataset_kind)
        test_fn = None
        if cfg.train.test_audio_dir and dist.is_primary():
            out_dir = (cfg.train.test_output_dir
                       or f"outputs/{cfg.train.model}_tests")
            test_fn = partial(render_test_outputs,
                              test_audio_dir=cfg.train.test_audio_dir,
                              test_output_dir=out_dir,
                              sample_rate=cfg.data.sample_rate,
                              chunk_seconds=cfg.data.chunk_duration)
        try:
            return trainer.train(test_audio_fn=test_fn)
        finally:
            if trainer.logger is not None:
                trainer.logger.close()
    finally:
        dist.shutdown()
