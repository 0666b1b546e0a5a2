"""Training runtime of the port: the denoiser, super-resolution and
stereo-separator families.

Counterpart of ml_audio_restoration_tpu/train/trainer.py. The pairings
derive (input, target) on the device from each host batch: `degrade` runs
the 78rpm simulator (data/artifacts.py) on the clean chunk inside the
step, with draws from a generator seeded from (seed, epoch, step) as the
JAX package folds them into its key, so a resumed run draws the same
degradations; `downsample` makes the SR input with the linear downsample
by the model's factor; `mono_target_stereo` takes the channel mean of a
stereo chunk; `identity` trains on clean pairs. Adam with optional
global-norm clipping (optax's `clip_by_global_norm` semantics),
ReduceLROnPlateau (patience 5, factor 0.5) by mutating the optimizer's
`lr`, an optional EMA of the weights for validation and rendering,
checkpoint/resume with retention and a corrupt-file fallback, metrics
every 50 steps.

Under grad the stereo LSTM runs the training recurrence (K2 forward, K3
backward, csrc/lstm_train.cu); validation and rendering run the eval
forward under no grad, which takes the inference kernel K1. The denoiser
and SR are convolutions only.

Not ported yet: the mixed and adaptive datasets and their pairings
(ROADMAP item 3), bf16 compute (item 2), data parallelism or multi-host
(item 8). Asking for them raises NotImplementedError.
"""
from __future__ import annotations

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

from ..config import ArtifactConfig, Config, PipelineConfig, TrainConfig
from ..data.artifacts import simulate_batch
from ..losses import restoration_loss, stereo_metrics
from ..models import (
    AudioDenoiser, AudioSuperResolution, StereoSeparator, count_params,
    init_params)
from ..ops import interp_linear
from ..pipeline.restore import resolve_device
from . import checkpoints as ckpt
from .metrics import MetricsLogger

MODELS = {"denoiser": AudioDenoiser,
          "super_resolution": AudioSuperResolution,
          "stereo_separator": StereoSeparator}
PAIRINGS = ("degrade", "identity", "downsample", "mono_target_stereo")
# the JAX package's other pairings, and the dataset kinds that give them
SEMI_SUPERVISED = ("mixed", "degrade_adaptive")


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
    if pairing in SEMI_SUPERVISED:
        raise NotImplementedError(
            f"pairing {pairing!r}: semi-supervised and adaptive training "
            f"are not ported yet (ROADMAP item 3); the port trains with "
            f"{PAIRINGS}")
    if pairing not in PAIRINGS:
        raise ValueError(f"unknown pairing {pairing!r}")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: bf16 training is not "
            f"ported yet (ROADMAP item 2)")
    if cfg.data_parallel > 1:
        raise NotImplementedError(
            f"data_parallel={cfg.data_parallel}: data-parallel training is "
            f"not ported yet (ROADMAP item 8)")


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
        self.device = resolve_device(device)
        # full f32 as in the JAX package: cuDNN's TF32 default would keep
        # about three decimal digits in every convolution
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
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

    def _derive(self, batch, generator: Optional[torch.Generator] = None):
        """(inputs, targets) [B, T, C] on the device from a host batch.
        `degrade` draws from `generator` (default: the trainer's, where it
        stands)."""
        def host(key):
            return torch.as_tensor(batch[key]).to(self.device)

        p = self.pairing
        if p == "degrade":
            clean = host("clean")
            degraded = simulate_batch(generator or self._gen, clean,
                                      self.sample_rate, self.artifact_cfg)
            return _nwc(degraded), _nwc(clean)
        if p == "downsample":
            high = host("high")
            low = interp_linear(high, high.shape[-1] // self._sr_factor)
            return _nwc(low), _nwc(high)
        if p == "mono_target_stereo":
            stereo = _nwc(host("stereo"))
            return stereo.mean(dim=-1, keepdim=True), stereo
        x = _nwc(host("clean"))
        return x, x

    def _forward(self, inputs, params=None):
        """Model output [B, T, C] for inputs [B, T, 1], in the model's
        current mode; `params` ({name: tensor}) replaces its parameters."""
        x = inputs.transpose(1, 2)
        if params is None:
            out = self.model(x)
        else:
            out = torch.func.functional_call(self.model, params, (x,))
        return out.transpose(1, 2)

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

    def _loss(self, inputs, targets, params=None):
        """(total, (parts, out)), as JAX's `_loss` without the state: the
        train forward updates the BN buffers in place."""
        out = self._forward(inputs, params)
        total, parts = self._criterion(out, targets)
        return total, (parts, out)

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
        inputs, targets = self._derive(batch, generator)
        if train:
            self.model.train()
            self.optimizer.zero_grad(set_to_none=True)
            loss, (parts, out) = self._loss(inputs, targets)
            loss.backward()
            self._update()
        else:
            self.model.eval()
            with torch.no_grad():
                loss, (parts, out) = self._loss(inputs, targets,
                                                self.ema_params)
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["loss"] = loss.detach()
        if out.shape[-1] == 2:
            with torch.no_grad():
                metrics.update(stereo_metrics(out.detach()))
        return metrics

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
        for i, batch in enumerate(self.train_loader):
            if self.interrupted:
                break
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
            if self.interrupted:
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
            if self.epoch % 10 == 0 and self.val_loader is not None:
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
            if self.interrupted:  # SIGINT during validation or logging
                self.save_checkpoint(ckpt.epoch_checkpoint_name(self.epoch))
                break
        return self.history

    def _render(self, batch, generator=None):
        """(inputs, targets, restored) [B, T, C] of the eval forward."""
        inputs, targets = self._derive(batch, generator)
        self.model.eval()
        with torch.no_grad():
            out = self._forward(inputs, self.eval_state())
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
        path = Path(filename_or_path)
        if not path.exists():
            path = self.checkpoint_dir / filename_or_path
        payload = ckpt.load_checkpoint(path)
        # read and check EVERY key before mutating the trainer, so a
        # rejected checkpoint leaves it as it was and maybe_resume's
        # fallback walk cannot leave it half loaded
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

    def maybe_resume(self):
        """Resume from the newest readable checkpoint. Saves are atomic, but
        a file corrupted at rest must not kill the restart: fall back
        through older epoch checkpoints, then best_model, warning for each
        skipped file."""
        for path in ckpt.all_checkpoints(self.checkpoint_dir):
            try:
                self.load_checkpoint(path)
                return True
            except Exception as e:  # unreadable or foreign: try the next
                warnings.warn(f"skipping unreadable checkpoint {path}: {e}")
        return False


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
    if it holds a readable checkpoint. dataset_kind 'mixed' and 'adaptive'
    (the denoiser's semi-supervised datasets) are not ported yet."""
    from ..data import (
        DataLoader, RestorationDataset, StereoDataset, SuperResolutionDataset,
        train_val_split)

    name = cfg.train.model
    if dataset_kind != "standard":
        raise NotImplementedError(
            f"dataset_kind={dataset_kind!r}: the mixed and adaptive datasets "
            f"are not ported yet (ROADMAP item 3)")
    d = cfg.data
    if name == "denoiser":
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
    batch_size = cfg.train.batch_size
    train_loader = DataLoader(dataset, batch_size, indices=tr_idx,
                              seed=cfg.train.seed)
    # the validation batch is clamped to the split, so a small split still
    # validates (and drives best-model tracking and the plateau scheduler)
    val_bs = min(batch_size, len(va_idx))
    val_loader = (DataLoader(dataset, val_bs, indices=va_idx,
                             shuffle=False, seed=cfg.train.seed)
                  if val_bs > 0 else None)

    model = init_params(MODELS[name](**model_kwargs),
                        torch.Generator().manual_seed(cfg.train.seed))
    logger = MetricsLogger(Path(cfg.train.log_dir) / name, name)
    trainer = Trainer(name, model, train_loader, val_loader,
                      config=cfg.train, artifact_config=d.artifacts,
                      sample_rate=d.sample_rate, logger=logger,
                      device=device)
    trainer.checkpoint_dir = Path(cfg.train.checkpoint_dir) / name
    trainer.maybe_resume()
    return trainer


def train_from_config(cfg: Config, steps_per_epoch: Optional[int] = None,
                      device="cuda", dataset_kind: str = "standard"):
    """Config-driven training: build_trainer, then train() with test-audio
    rendering when `cfg.train.test_audio_dir` is set. Returns the history."""
    trainer = build_trainer(cfg, steps_per_epoch, device, dataset_kind)
    test_fn = None
    if cfg.train.test_audio_dir:
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
