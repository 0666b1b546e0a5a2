"""The system under test, built from a configuration file: the program's
three models at the configuration's widths, with seeded weights made on
the device (`weights.seed_model`), and the state dicts the reference is
given.

Random batch-norm statistics leave a random net's output mostly a
constant: each stage's offset swamps its signal (a denoiser output of
standard deviation 0.001 around -0.013), and a comparison of outputs then
sees little but the output's own rounding. So the serving stages'
statistics are calibrated, as training leaves them: the plain reference
runs each stage in train mode on a seeded calibration batch (four 2 s
clips, each stage fed the previous one's eval output) and keeps the
batch's statistics. Both the program and the reference get them."""
from __future__ import annotations

import torch

from .signals import seed_seq, side
from .weights import seed_model, snapshot

STAGES = ("denoiser", "super_resolution", "stereo_separator")


def build_models(config: dict, device, seed: int, stages=STAGES) -> dict:
    """{stage: the program's model, on `device`, in eval mode}, each from
    one draw of a device generator seeded by (seed, 0)."""
    from ml_audio_restoration_torch.models import (
        AudioDenoiser, AudioSuperResolution, StereoSeparator)

    classes = {"denoiser": AudioDenoiser,
               "super_resolution": AudioSuperResolution,
               "stereo_separator": StereoSeparator}
    gen = torch.Generator(device=device).manual_seed(seed_seq(seed, 0))
    out = {}
    for name in stages:
        kw = dict(config[name])
        if "features" in kw:
            kw["features"] = tuple(kw["features"])
        out[name] = seed_model(classes[name](**kw).to(device), gen).eval()
    if tuple(stages) == STAGES:
        calibrate(out, config, device, seed)
    return out


@torch.no_grad()
def calibrate(models: dict, config: dict, device, seed: int):
    """Set the serving stages' batch-norm statistics to those of a seeded
    calibration batch, stage by stage (see the module's docstring)."""
    from benchmark.reference import models as M

    rate = config["pipeline"]["sample_rate"]
    gen = torch.Generator(device=device).manual_seed(seed_seq(seed, 7))
    x = torch.stack([side(int(2 * rate), rate, gen) for _ in range(4)])
    x = x[:, None]
    sds = {k: {n: t.clone() for n, t in m.state_dict().items()}
           for k, m in models.items()}
    levels = len(config["denoiser"]["features"])
    blocks = config["super_resolution"]["num_residual_blocks"]
    M.denoiser(sds["denoiser"], x, "calibrate", levels=levels)
    x = M.denoiser(sds["denoiser"], x, levels=levels)
    M.super_resolution(sds["super_resolution"], x, "calibrate", blocks=blocks)
    x = M.super_resolution(sds["super_resolution"], x, blocks=blocks)
    M.stereo_encode(sds["stereo_separator"], x, "calibrate")
    lstm = M.lstm_module(sds["stereo_separator"], device)
    h, _ = M.lstm_run(lstm, M.stereo_encode(sds["stereo_separator"], x))
    M.stereo_decode(sds["stereo_separator"], h, "calibrate")
    for k, m in models.items():
        m.load_state_dict(sds[k])


def snapshots(models: dict) -> dict:
    return {name: snapshot(m) for name, m in models.items()}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pinned(shape, device) -> torch.Tensor:
    """A host buffer: pinned when a card serves, so copies run async."""
    return torch.empty(shape, pin_memory=torch.device(device).type == "cuda")


class Phases:
    """Seconds of each set-up phase since the previous mark, synchronised
    with the card, for the run's info lines."""

    def __init__(self):
        import time

        self._clock = time.perf_counter
        self._last = self._clock()
        self.done = {}

    def mark(self, name: str):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = self._clock()
        self.done[name] = round(now - self._last, 3)
        self._last = now
