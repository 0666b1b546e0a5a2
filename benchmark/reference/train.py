"""Plain reference of the stereo separator's training steps: the train-mode
forward (batch statistics), the upstream training loss for stereo output,
autograd, and Adam written out.

The loss is the upstream combined loss as the configuration weighs it
(`train` group): time MSE, the multi-scale log-magnitude spectral L1
(FFT 512 / 1024 / 2048, hop a quarter, periodic Hann, centre reflect
padding, log(|S| + 1e-5)), the spectral clustering term (smooth L1 over
adjacent-bin differences of (L-R)/(L+R+1e-8), FFT 2048) and the temporal
consistency term (squared change of side/(mid+side) over the RMS of
512-sample windows, hop 256).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import models as M

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
FFT_SIZES = (512, 1024, 2048)
LOG_EPS = 1e-5
EPS = 1e-8


def _mag(x, n_fft):
    """|STFT| of [R, T] -> [R, bins, frames]; the window computed in
    float64 and rounded once."""
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float64,
                            device=x.device).to(x.dtype)
    return torch.stft(x, n_fft, n_fft // 4, window=win, center=True,
                      pad_mode="reflect", return_complex=True).abs()


def loss(out, target, w: dict):
    """out, target [B, 2, T] -> (the weighted total, {part: value})."""
    time = torch.mean((out - target) ** 2)
    o, t = out.flatten(0, 1), target.flatten(0, 1)
    spec = sum(torch.mean((torch.log(_mag(o, n) + LOG_EPS)
                           - torch.log(_mag(t, n) + LOG_EPS)).abs())
               for n in FFT_SIZES) / len(FFT_SIZES)
    left, right = _mag(out[:, 0], 2048), _mag(out[:, 1], 2048)
    pos = (left - right) / (left + right + EPS)
    d = torch.diff(pos, dim=1)
    clus = F.smooth_l1_loss(d, torch.zeros_like(d), beta=1.0)
    win = out.unfold(-1, 512, 256)  # [B, 2, W, 512]
    rms = torch.sqrt(torch.mean(win ** 2, dim=-1) + EPS)
    mid = (rms[:, 0] + rms[:, 1]) / 2.0
    side = (rms[:, 0] - rms[:, 1]).abs() / 2.0
    width = side / (mid + side + EPS)
    cons = torch.mean(torch.diff(width, dim=-1) ** 2)
    total = (w["time_weight"] * time + w["spectral_weight"] * spec
             + w["clustering_weight"] * clus
             + w["consistency_weight"] * cons)
    return total, {"time": time, "spectral": spec, "clustering": clus,
                   "consistency": cons}


def steps(cfg: dict, sd0: dict, batches, ops=M.F32, rows=None) -> dict:
    """Train from the state dict `sd0` over `batches` ([B, 2, T] each, on
    the device), one Adam step a batch, each step on its first `rows` rows
    when given. Returns {"losses": [float], "out1": the first step's
    output, "grad1": {leaf: the first step's gradient}, "params1" /
    "params": {leaf: value after the first / the last step}}."""
    tw = cfg["train"]
    lr, b1, b2, eps = tw["learning_rate"], 0.9, 0.999, 1e-8
    names = [k for k in sd0 if not k.endswith(BUFFERS)]
    params = {k: sd0[k].detach().clone().requires_grad_(True) for k in names}
    fixed = {k: v for k, v in sd0.items() if k not in params}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    lstm = M.lstm_module(sd0, next(iter(params.values())).device)
    losses, out1, grad1, params1 = [], None, None, None
    for t, stereo in enumerate(batches, start=1):
        if rows is not None:
            stereo = stereo[:rows]
        sd = {**fixed, **params}
        out = M.stereo(sd, stereo.mean(dim=1, keepdim=True), train=True,
                       ops=ops, lstm=lstm)
        total, _ = loss(out, stereo, tw)
        grads = torch.autograd.grad(total, list(params.values()))
        losses.append(float(total.detach()))
        if grad1 is None:
            out1 = out.detach().float()
            grad1 = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).add_(g * g, alpha=1 - b2)
                step = lr / (1 - b1 ** t)
                denom = (v[k] / (1 - b2 ** t)).sqrt() + eps
                p.sub_(step * m[k] / denom)
        if params1 is None:
            params1 = {k: p.detach().clone() for k, p in params.items()}
    return {"losses": losses, "out1": out1, "grad1": grad1,
            "params1": params1,
            "params": {k: p.detach() for k, p in params.items()}}
