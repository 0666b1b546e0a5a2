"""Weights in and out of the port's models.

`state_dict_from_jax` turns the JAX package's `(params, state)` pytrees,
given as numpy arrays (or anything `np.asarray` takes), into the port's
state dict, which carries the upstream key names. It is the port's own copy
of the mapping in ml_audio_restoration_tpu/compat/torch_saver.py.
`load_pth` reads an upstream `.pth` checkpoint, and `model_from_state_dict`
builds the model whose shapes the state dict describes.

Layouts: JAX conv kernels are [k, in, out] -> torch Conv1d [out, in, k];
JAX transpose-conv kernels are [k, in, out] in torch's kernel order ->
ConvTranspose1d [in, out, k]; JAX LSTM weights [C, 4H] / [H, 4H] -> torch
[4H, C] / [4H, H]; BN scale/bias/mean/var -> weight/bias/running_mean/
running_var (+ num_batches_tracked).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models import AudioDenoiser, AudioSuperResolution, StereoSeparator

MODELS = ("denoiser", "super_resolution", "stereo_separator")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["w"]), (2, 1, 0)))
    sd[f"{prefix}.bias"] = _t(p["b"])


def _conv_t(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["w"]), (1, 2, 0)))
    sd[f"{prefix}.bias"] = _t(p["b"])


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv_bn(sd, conv_prefix, bn_prefix, p, s):
    _conv(sd, conv_prefix, p["conv"])
    _bn(sd, bn_prefix, p["bn"], s["bn"])


def _double_block(sd, prefix, p, s):
    _conv_bn(sd, f"{prefix}.0", f"{prefix}.1", p["c1"], s["c1"])
    _conv_bn(sd, f"{prefix}.3", f"{prefix}.4", p["c2"], s["c2"])


def _denoiser(params, state, sd):
    for i, (p, s) in enumerate(zip(params["encoder"], state["encoder"])):
        _double_block(sd, f"encoder.{i}", p, s)
    _double_block(sd, "bottleneck", params["bottleneck"], state["bottleneck"])
    for i, (up, p, s) in enumerate(zip(params["up"], params["decoder"],
                                       state["decoder"])):
        _conv_t(sd, f"decoder.{2 * i}", up)
        _double_block(sd, f"decoder.{2 * i + 1}", p, s)
    for j, layer in zip((0, 2, 4), params["transient_detector"]):
        _conv(sd, f"transient_detector.{j}", layer)
    _conv(sd, "final_conv", params["final_conv"])


def _super_resolution(params, state, sd):
    _conv(sd, "initial.0", params["initial"])
    for i, (p, s) in enumerate(zip(params["blocks"], state["blocks"])):
        _conv(sd, f"residual_blocks.{i}.conv1", p["conv1"])
        _bn(sd, f"residual_blocks.{i}.bn1", p["bn1"], s["bn1"])
        _conv(sd, f"residual_blocks.{i}.conv2", p["conv2"])
        _bn(sd, f"residual_blocks.{i}.bn2", p["bn2"], s["bn2"])
    _conv(sd, "middle.0", params["middle"]["conv"])
    _bn(sd, "middle.1", params["middle"]["bn"], state["middle"]["bn"])
    for i, up in enumerate(params["upsample"]):
        _conv_t(sd, f"upsample_blocks.{i}.0", up)
    _conv(sd, "hf_emphasis.0", params["hf"])
    _conv(sd, "reconstruction", params["recon"])


def _stereo_separator(params, state, sd):
    _conv_bn(sd, "encoder.0.0", "encoder.0.1", params["stem"], state["stem"])
    for i, (p, s) in enumerate(zip(params["blocks"], state["blocks"]),
                               start=1):
        _conv_bn(sd, f"encoder.{i}.0", f"encoder.{i}.1", p["dilated"],
                 s["dilated"])
        _conv_bn(sd, f"encoder.{i}.3", f"encoder.{i}.4", p["pointwise"],
                 s["pointwise"])
    for k, layer in enumerate(params["lstm"]):
        sd[f"lstm.weight_ih_l{k}"] = _t(np.asarray(layer["w_ih"]).T)
        sd[f"lstm.weight_hh_l{k}"] = _t(np.asarray(layer["w_hh"]).T)
        sd[f"lstm.bias_ih_l{k}"] = _t(layer["b_ih"])
        sd[f"lstm.bias_hh_l{k}"] = _t(layer["b_hh"])
    for side in ("left", "right"):
        p, s = params[side], state[side]
        prefix = f"{side}_decoder"
        _conv_bn(sd, f"{prefix}.0", f"{prefix}.1", p["l1"], s["l1"])
        _conv_bn(sd, f"{prefix}.3", f"{prefix}.4", p["l2"], s["l2"])
        _conv_bn(sd, f"{prefix}.6", f"{prefix}.7", p["l3"], s["l3"])
        _conv(sd, f"{prefix}.9", p["final"])


_FROM_JAX = {"denoiser": _denoiser, "super_resolution": _super_resolution,
             "stereo_separator": _stereo_separator}


def state_dict_from_jax(model: str, params, state) -> dict:
    """JAX `(params, state)` of `model` (one of MODELS) -> the port's state
    dict {upstream key: CPU tensor}."""
    if model not in _FROM_JAX:
        raise KeyError(f"unknown model {model!r}; expected {MODELS}")
    sd = {}
    _FROM_JAX[model](params, state, sd)
    return sd


def load_pth(path) -> dict:
    """Read an upstream `.pth` (a trainer dict holding `model_state_dict`,
    or a bare state dict) -> {key: CPU tensor}. Tensors only: the file is
    loaded with weights_only=True."""
    ckpt = torch.load(str(Path(path)), map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    if not out:
        raise ValueError(f"{path}: no tensor entries found in checkpoint")
    return out


def _count(sd, fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def model_from_state_dict(model: str, sd: dict, device="cpu"):
    """Build the `model` whose shapes `sd` describes, load `sd` strictly,
    and return it in eval mode on `device`."""
    if model == "denoiser":
        levels = _count(sd, "encoder.{}.0.weight")
        m = AudioDenoiser(
            in_channels=sd["encoder.0.0.weight"].shape[1],
            out_channels=sd["final_conv.weight"].shape[0],
            features=tuple(sd[f"encoder.{i}.0.weight"].shape[0]
                           for i in range(levels)))
    elif model == "super_resolution":
        m = AudioSuperResolution(
            upscale_factor=2 ** _count(sd, "upsample_blocks.{}.0.weight"),
            channels=sd["initial.0.weight"].shape[1],
            base_channels=sd["initial.0.weight"].shape[0],
            num_residual_blocks=_count(sd, "residual_blocks.{}.conv1.weight"))
    elif model == "stereo_separator":
        m = StereoSeparator(
            base_channels=sd["encoder.0.0.weight"].shape[0],
            lstm_hidden=sd["lstm.weight_hh_l0"].shape[1],
            num_lstm_layers=_count(sd, "lstm.weight_ih_l{}"))
    else:
        raise KeyError(f"unknown model {model!r}; expected {MODELS}")
    m.load_state_dict(sd, strict=True)
    return m.to(device).eval()
