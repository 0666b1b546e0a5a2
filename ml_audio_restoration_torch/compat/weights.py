"""Weights in and out of the port's models.

`state_dict_from_jax` turns the JAX package's `(params, state)` pytrees,
given as numpy arrays (or anything `np.asarray` takes), into the port's
state dict, which carries the upstream key names. It is the port's own copy
of the mapping in ml_audio_restoration_tpu/compat/torch_saver.py, and
`jax_from_state_dict`, the inverse, is its copy of the converters of
ml_audio_restoration_tpu/compat/torch_loader.py (numpy arrays out).
`load_pth` reads an upstream `.pth` checkpoint, `model_from_state_dict`
builds the model whose shapes the state dict describes, and `save_pth`
writes the upstream `{"epoch", "model_state_dict"}` file.

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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _conv_in(sd, prefix):
    return {"w": np.transpose(_np(sd[f"{prefix}.weight"]), (2, 1, 0)),
            "b": _np(sd[f"{prefix}.bias"])}


def _conv_t_in(sd, prefix):
    return {"w": np.transpose(_np(sd[f"{prefix}.weight"]), (2, 0, 1)),
            "b": _np(sd[f"{prefix}.bias"])}


def _bn_in(sd, prefix):
    return ({"scale": _np(sd[f"{prefix}.weight"]),
             "bias": _np(sd[f"{prefix}.bias"])},
            {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])})


def _conv_bn_in(sd, conv_prefix, bn_prefix):
    bn_p, bn_s = _bn_in(sd, bn_prefix)
    return {"conv": _conv_in(sd, conv_prefix), "bn": bn_p}, {"bn": bn_s}


def _double_block_in(sd, prefix):
    c1_p, c1_s = _conv_bn_in(sd, f"{prefix}.0", f"{prefix}.1")
    c2_p, c2_s = _conv_bn_in(sd, f"{prefix}.3", f"{prefix}.4")
    return {"c1": c1_p, "c2": c2_p}, {"c1": c1_s, "c2": c2_s}


def _denoiser_in(sd):
    levels = _count(sd, "encoder.{}.0.weight")
    enc = [_double_block_in(sd, f"encoder.{i}") for i in range(levels)]
    dec = [_double_block_in(sd, f"decoder.{2 * i + 1}")
           for i in range(levels)]
    bott_p, bott_s = _double_block_in(sd, "bottleneck")
    params = {
        "encoder": [p for p, _ in enc], "bottleneck": bott_p,
        "up": [_conv_t_in(sd, f"decoder.{2 * i}") for i in range(levels)],
        "decoder": [p for p, _ in dec],
        "transient_detector": [_conv_in(sd, f"transient_detector.{j}")
                               for j in (0, 2, 4)],
        "final_conv": _conv_in(sd, "final_conv")}
    state = {"encoder": [s for _, s in enc], "bottleneck": bott_s,
             "decoder": [s for _, s in dec]}
    return params, state


def _super_resolution_in(sd):
    blocks_p, blocks_s = [], []
    for i in range(_count(sd, "residual_blocks.{}.conv1.weight")):
        bn1_p, bn1_s = _bn_in(sd, f"residual_blocks.{i}.bn1")
        bn2_p, bn2_s = _bn_in(sd, f"residual_blocks.{i}.bn2")
        blocks_p.append({"conv1": _conv_in(sd, f"residual_blocks.{i}.conv1"),
                         "conv2": _conv_in(sd, f"residual_blocks.{i}.conv2"),
                         "bn1": bn1_p, "bn2": bn2_p})
        blocks_s.append({"bn1": bn1_s, "bn2": bn2_s})
    mid_p, mid_s = _bn_in(sd, "middle.1")
    params = {
        "initial": _conv_in(sd, "initial.0"), "blocks": blocks_p,
        "middle": {"conv": _conv_in(sd, "middle.0"), "bn": mid_p},
        "upsample": [_conv_t_in(sd, f"upsample_blocks.{i}.0") for i in
                     range(_count(sd, "upsample_blocks.{}.0.weight"))],
        "hf": _conv_in(sd, "hf_emphasis.0"),
        "recon": _conv_in(sd, "reconstruction")}
    return params, {"blocks": blocks_s, "middle": {"bn": mid_s}}


def _stereo_separator_in(sd):
    params, state = {}, {}
    params["stem"], state["stem"] = _conv_bn_in(sd, "encoder.0.0",
                                                "encoder.0.1")
    blocks = []
    for i in range(1, _count(sd, "encoder.{}.0.weight")):
        d_p, d_s = _conv_bn_in(sd, f"encoder.{i}.0", f"encoder.{i}.1")
        p_p, p_s = _conv_bn_in(sd, f"encoder.{i}.3", f"encoder.{i}.4")
        blocks.append(({"dilated": d_p, "pointwise": p_p},
                       {"dilated": d_s, "pointwise": p_s}))
    params["blocks"] = [p for p, _ in blocks]
    state["blocks"] = [s for _, s in blocks]
    params["lstm"] = [
        {"w_ih": _np(sd[f"lstm.weight_ih_l{k}"]).T,
         "w_hh": _np(sd[f"lstm.weight_hh_l{k}"]).T,
         "b_ih": _np(sd[f"lstm.bias_ih_l{k}"]),
         "b_hh": _np(sd[f"lstm.bias_hh_l{k}"])}
        for k in range(_count(sd, "lstm.weight_ih_l{}"))]
    for side in ("left", "right"):
        prefix = f"{side}_decoder"
        layers = [_conv_bn_in(sd, f"{prefix}.{a}", f"{prefix}.{a + 1}")
                  for a in (0, 3, 6)]
        params[side] = {"l1": layers[0][0], "l2": layers[1][0],
                        "l3": layers[2][0],
                        "final": _conv_in(sd, f"{prefix}.9")}
        state[side] = {"l1": layers[0][1], "l2": layers[1][1],
                       "l3": layers[2][1]}
    return params, state


_TO_JAX = {"denoiser": _denoiser_in, "super_resolution": _super_resolution_in,
           "stereo_separator": _stereo_separator_in}


def jax_from_state_dict(model: str, sd: dict):
    """The port's (upstream) state dict of `model` -> the JAX package's
    `(params, state)` pytrees of numpy arrays, the layout its `.msgpack`
    checkpoints hold."""
    if model not in _TO_JAX:
        raise KeyError(f"unknown model {model!r}; expected {MODELS}")
    return _TO_JAX[model](sd)


def save_pth(path, model: str, sd: dict, epoch: int = 0):
    """Write the upstream `{"epoch", "model_state_dict"}` checkpoint of
    `model` from a state dict, through the JAX layout and back, so the file
    holds the upstream keys in their order with `num_batches_tracked` 0,
    as the JAX package's exporter writes them."""
    out = state_dict_from_jax(model, *jax_from_state_dict(model, sd))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save({"epoch": epoch, "model_state_dict": out}, str(path))
    return path


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
