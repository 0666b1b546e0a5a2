"""Plain PyTorch forward passes of the three upstream models, from their
state dicts (the upstream key names).

Written from the upstream architectures (JonathanBedrava/ml-audio-
restoration, `src/models/*.py`), independent of the port: torch.nn.
functional convolutions, batch norm unfolded (eval: running statistics;
train: the batch's, via F.batch_norm), and the LSTM as torch.nn.LSTM
(cuDNN on the card) in segments of at most 44,100 steps with (h, c)
carried, since cuDNN refuses longer sequences. Tensors are NCW.

Every function computes in the dtype of the tensors it is given: float32
weights and inputs give the float32 reference; bfloat16 ones (`cast`)
give the reference in bfloat16, whose departure from float32 is what
bf16 arithmetic itself costs on those weights and signals. Outside
float32 the LSTM is a plain loop over time: gates in the tensors' dtype,
each step's h @ W_hh on operands in that dtype with a float32 sum, the
state (h, c) in float32 (the recurrence of the port's bf16 contract).
`Ops` is the rounding of every product's operands (convolutions, the
LSTM's projections): `Ops()` none, `Ops("fp8")` to float8 e4m3 with a
per-tensor scale to the largest magnitude, the control of a bfloat16
configuration. TF32, the control of a float32 one, is torch's global
switch (`tf32()`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

SLOPE = 0.2
BN_EPS = 1e-5
LSTM_SEGMENT = 44100
DILATIONS = (1, 2, 4, 8)


class Ops:
    def __init__(self, operands: str | None = None):
        if operands not in (None, "fp8"):
            raise ValueError(f"operands: None or 'fp8', not {operands!r}")
        self.operands = operands

    def q(self, x):
        if self.operands is None:
            return x
        scale = x.abs().amax().float().clamp(min=1e-30) / 448.0
        return ((x.float() / scale).to(torch.float8_e4m3fn).float()
                * scale).to(x.dtype)

    def conv(self, x, w, b, padding=0, dilation=1):
        return F.conv1d(self.q(x), self.q(w), b, padding=padding,
                        dilation=dilation)

    def tconv(self, x, w, b, stride, padding=0):
        return F.conv_transpose1d(self.q(x), self.q(w), b, stride=stride,
                                  padding=padding)


F32 = Ops()


def cast(sd: dict, dtype) -> dict:
    """A state dict with its float tensors in `dtype`."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in sd.items()}


@contextlib.contextmanager
def tf32(on: bool = True):
    """Convolutions and matrix products in TF32 (on) or full float32."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def lrelu(x):
    return F.leaky_relu(x, SLOPE)


def bn(sd, key, x, train):
    """Eval (train False): the running statistics. Train: the batch's.
    train == "calibrate": the batch's, also written into sd's running
    statistics (momentum 1, the variance unbiased)."""
    if train == "calibrate":
        return F.batch_norm(x, sd[key + ".running_mean"],
                            sd[key + ".running_var"], sd[key + ".weight"],
                            sd[key + ".bias"], training=True, momentum=1.0,
                            eps=BN_EPS)
    return F.batch_norm(x, None if train else sd[key + ".running_mean"],
                        None if train else sd[key + ".running_var"],
                        sd[key + ".weight"], sd[key + ".bias"],
                        training=bool(train), eps=BN_EPS)


def conv_bn(ops, sd, conv, norm, x, train, padding, dilation=1, act=True):
    y = bn(sd, norm, ops.conv(x, sd[conv + ".weight"], sd[conv + ".bias"],
                              padding, dilation), train)
    return lrelu(y) if act else y


# ----------------------------------------------------------- the denoiser
def _double(ops, sd, p, x, train):
    x = conv_bn(ops, sd, p + ".0", p + ".1", x, train, 1)
    return conv_bn(ops, sd, p + ".3", p + ".4", x, train, 1)


def impulse_score(x):
    """|d1|, |d2| and amplitude blended 1:2:0.5 over 3.5, a 5-tap box
    filter with zero padding, clipped to [0, 1]."""
    d1 = F.pad((x[..., 1:] - x[..., :-1]).abs(), (0, 1))
    d2 = F.pad((d1[..., 1:] - d1[..., :-1]).abs(), (0, 1))
    s = (d2 * 2.0 + d1 + x.abs() * 0.5) / 3.5
    box = torch.full((1, 1, 5), 0.2, dtype=x.dtype, device=x.device)
    return F.conv1d(s, box, padding=2).clamp(0.0, 1.0)


def denoiser(sd, x, train=False, ops=F32, levels=3):
    """The U-Net: x [B, 1, T] -> [B, 1, T]."""
    skips, h = [], x
    for i in range(levels):
        h = _double(ops, sd, f"encoder.{i}", h, train)
        skips.append(h)
        h = F.max_pool1d(h, 2, 2)
    h = _double(ops, sd, "bottleneck", h, train)
    for i in range(levels):
        up = f"decoder.{2 * i}"
        h = ops.tconv(h, sd[up + ".weight"], sd[up + ".bias"], 2)
        skip = skips[-(i + 1)]
        h = F.pad(h, (0, skip.shape[-1] - h.shape[-1]))
        h = _double(ops, sd, f"decoder.{2 * i + 1}",
                    torch.cat([skip, h], dim=1), train)
    td = h
    for j in (0, 2, 4):
        k = f"transient_detector.{j}"
        td = ops.conv(td, sd[k + ".weight"], sd[k + ".bias"], 1)
        td = torch.sigmoid(td) if j == 4 else lrelu(td)
    mask = torch.maximum(td, impulse_score(x))
    out = ops.conv(h, sd["final_conv.weight"], sd["final_conv.bias"])
    return out * (1.0 - mask * 0.9)


# --------------------------------------------------- super-resolution x2
def upsample2(x):
    """Linear x2 with half-pixel centres, clamped at the signal's ends:
    out[2i] = x[i-1]/4 + 3x[i]/4, out[2i+1] = 3x[i]/4 + x[i+1]/4."""
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    even = 0.25 * left + 0.75 * x
    odd = 0.75 * x + 0.25 * right
    return torch.stack([even, odd], dim=-1).flatten(-2)


def super_resolution(sd, x, train=False, ops=F32, blocks=4):
    """x [B, 1, T] -> [B, 1, 2T]."""
    h0 = lrelu(ops.conv(x, sd["initial.0.weight"], sd["initial.0.bias"], 3))
    h = h0
    for i in range(blocks):
        p = f"residual_blocks.{i}"
        r = conv_bn(ops, sd, p + ".conv1", p + ".bn1", h, train, 1)
        h = conv_bn(ops, sd, p + ".conv2", p + ".bn2", r, train, 1,
                    act=False) + h
    h = h0 + conv_bn(ops, sd, "middle.0", "middle.1", h, train, 1, act=False)
    h = lrelu(ops.tconv(h, sd["upsample_blocks.0.0.weight"],
                        sd["upsample_blocks.0.0.bias"], 2, 1))
    h = lrelu(ops.conv(h, sd["hf_emphasis.0.weight"],
                       sd["hf_emphasis.0.bias"], 2))
    out = ops.conv(h, sd["reconstruction.weight"], sd["reconstruction.bias"],
                   3)
    return out + upsample2(x)


# ------------------------------------------------------ stereo separator
def stereo_encode(sd, x, train=False, ops=F32):
    """Stem and dilated blocks: [B, 1, T] -> [B, 4C, T]."""
    h = conv_bn(ops, sd, "encoder.0.0", "encoder.0.1", x, train, 3)
    for i, d in enumerate(DILATIONS, start=1):
        h = conv_bn(ops, sd, f"encoder.{i}.0", f"encoder.{i}.1", h, train, d,
                    d)
        h = conv_bn(ops, sd, f"encoder.{i}.3", f"encoder.{i}.4", h, train, 0)
    return h


def lstm_module(sd, device):
    """torch.nn.LSTM carrying the stereo separator's weights, in float32."""
    w_ih = sd["lstm.weight_ih_l0"]
    m = torch.nn.LSTM(w_ih.shape[1], w_ih.shape[0] // 4, batch_first=True)
    m = m.to(device)
    with torch.no_grad():
        for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                     "bias_hh_l0"):
            getattr(m, name).copy_(sd["lstm." + name].float())
    return m


def lstm_loop(sd, feats, ops):
    """The LSTM as a loop over time, for a dtype other than float32 or
    rounded operands: feats [B, 4C, T] -> [B, H, T] in feats' dtype."""
    dt = feats.dtype
    w_ih, w_hh = (ops.q(sd[f"lstm.weight_{k}_l0"].to(dt)) for k in ("ih",
                                                                  "hh"))
    bias = (sd["lstm.bias_ih_l0"] + sd["lstm.bias_hh_l0"]).to(dt)
    gates = ops.q(feats).transpose(1, 2) @ w_ih.T + bias  # [B, T, 4H]
    hid = w_hh.shape[1]
    w = w_hh.T.float()
    h = torch.zeros((feats.shape[0], hid), device=feats.device)
    c = torch.zeros_like(h)
    out = torch.empty((feats.shape[0], hid, feats.shape[2]), dtype=dt,
                      device=feats.device)
    for t in range(feats.shape[2]):
        a = gates[:, t].float() + ops.q(h.to(dt)).float() @ w
        i, f, g, o = a.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, :, t] = h.to(dt)
    return out


def lstm_run(lstm, feats, carry=None, ops=F32, params=None):
    """feats [B, 4C, T] -> ([B, H, T], (h, c)), in segments. `params`
    ({nn.LSTM name: tensor}) replaces the module's weights, so that a
    training reference differentiates through its own leaves."""
    x = ops.q(feats).transpose(1, 2)
    outs = []
    for s in range(0, x.shape[1], LSTM_SEGMENT):
        seg = x[:, s:s + LSTM_SEGMENT].float()
        y, carry = (lstm(seg, carry) if params is None else
                    torch.func.functional_call(lstm, params, (seg, carry)))
        outs.append(y.to(feats.dtype))
    return torch.cat(outs, dim=1).transpose(1, 2), carry


def stereo_decode(sd, h, train=False, ops=F32):
    """The L and R decoders: [B, H, T] -> [B, 2, T]."""
    outs = []
    for side in ("left_decoder", "right_decoder"):
        y = h
        for i in (0, 3, 6):
            y = conv_bn(ops, sd, f"{side}.{i}", f"{side}.{i + 1}", y, train, 3)
        outs.append(ops.conv(y, sd[f"{side}.9.weight"], sd[f"{side}.9.bias"],
                             3))
    return torch.cat(outs, dim=1)


def stereo(sd, x, train=False, ops=F32, lstm=None):
    """x [B, 1, T] -> [B, 2, T]. In train mode the LSTM runs on sd's own
    tensors (functional_call), so gradients reach them."""
    feats = stereo_encode(sd, x, train, ops)
    if feats.dtype != torch.float32 or ops.operands is not None:
        return stereo_decode(sd, lstm_loop(sd, feats, ops), train, ops)
    lstm = lstm or lstm_module(sd, x.device)
    params = ({k[len("lstm."):]: v for k, v in sd.items()
               if k.startswith("lstm.")} if train is True else None)
    h, _ = lstm_run(lstm, feats, ops=ops, params=params)
    return stereo_decode(sd, h, train, ops)
