"""Plain BS-RoFormer, the reference of the `bs_roformer` configurations:
its forward from a state dict under lucidrains's key names
(lucidrains/BS-RoFormer, `bs_roformer/bs_roformer.py`, `BSRoformer` in
eval), and the restore of a recording through the three upstream stages
and it. Imports nothing of the program.

Band by band loops for the band split and the mask estimators, the
attention scores written out and softmaxed in blocks of `block`
sequences (so that a 270 s side fits), RoPE by `rotate_half` on
interleaved pairs (rotary_embedding_torch) at freqs made here from
dim_head, and torch.stft / torch.istft.
`widths` is the configuration's `bs_roformer` group. Computed in the
precision the caller leaves torch in: float32 with TF32 off, or TF32
under `models.tf32()` for the control.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import models as M
from . import restore as R

SEQ_BLOCK = 64  # sequences a block of the written-out attention scores
CHUNK_BLOCK = 4  # 8 s chunks through the stages at a time
THETA = 10000.0  # rotary_embedding_torch's default theta


def rms_norm(x, gamma):
    return F.normalize(x, dim=-1) * x.shape[-1] ** 0.5 * gamma


def linear(sd, key, x, bias=True):
    y = x @ sd[key + ".weight"].T
    return y + sd[key + ".bias"] if bias else y


def rotate_half(x):
    x1, x2 = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def rope_freqs(dim_head: int, theta: float = THETA):
    """rotary_embedding_torch's `freqs` for RotaryEmbedding(dim_head):
    theta ** (-2j / dim_head), j = 0 .. dim_head/2 - 1. The reference
    makes its own and reads no `rotary_embed.freqs` of the state dict."""
    return 1.0 / theta ** (torch.arange(0, dim_head, 2).float() / dim_head)


def rotary(x, freqs):
    """x [..., n, d] rotated at positions 0..n-1."""
    pos = torch.arange(x.shape[-2], dtype=freqs.dtype, device=x.device)
    angles = torch.repeat_interleave(pos[:, None] * freqs[None, :], 2, -1)
    return x * angles.cos() + rotate_half(x) * angles.sin()


def attention(sd, p, x, heads, freqs, block=None):
    x = rms_norm(x, sd[p + "norm.gamma"])
    q, k, v = (t.unflatten(-1, (heads, -1)).transpose(1, 2) for t in
               linear(sd, p + "to_qkv", x, bias=False).chunk(3, dim=-1))
    q, k = rotary(q, freqs), rotary(k, freqs)
    block = block or q.shape[0]
    out = []
    for i in range(0, q.shape[0], block):  # blocks of sequences
        scores = (q[i:i + block] @ k[i:i + block].transpose(-1, -2)
                  * q.shape[-1] ** -0.5)
        out.append(torch.softmax(scores, dim=-1) @ v[i:i + block])
    out = torch.cat(out)  # [B, h, n, d]
    gates = torch.sigmoid(linear(sd, p + "to_gates", x))  # [B, n, h]
    out = out * gates.transpose(1, 2)[..., None]
    return linear(sd, p + "to_out.0", out.transpose(1, 2).flatten(2),
                  bias=False)


def feed_forward(sd, p, x):
    h = rms_norm(x, sd[p + "net.0.gamma"])
    return linear(sd, p + "net.4", F.gelu(linear(sd, p + "net.1", h)))


def transformer(sd, p, x, heads, freqs, block=None):
    i = 0
    while f"{p}layers.{i}.0.to_qkv.weight" in sd:
        x = attention(sd, f"{p}layers.{i}.0.", x, heads, freqs,
                      block) + x
        x = feed_forward(sd, f"{p}layers.{i}.1.", x) + x
        i += 1
    return x


def forward(sd, audio, widths, block=None):
    """audio [B, S, T] -> [B, S, T] (one stem) or [B, stems, S, T]."""
    w = widths
    n_fft, hop = w["stft_n_fft"], w["stft_hop_length"]
    win = w["stft_win_length"]
    heads = w["heads"]
    freqs = rope_freqs(w["dim_head"]).to(audio.device)
    b, s, t = audio.shape
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win,
              window=torch.hann_window(win, device=audio.device),
              normalized=w["stft_normalized"])
    spec = torch.stft(audio.reshape(b * s, t), **kw, center=True,
                      pad_mode="reflect", return_complex=True)
    bins, frames = spec.shape[1:]
    # 'b s f t c -> b (f s) t c', then 'b f t c -> b t (f c)'
    spec = spec.view(b, s, bins, frames).transpose(1, 2).reshape(
        b, bins * s, frames)
    x = torch.view_as_real(spec).transpose(1, 2).reshape(b, frames, -1)
    dims = [2 * f * s for f in w["freqs_per_bands"]]
    feats = []
    for j, part in enumerate(x.split(dims, dim=-1)):
        p = f"band_split.to_features.{j}."
        feats.append(linear(sd, p + "1",
                            rms_norm(part, sd[p + "0.gamma"])))
    x = torch.stack(feats, dim=-2)  # [b, frames, bands, dim]
    nb, dim = x.shape[-2:]
    i = 0
    while f"layers.{i}.0.layers.0.0.to_qkv.weight" in sd:
        x = x.transpose(1, 2).reshape(b * nb, frames, dim)
        x = transformer(sd, f"layers.{i}.0.", x, heads, freqs, block)
        x = x.view(b, nb, frames, dim).transpose(1, 2).reshape(
            b * frames, nb, dim)
        x = transformer(sd, f"layers.{i}.1.", x, heads, freqs, block)
        x = x.view(b, frames, nb, dim)
        i += 1
    x = rms_norm(x, sd["final_norm.gamma"])
    outs = []
    n = 0
    while f"mask_estimators.{n}.to_freqs.0.0.0.weight" in sd:
        parts = []
        for j in range(nb):
            p = f"mask_estimators.{n}.to_freqs.{j}.0."
            h, layer = x[:, :, j], 0
            while f"{p}{layer + 2}.weight" in sd:
                h = torch.tanh(linear(sd, f"{p}{layer}", h))
                layer += 2
            parts.append(F.glu(linear(sd, f"{p}{layer}", h), dim=-1))
        mask = torch.cat(parts, dim=-1)  # [b, frames, (f s c)]
        mask = torch.view_as_complex(
            mask.view(b, frames, bins * s, 2).transpose(1, 2)
            .contiguous())
        y = (spec * mask).view(b, bins, s, frames)
        # DC and Nyquist are real: irfft drops their imaginary parts
        # (cuFFT would leave them undefined)
        y[:, 0].imag.zero_()
        if n_fft % 2 == 0:
            y[:, -1].imag.zero_()
        y = y.transpose(1, 2)
        y = torch.istft(y.reshape(b * s, bins, frames), **kw,
                        center=True, length=t)
        outs.append(y.view(b, s, t))
        n += 1
    return outs[0] if n == 1 else torch.stack(outs, dim=1)


def reflect_end(x, n: int):
    """x [..., T] and n more samples: x mirrored about its last sample,
    again and again (x0..x[T-1], x[T-2]..x1, x0, ...)."""
    if n <= 0:
        return x
    period = torch.cat([x, x.flip(-1)[..., 1:-1]], dim=-1)
    reps = -(-(x.shape[-1] + n) // period.shape[-1])
    return torch.cat([period] * reps, dim=-1)[..., :x.shape[-1] + n]


@torch.no_grad()
def restore(cfg, sds, audio, block: int = CHUNK_BLOCK):
    """audio [T] on the device -> [2, T*f]: the recording framed into
    chunks (its tail past the last chunk the recording reflected), the
    three stages and BS-RoFormer on each, the chunks crossfaded."""
    p = cfg["pipeline"]
    rate = p["sample_rate"]
    f = cfg["super_resolution"]["upscale_factor"]
    chunk, hop, overlap = R.framing(p["chunk_seconds"], p["overlap_seconds"],
                                    rate)
    t = audio.shape[-1]
    n = R.count(t, chunk, hop)
    xp = reflect_end(audio, (n - 1) * hop + chunk - t)
    lstm = M.lstm_module(sds["stereo_separator"], audio.device)
    fade = R.Crossfade((2,), xp.shape[-1] * f, chunk * f, overlap * f,
                       audio.device)
    for b0 in range(0, n, block):
        idx = range(b0, min(n, b0 + block))
        x = torch.stack([xp[i * hop:i * hop + chunk] for i in idx])[:, None]
        y = R.chain(cfg, sds, x, rate, lstm=lstm).float()
        y = forward(sds["bs_roformer"], y, cfg["bs_roformer"], SEQ_BLOCK)
        for j, i in enumerate(idx):
            fade.add(i * hop * f, y[j])
    return fade.result(t * f)
