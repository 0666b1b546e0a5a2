"""Plain BS-RoFormer forward from a state dict under lucidrains's key names
(lucidrains/BS-RoFormer, `bs_roformer/bs_roformer.py`, `BSRoformer` in
eval), for the tests' comparisons: plain torch only, nothing of the port
or of JAX, float32 with TF32 off.

Band by band loops for the band split and the mask estimators, the
attention scores written out and softmaxed, RoPE by `rotate_half` on
interleaved pairs (rotary_embedding_torch) at freqs made here from
dim_head, and torch.stft / torch.istft.
`widths` is the configuration: dim_head, heads, freqs_per_bands, stereo,
stft_n_fft, stft_hop_length, stft_win_length, stft_normalized.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

THETA = 10000.0  # rotary_embedding_torch's default theta


@contextlib.contextmanager
def full_f32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


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
    with full_f32():
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
