"""BS-RoFormer: band-split RoPE transformer (Lu et al., "Music Source
Separation with Band-Split RoPE Transformer", arXiv:2309.02612), the
restore path's optional fourth stage (`enhancer`).

The module tree and forward are those of lucidrains/BS-RoFormer,
`bs_roformer/bs_roformer.py`, class `BSRoformer`, in eval (dropout off,
no linear transformer, no loss), so a published state dict loads under
`load_state_dict(strict=True)`: `layers.{i}.{0|1}.layers.{l}.{0|1}...`,
`band_split.to_features.{j}.{0|1}`, `mask_estimators.{n}.to_freqs.{j}.0.
{0|2}`, `final_norm.gamma`, and the rotary embeddings' `freqs` under every
attention that shares them. The forward:

1. the STFT of each channel (ops/stft.py: centred, reflect-padded,
   periodic Hann), stereo merged into the frequency axis as `(f s)`, real
   and imaginary parts last;
2. `BandSplit`: per band RMSNorm(dim_in) then Linear(dim_in, dim);
3. `depth` x (a transformer along time, one along bands): pre-norm
   attention and pre-norm feed-forward blocks with residuals (each
   block's module returns its input plus its output) and no output
   norm; attention with RoPE on q and k along the attended axis,
   softmax(q k^T / sqrt(d)) v, times sigmoid(to_gates(x)) per head,
   then to_out; feed-forward Linear, GELU, Linear;
4. `final_norm`, then per stem a `MaskEstimator`: per band Linear(dim,
   4 dim), Tanh, ..., Linear(4 dim, 2 dim_in), GLU;
5. the complex mask times the STFT, and the iSTFT to the input's length
   (the product's DC and Nyquist bins taken real, as irfft defines it).

RMSNorm is F.normalize(x, dim=-1) * sqrt(d) * gamma. The per-band layers
run grouped (ops/bands.py), attention on ops/attention.py. The
transformers' linears go through ops/gemm.py::linear: on a CUDA float32
forward with no gradient wanted, one hand-written TF32x3 GEMM a layer
(`to_qkv` with `to_gates` as one product, `to_out` with the attention
block's residual, the feed-forward's first Linear with its GELU and its
second with the block's residual), 4 launches a transformer; elsewhere
ATen's ops, as the modules computed them. Under a bf16 cast the STFT, the
mask product and the iSTFT stay in float32.

Spans (utils.profiling.annotate, all timing the device): `enhance.spec`
(STFT; mask product and iSTFT), `enhance.bands` (band split; final norm
and mask estimators), `enhance.time` and `enhance.band` (each transformer
with the layout change in front of it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bands as B
from ..ops.attention import attention, rope, rope_table
from ..ops.gemm import linear
from ..ops.stft import hann_window, overlap_add_frames, stft
from ..utils.profiling import annotate

# lucidrains's default band layout (the paper's ~60 bands over 1,025 bins)
DEFAULT_FREQS_PER_BANDS = (
    (2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8 + (48,) * 8 + (128, 129))


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return B.rms_norm(x, self.gamma)


class RotaryEmbedding(nn.Module):
    """`rotary_embedding_torch.RotaryEmbedding(dim)`'s state: `freqs`,
    theta ** (-2j / dim) for theta 10,000, a parameter that is not
    learned (it is in the state dict)."""

    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        freqs = 1.0 / theta ** (torch.arange(0, dim, 2)[:dim // 2].float()
                                / dim)
        self.freqs = nn.Parameter(freqs, requires_grad=False)

    def table(self, n: int):
        """The rotations of positions 0..n-1: complex [n, dim/2]."""
        return rope_table(self.freqs, n)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 rotary_embed: RotaryEmbedding):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.rotary_embed = rotary_embed
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_gates = nn.Linear(dim, heads)
        self.to_out = nn.Sequential(
            nn.Linear(heads * dim_head, dim, bias=False), nn.Dropout(0.0))

    def forward(self, x):
        """The pre-norm attention block with its residual: x [B, n, dim],
        n along the attended axis -> x + attention(x) [B, n, dim] (the add
        in to_out's product)."""
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        qkv, gates = linear(self.norm(x), self.to_qkv, self.to_gates)
        qkv = qkv.view(b, n, 3, h, d)
        table = self.rotary_embed.table(n)[:, None, None]  # [n, 1, 1, d/2]
        q, k = rope(qkv[:, :, :2], table).unbind(2)  # each [B, n, h, d]
        out = attention(q.transpose(1, 2), k.transpose(1, 2),
                        qkv[:, :, 2].transpose(1, 2))  # [B, h, n, d]
        out = out.transpose(1, 2) * torch.sigmoid(gates)[..., None]
        return linear(out.reshape(b, n, h * d), self.to_out[0], residual=x)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(
            RMSNorm(dim), nn.Linear(dim, dim * mult), nn.GELU(),
            nn.Dropout(0.0), nn.Linear(dim * mult, dim), nn.Dropout(0.0))

    def forward(self, x):
        """The pre-norm feed-forward block with its residual: x + (RMSNorm,
        Linear, GELU, Linear)(x), the add in the last product; the
        dropouts are identities."""
        hidden = linear(self.net[0](x), self.net[1], gelu=True)
        return linear(hidden, self.net[4], residual=x)


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, dim_head: int, heads: int,
                 rotary_embed: RotaryEmbedding):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([Attention(dim, heads, dim_head, rotary_embed),
                           FeedForward(dim)])
            for _ in range(depth)])

    def forward(self, x):
        for attn, ff in self.layers:
            x = ff(attn(x))
        return x


class BandSplit(nn.Module):
    def __init__(self, dim: int, dim_inputs):
        super().__init__()
        self.runs = B.runs(dim_inputs)
        self.to_features = nn.ModuleList([
            nn.Sequential(RMSNorm(w), nn.Linear(w, dim)) for w in dim_inputs])

    def forward(self, x):
        """x [M, sum(dim_inputs)], the bands one after another -> [M,
        bands, dim]: one batched product a run of bands."""
        outs, offset = [], 0
        for j, k, w in self.runs:
            nets = self.to_features[j:j + k]
            part = x[:, offset:offset + k * w].unflatten(1, (k, w))
            part = B.rms_norm(part, B.stack([n[0] for n in nets], "gamma"))
            linears = [n[1] for n in nets]
            y = B.band_linear(part.transpose(0, 1),
                              B.stack(linears, "weight"),
                              B.stack(linears, "bias"))
            outs.append(y.transpose(0, 1))
            offset += k * w
        return torch.cat(outs, dim=1)


def mlp(dim_in: int, dim_out: int, dim_hidden: int, depth: int):
    """Linear, Tanh, ..., Linear: `depth` linears (lucidrains's MLP)."""
    dims = (dim_in, *(dim_hidden,) * (depth - 1), dim_out)
    layers = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        layers.append(nn.Linear(a, b))
        if i < depth - 1:
            layers.append(nn.Tanh())
    return nn.Sequential(*layers)


class MaskEstimator(nn.Module):
    def __init__(self, dim: int, dim_inputs, depth: int):
        super().__init__()
        self.runs = B.runs(dim_inputs)
        self.to_freqs = nn.ModuleList([
            nn.Sequential(mlp(dim, 2 * w, 4 * dim, depth), nn.GLU(dim=-1))
            for w in dim_inputs])

    def forward(self, x):
        """x [M, bands, dim] -> [M, sum(dim_inputs)]: every band's hidden
        layers in one batched product each (they share a shape), the last
        layer one a run of bands."""
        linears = [[m for m in f[0] if isinstance(m, nn.Linear)]
                   for f in self.to_freqs]
        h = x.transpose(0, 1)  # band-major
        for i in range(len(linears[0]) - 1):
            layer = [ls[i] for ls in linears]
            h = torch.tanh_(B.band_linear(h, B.stack(layer, "weight"),
                                          B.stack(layer, "bias")))
        outs = []
        for j, k, w in self.runs:
            layer = [ls[-1] for ls in linears[j:j + k]]
            y = F.glu(B.band_linear(h[j:j + k], B.stack(layer, "weight"),
                                    B.stack(layer, "bias")), dim=-1)
            outs.append(y.transpose(0, 1).reshape(y.shape[1], k * w))
        return torch.cat(outs, dim=1)


class BSRoformer(nn.Module):
    """BS-RoFormer in eval: audio [B, S, T] -> the masked and resynthesised
    audio, [B, S, T] for one stem, else [B, stems, S, T]."""

    def __init__(self, dim: int, *, depth: int, stereo: bool = False,
                 num_stems: int = 1, time_transformer_depth: int = 2,
                 freq_transformer_depth: int = 2,
                 freqs_per_bands=DEFAULT_FREQS_PER_BANDS, dim_head: int = 64,
                 heads: int = 8, mask_estimator_depth: int = 2,
                 stft_n_fft: int = 2048,
                 stft_hop_length: int = 512, stft_win_length: int = 2048,
                 stft_normalized: bool = False):
        super().__init__()
        bins = stft_n_fft // 2 + 1
        if sum(freqs_per_bands) != bins or len(freqs_per_bands) < 2:
            raise ValueError(
                f"freqs_per_bands must be 2 or more bands summing to the "
                f"STFT's {bins} bins, got {sum(freqs_per_bands)} in "
                f"{len(freqs_per_bands)}")
        if stft_win_length > stft_n_fft:
            raise ValueError("stft_win_length must be at most stft_n_fft")
        self.stereo = stereo
        self.audio_channels = 2 if stereo else 1
        self.num_stems = num_stems
        self.freqs_per_bands = tuple(freqs_per_bands)
        self.n_fft, self.hop = stft_n_fft, stft_hop_length
        self.win_length, self.normalized = stft_win_length, stft_normalized
        time_rotary = RotaryEmbedding(dim_head)
        freq_rotary = RotaryEmbedding(dim_head)
        self.layers = nn.ModuleList([
            nn.ModuleList([
                Transformer(dim, time_transformer_depth, dim_head, heads,
                            time_rotary),
                Transformer(dim, freq_transformer_depth, dim_head, heads,
                            freq_rotary)])
            for _ in range(depth)])
        self.final_norm = RMSNorm(dim)
        dim_inputs = tuple(2 * f * self.audio_channels
                           for f in freqs_per_bands)
        self.band_split = BandSplit(dim, dim_inputs)
        self.mask_estimators = nn.ModuleList([
            MaskEstimator(dim, dim_inputs, mask_estimator_depth)
            for _ in range(num_stems)])

    def num_tokens(self, batch: int, length: int) -> int:
        """Tokens of a forward on [batch, S, length]: rows x STFT frames x
        bands, what each transformer attends over."""
        return batch * (1 + length // self.hop) * len(self.freqs_per_bands)

    def _window(self, device):
        """torch.stft's window: the periodic Hann of win_length, centred
        in n_fft with zeros."""
        w = hann_window(self.win_length, device=device)
        left = (self.n_fft - self.win_length) // 2
        return F.pad(w, (left, self.n_fft - self.win_length - left))

    def forward(self, audio):
        if audio.dim() == 2:
            audio = audio[:, None]
        b, s, t = audio.shape
        if s != self.audio_channels:
            raise ValueError(f"BSRoformer(stereo={self.stereo}) takes "
                             f"{self.audio_channels} channel(s), got {s}")
        dtype = self.final_norm.gamma.dtype
        nb = len(self.freqs_per_bands)
        with annotate("enhance.spec", device_ms=True):
            window = self._window(audio.device)
            spec = stft(audio.reshape(b * s, t).float(), self.n_fft,
                        self.hop, window=window)  # [b*s, frames, bins]
            frames, bins = spec.shape[1:]
            # [b, frames, bins, s] complex; features [b*frames, (f s c)]
            spec = spec.view(b, s, frames, bins).permute(0, 2, 3, 1)
            feats = torch.view_as_real(spec).reshape(b * frames, -1)
            if self.normalized:
                feats = feats * self.n_fft ** -0.5
        with annotate("enhance.bands", device_ms=True):
            x = self.band_split(feats.to(dtype))  # [b*frames, nb, dim]
        dim = x.shape[-1]
        for time_tf, band_tf in self.layers:
            with annotate("enhance.time", device_ms=True):
                x = x.view(b, frames, nb, dim).transpose(1, 2)
                x = time_tf(x.reshape(b * nb, frames, dim))
            with annotate("enhance.band", device_ms=True):
                x = x.view(b, nb, frames, dim).transpose(1, 2)
                x = band_tf(x.reshape(b * frames, nb, dim))
        with annotate("enhance.bands", device_ms=True):
            x = self.final_norm(x)
            masks = [est(x) for est in self.mask_estimators]
        with annotate("enhance.spec", device_ms=True):
            outs = []
            for mask in masks:
                mask = torch.view_as_complex(
                    mask.float().view(b, frames, bins, s, 2))
                y = spec * mask
                # a real signal's DC and Nyquist bins are real: irfft
                # drops their imaginary parts by definition, and cuFFT's
                # inverse, which leaves them undefined, gets them zeroed
                y[:, :, 0].imag.zero_()
                if self.n_fft % 2 == 0:
                    y[:, :, -1].imag.zero_()
                y = y.permute(0, 3, 1, 2).reshape(b * s, frames, bins)
                # torch.istft's crop: t samples from the centre of the
                # first frame, into the last frame's centre padding where
                # the hop leaves the centres short of t (ops.stft.istft
                # crops that padding first, as the JAX package does)
                y = overlap_add_frames(y, self.n_fft, self.hop,
                                       window=window)
                y = y[:, self.n_fft // 2:self.n_fft // 2 + t]
                outs.append(F.pad(y, (0, t - y.shape[1])).view(b, s, t))
        return outs[0] if self.num_stems == 1 else torch.stack(outs, dim=1)


# `model:` keys of a ZFTurbo / lucidrains YAML that set no weight and no
# eval arithmetic (dropout, the attention implementation, training
# losses), and keys that change the forward, with the only value this
# module computes
_YAML_IGNORED = frozenset({
    "attn_dropout", "ff_dropout", "flash_attn", "dim_freqs_in",
    "multi_stft_resolution_loss_weight", "multi_stft_resolutions_window_sizes",
    "multi_stft_hop_size", "multi_stft_normalized", "use_torch_checkpoint",
    "sage_attention"})
_YAML_FIXED = {"linear_transformer_depth": 0, "skip_connection": False,
               "mlp_expansion_factor": 4}


def widths_from_yaml(path) -> dict:
    """BSRoformer's keyword arguments from the `model:` group of a YAML
    (ZFTurbo/Music-Source-Separation-Training's configs, whose tuples are
    tagged `!!python/tuple`). Raises ValueError on a key that would change
    the forward."""
    import yaml

    class Loader(yaml.SafeLoader):
        pass

    Loader.add_constructor(
        "tag:yaml.org,2002:python/tuple",
        lambda loader, node: tuple(loader.construct_sequence(node)))
    with open(path) as f:
        model = yaml.load(f, Loader=Loader)["model"]
    kw = {k: v for k, v in model.items() if k not in _YAML_IGNORED}
    for key, value in _YAML_FIXED.items():
        if kw.pop(key, value) != value:
            raise ValueError(f"{path}: {key}={model[key]!r} is not "
                             f"computed here (only {value!r})")
    kw["freqs_per_bands"] = tuple(kw["freqs_per_bands"])
    return kw


def load_enhancer(path, device="cpu") -> BSRoformer:
    """BS-RoFormer from a `.pth` / `.ckpt` state dict under lucidrains's
    keys (bare, or under `model_state_dict`) and the widths of the YAML
    beside it (the checkpoint's name with `.yaml`), loaded strictly, in
    eval mode on `device`."""
    from pathlib import Path

    from ..compat import load_pth

    path = Path(path)
    config = path.with_suffix(".yaml")
    if not config.exists():
        raise FileNotFoundError(
            f"enhancer widths not found: {str(config)!r} (the YAML of the "
            f"checkpoint's model group goes beside it, with its name)")
    model = BSRoformer(**widths_from_yaml(config))
    model.load_state_dict(load_pth(path), strict=True)
    return model.to(device).eval()
