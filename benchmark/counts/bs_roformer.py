"""Model FLOPs and the attention kernels' bound of BS-RoFormer from its
widths (a configuration's `bs_roformer` group), for one item of t samples
at the stage's rate (batch 1): `frames` = 1 + t // hop STFT frames, each a
token in every one of the `bands` (len(freqs_per_bands)).

FLOPs are 2 per multiply-add of every matrix product: the band split, the
24 transformers' projections, feed-forwards and attention (q k^T and the
weighted sum of v), and the mask estimators; norms, RoPE, gates,
activations and the FFTs are not counted (as `models.py`).

The attention bound counts each sequence of n tokens and each head once:
4 n^2 d FLOPs, and q, k, v read and the output written once in float32
(16 n d bytes), against the HBM bandwidth and `ATTN_FLOPS`, the highest
rate the card has for products held to float32: the fused kernel
(`fmha_cutlassF_f32_..._sm80`) computes on the tensor cores, three TF32
products a float32 multiply-add, so its ceiling is the TF32 peak over 3
(494.5 / 3 = 164.8 TFLOP/s), above the 67 TFLOP/s of float32 outside
the tensor cores.
"""
from __future__ import annotations

from .kernels import PEAKS

# the data sheet's dense TF32 tensor-core rate (989 TFLOP/s with sparsity)
TF32_FLOPS = 494.5e12
ATTN_FLOPS = TF32_FLOPS / 3


def shape(group: dict, t: int) -> dict:
    return {"frames": 1 + t // group["stft_hop_length"],
            "bands": len(group["freqs_per_bands"]),
            "channels": 2 if group["stereo"] else 1}


def enhancer(group: dict, t: int) -> float:
    """Model FLOPs of one forward on t samples."""
    s = shape(group, t)
    frames, bands = s["frames"], s["bands"]
    dim, inner = group["dim"], group["heads"] * group["dim_head"]
    widths = [2 * f * s["channels"] for f in group["freqs_per_bands"]]
    hidden = 4 * dim  # the mask estimators' MLP
    tokens = frames * bands
    per_token = (dim * 3 * inner + dim * group["heads"] + inner * dim
                 + 2 * dim * 4 * dim)
    tf = group["time_transformer_depth"] + group["freq_transformer_depth"]
    f = 2.0 * tokens * per_token * tf * group["depth"]
    f += attention(group, t)["flops"]
    f += 2.0 * frames * dim * sum(widths)  # band split
    mask_layers = group["mask_estimator_depth"]
    per_band = (dim * hidden + hidden * hidden * (mask_layers - 2)
                if mask_layers > 1 else 0)
    f += 2.0 * frames * group["num_stems"] * (
        bands * per_band + sum(hidden * 2 * w if mask_layers > 1
                               else dim * 2 * w for w in widths))
    return f


def attention(group: dict, t: int) -> dict:
    """The attention of one forward on t samples: FLOPs, bytes and the
    least time (ms) at ATTN_FLOPS and the HBM bandwidth, the larger of
    the two for each call, summed."""
    s = shape(group, t)
    d, h = group["dim_head"], group["heads"]
    total = {"flops": 0.0, "bytes": 0.0, "bound_ms": 0.0}
    for seqs, n, depth in ((s["bands"], s["frames"],
                            group["time_transformer_depth"]),
                           (s["frames"], s["bands"],
                            group["freq_transformer_depth"])):
        calls = depth * group["depth"]
        flops = 4.0 * n * n * d * h * seqs
        n_bytes = 16.0 * n * d * h * seqs
        total["flops"] += calls * flops
        total["bytes"] += calls * n_bytes
        total["bound_ms"] += calls * max(
            n_bytes / PEAKS["hbm_bytes_per_s"], flops / ATTN_FLOPS) * 1e3
    return total
