"""The float32 linear layers of BS-RoFormer's transformers on three TF32
products (csrc/tf32x3_gemm.cu).

`linear(x, *layers, gelu=, residual=)` is the route the model's attention
and feed-forward blocks take. Where x is a CUDA float32 tensor, every
layer's tensors are float32 and no gradient is wanted (grad mode off, or
nothing requiring grad), and not inside `aten_linear()`, it is one launch
of the hand-written GEMM: the layers' weights side by side as one product
(`to_qkv` and `to_gates` share their input), their biases, then GELU or a
residual add in the kernel's epilogue. Elsewhere (a CPU tensor, a bf16
cast, under grad, inside `aten_linear()`) it is each layer's own forward
(ATen's `F.linear`), then `F.gelu` or the add, as the modules computed
them before: the CPU forward is bit for bit what it was. The route never
falls back: a CUDA tensor it sends to the kernel that the kernel does not
take raises.

The kernel holds each product to float32 accuracy as x_hi w_hi + x_hi w_lo
+ x_lo w_hi, each part TF32 (`tf32_split`); `gemm_plain` is the same
arithmetic in plain PyTorch (three float32 products, whose terms are
exact), the kernel's reference. The weights' parts are made once a weight
and kept on the first layer (`split_weights`), keyed by each source
tensor's storage and version counter: `load_state_dict`, a copy into the
weight or a new tensor in its place makes them again at the next call.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import _build

LIBRARY = "tf32x3_gemm"

# Launches of csrc/tf32x3_gemm.cu since the last reset: the launch site
# adds one, and nothing else touches it but reset_gemm_launch_count.
gemm_launch_count = 0
_force_aten = False


def reset_gemm_launch_count() -> None:
    global gemm_launch_count
    gemm_launch_count = 0


@contextlib.contextmanager
def aten_linear():
    """Test hook: inside this block the routed linears on a CUDA tensor run
    ATen's ops as before (`F.linear` a layer, `F.gelu`, the add), so a
    check can hold the kernel's route against ATen's on the same card."""
    global _force_aten
    prev, _force_aten = _force_aten, True
    try:
        yield
    finally:
        _force_aten = prev


def tf32_round(x):
    """x (float32) rounded to TF32's 10 fraction bits, to nearest with ties
    away from zero (`cvt.rna.tf32.f32`), as float32 with the low 13 bits
    zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """(hi, lo): hi = x rounded to TF32, lo = the exact remainder x - hi
    rounded to TF32 again; hi + lo is x within ~2^-22 of |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def gemm_plain(x, w_hi, w_lo, bias=None, residual=None, *,
               gelu: bool = False):
    """The kernel's arithmetic in plain PyTorch: act(x_lo w_hi^T + x_hi
    w_lo^T + x_hi w_hi^T + bias) (+ residual), x [M, K] float32, w's
    parts [N, K]. Each TF32 x TF32 term is exact in float32; the sums
    round."""
    x_hi, x_lo = tf32_split(x)
    y = x_lo @ w_hi.T + x_hi @ w_lo.T
    y = y + x_hi @ w_hi.T
    if bias is not None:
        y = y + bias
    if gelu:
        y = F.gelu(y)
    return y if residual is None else y + residual


def _aligned(t):
    """t contiguous and starting on 16 bytes (a copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x, w_hi, w_lo, bias, residual):
    """Raise on what csrc/tf32x3_gemm.cu does not take."""
    tensors = [x, w_hi, w_lo] + [t for t in (bias, residual)
                                 if t is not None]
    if any(t.dtype != torch.float32 or t.device != x.device
           for t in tensors):
        raise TypeError("the TF32x3 GEMM takes float32 tensors on one "
                        "device, got " + ", ".join(
                            f"{t.dtype} on {t.device}" for t in tensors))
    m, k = x.shape
    n = w_hi.shape[0]
    if (k % 4 or n % 4 or tuple(w_hi.shape) != (n, k)
            or w_lo.shape != w_hi.shape):
        raise ValueError(f"the TF32x3 GEMM takes x [M, K] and weights [N, K] "
                         f"with K and N multiples of 4, got {tuple(x.shape)}, "
                         f"{tuple(w_hi.shape)}, {tuple(w_lo.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"the residual must be [{m}, {n}], got "
                         f"{tuple(residual.shape)}")


def gemm(x, w_hi, w_lo, bias=None, residual=None, *, gelu: bool = False):
    """act(x w^T + bias) (+ residual) -> [M, N] float32, w = w_hi + w_lo.
    One launch of csrc/tf32x3_gemm.cu for a CUDA tensor, the plain
    version for a CPU tensor. No fallback: a CUDA tensor the kernel does
    not take raises."""
    global gemm_launch_count
    if x.device.type == "cpu":
        return gemm_plain(x, w_hi, w_lo, bias, residual, gelu=gelu)
    if x.device.type != "cuda":
        raise ValueError(f"no TF32x3 GEMM for device {x.device}")
    _check(x, w_hi, w_lo, bias, residual)
    from .lstm import _launch

    x, w_hi, w_lo = _aligned(x), _aligned(w_hi), _aligned(w_lo)
    bias = None if bias is None else _aligned(bias)
    residual = None if residual is None else _aligned(residual)
    m, k = x.shape
    n = w_hi.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _launch(LIBRARY, _build.load(LIBRARY).tf32x3_gemm, 6, 4,
            [x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
             0 if bias is None else bias.data_ptr(),
             0 if residual is None else residual.data_ptr(), out.data_ptr(),
             m, n, k, int(gelu)], x.device)
    gemm_launch_count += 1
    return out


def _sources(layers):
    """Every weight and bias of the layers, in order."""
    return [t for layer in layers for t in (layer.weight, layer.bias)
            if t is not None]


class _Split:
    """The parts kept on a layer (split_weights): the key, the sources it
    was made from, and (w_hi, w_lo, bias). A copy or a pickle of the layer
    does not carry it: the copy's weights are other tensors."""
    __slots__ = ("key", "sources", "parts")

    def __init__(self, key, sources, parts):
        self.key, self.sources, self.parts = key, sources, parts

    def __deepcopy__(self, memo):
        return None

    def __reduce__(self):
        return type(None), ()


def split_weights(layers):
    """(w_hi, w_lo, bias) of the layers' weights stacked along N ([sum N,
    K] each, TF32 parts) and their biases (zeros for a layer without;
    None where no layer has one). Several layers' N is padded with zero
    rows to a multiple of 4, so each output's rows start on 16 bytes (the
    fused attention kernel reads v as a view of them). Made once and kept
    on the first layer under the storages and version counters of its
    sources, which the entry holds, so a storage cannot be freed and
    reused under the same key; any change to a source makes the parts
    again."""
    sources = _sources(layers)
    key = tuple((t.data_ptr(), t._version, t.device, t.shape)
                for t in sources)
    cached = getattr(layers[0], "_tf32x3_split", None)
    if cached is not None and cached.key == key:
        return cached.parts
    with torch.no_grad():
        w = torch.cat([layer.weight for layer in layers]).float()
        bias = None
        if any(layer.bias is not None for layer in layers):
            bias = torch.cat([
                layer.bias if layer.bias is not None else
                layer.weight.new_zeros(layer.out_features)
                for layer in layers]).float()
        pad = -w.shape[0] % 4 if len(layers) > 1 else 0
        if pad:
            w = F.pad(w, (0, 0, 0, pad))
            bias = None if bias is None else F.pad(bias, (0, pad))
        parts = (*tf32_split(w), None if bias is None else bias.contiguous())
    object.__setattr__(layers[0], "_tf32x3_split",
                       _Split(key, [t.detach() for t in sources], parts))
    return parts


def _grad_wanted(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _takes_kernel(x, layers, residual) -> bool:
    """The kernel's route: a CUDA float32 input, float32 layers (and
    residual), no gradient wanted, and not inside aten_linear()."""
    tensors = [x, residual, *_sources(layers)]
    return (x.device.type == "cuda" and not _force_aten
            and all(t is None or t.dtype == torch.float32 for t in tensors)
            and not _grad_wanted(tensors))


def linear(x, *layers, gelu: bool = False, residual=None):
    """Each nn.Linear of `layers` on x [..., K]: one output [..., N] for
    one layer, a tuple of them for several (which take no epilogue).
    With one layer, `gelu` applies nn.GELU() to its output and `residual`
    ([..., N]) is added last. Routed as the module docstring says."""
    if len(layers) > 1 and (gelu or residual is not None):
        raise ValueError("GELU and the residual take one layer")
    if _takes_kernel(x, layers, residual):
        w_hi, w_lo, bias = split_weights(layers)
        lead = x.shape[:-1]
        y = gemm(x.reshape(-1, x.shape[-1]), w_hi, w_lo, bias,
                 None if residual is None
                 else residual.reshape(-1, residual.shape[-1]), gelu=gelu)
        y = y.view(*lead, -1)
        if len(layers) == 1:
            return y
        widths = [layer.out_features for layer in layers]
        return tuple(y.split(widths + [y.shape[-1] - sum(widths)], -1))[
            :len(layers)]
    outs = [layer(x) for layer in layers]
    if len(layers) > 1:
        return tuple(outs)
    y = F.gelu(outs[0]) if gelu else outs[0]
    return y if residual is None else y + residual
