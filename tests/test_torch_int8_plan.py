"""The int8 conv's index algebra on the CPU (ops/int8_conv.py::plan).

csrc/int8_conv.cu runs only on the card, but what it computes from the
shapes is decided in Python: `plan` picks the path and the tiling and
names each phase's taps, `chunks` the order in which the wgmma path walks
K over `Int8Weight.rows()`. Two parts:

(a) The planner on every int8 conv call of short full-width restores (the
    default program, `int8_scope="full"` and config/fast_serve_int8.yaml,
    captured as chip_smoke.py captures them): Cin % 16 == 0 plans wgmma,
    the three Cin-1 stems plan stem, nothing falls to generic, and the
    launch totals are the card's 35 / 49 / 23.
(b) A plain twin of the kernel's decomposition: the int32 accumulators
    recomputed from the kernel's own weight rows, tile by tile, phase by
    phase and chunk by chunk (the TMA boxes' rows with their zero fill,
    the element stride along T, the zero chunk that pairs 16-byte chunks),
    the stem's span and im2col tile, and the generic path's gathered taps,
    held exactly (torch.equal) to `plain_accumulate` over the card tests'
    geometries and a seeded sweep of kp, stride, lhs dilation, padding
    (negative too), odd T_in, Cin and Cout.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ml_audio_restoration_torch.config import PipelineConfig, load_config
from ml_audio_restoration_torch.models import (
    AudioDenoiser, AudioSuperResolution, StereoSeparator, init_params)
from ml_audio_restoration_torch.ops import int8_conv as ic
from ml_audio_restoration_torch.ops import quant
from ml_audio_restoration_torch.pipeline import RestorationPipeline
from test_torch_cuda import INT8_GEOMETRIES

ROOT = Path(__file__).resolve().parents[1]
RATE = 22050
CHUNK_SECONDS = 8820 / RATE  # above the preset's 0.25 s stereo windows


def _models():
    """The three models at their published widths, seeded, with random BN
    statistics (chip_smoke.py's)."""
    gen = torch.Generator().manual_seed(0)
    models = []
    for m in (AudioDenoiser(), AudioSuperResolution(), StereoSeparator()):
        m = init_params(m, gen)
        with torch.no_grad():
            for bn in m.modules():
                if isinstance(bn, torch.nn.BatchNorm1d):
                    u = lambda: torch.rand(  # noqa: E731
                        bn.running_mean.shape, generator=gen)
                    bn.running_mean.copy_((u() - 0.5) * 0.2)
                    bn.running_var.copy_(u() + 0.5)
                    bn.weight.copy_(u() + 0.5)
                    bn.bias.copy_((u() - 0.5) * 0.2)
        models.append(m.eval())
    return models


def _program_calls(cfg):
    """Every int8 conv call of one restore: (layer, x shape, kernel shape,
    stride, lhs dilation, padding)."""
    rng = np.random.default_rng(3)
    audio = (0.1 * rng.standard_normal((1, RATE // 2))).astype(np.float32)
    pipe = RestorationPipeline(*_models(), config=cfg, device="cpu")
    pipe.calibrate_int8(audio, RATE)
    make, conv, layer, calls = quant.int8_exec, quant.int8_conv, [None], []

    def named_exec(x_scale, cache=None, key=None):
        ex = make(x_scale, cache, key)

        def _exec(xq, kernel, **kw):
            layer[0] = key
            return ex(xq, kernel, **kw)
        return _exec

    def recording(x, weight, **kw):
        calls.append((layer[0], tuple(x.shape), weight.shape, kw["stride"],
                      kw["lhs_dilation"], kw["padding"]))
        return conv(x, weight, **kw)

    quant.int8_exec, quant.int8_conv = named_exec, recording
    try:
        pipe.restore(audio, RATE)
    finally:
        quant.int8_exec, quant.int8_conv = make, conv
    return calls


PROGRAMS = {
    "default": (lambda: PipelineConfig(quantize_int8=True,
                                       chunk_seconds=CHUNK_SECONDS),
                {"wgmma": 32, "stem": 3, "generic": 0}),
    "full": (lambda: PipelineConfig(quantize_int8=True, int8_scope="full",
                                    chunk_seconds=CHUNK_SECONDS),
             {"wgmma": 46, "stem": 3, "generic": 0}),
    "fast_serve_int8": (lambda: dataclasses.replace(
        load_config(ROOT / "config" / "fast_serve_int8.yaml").pipeline,
        chunk_seconds=CHUNK_SECONDS), {"wgmma": 21, "stem": 2, "generic": 0}),
}


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_program_layers_plan_wgmma_and_stem(program):
    """(a) Every layer with Cin % 16 == 0 plans wgmma, the raising stems
    (Cin 1, stride 4) plan stem, none generic; the totals are the card's."""
    make_cfg, want = PROGRAMS[program]
    calls = _program_calls(make_cfg())
    got = dict.fromkeys(ic.PATHS, 0)
    for layer, x_shape, w_shape, stride, dil, padding in calls:
        p = ic.plan(x_shape, w_shape, stride, dil, padding)
        got[p.path] += 1
        cin = x_shape[2]
        assert p.path == ("wgmma" if cin % 16 == 0 else "stem"), (
            layer, x_shape, w_shape, stride, dil, padding)
        if p.path == "stem":
            assert layer in ("enc0.c1", "stem") and stride == 4
    assert got == want


def _plan_invariants(p: ic.Plan, x_shape, w_shape, stride):
    n, _, cin = x_shape
    kp, _, cout = w_shape
    if p.path == "generic":
        return
    assert n * p.tiles * p.phases < 2 ** 31
    assert p.phases * p.tpc >= p.t_out and p.tiles * ic.BM >= p.tpc
    assert p.n_tile in ic.N_TILES and p.n_tile * p.col_blocks >= cout
    assert p.col_blocks == 1 or p.n_tile == ic.N_TILES[-1]
    n_rows, k_pad = ic.weight_layout(kp, cin, cout)
    assert n_rows >= p.n_tile * p.col_blocks and k_pad >= kp * cin + 16
    if p.path == "wgmma":
        assert cin % p.cw == 0 and p.rb * stride <= 256
        assert ic.BM % p.rb == 0 and p.rb % 8 == 0
        per = max(p.cw, 32) // p.cw
        stage = per * ic.BM * p.cw + per * -(-p.n_tile * p.cw // 1024) * 1024
        staged = ic.BM * (p.n_tile + 8) * 4
        assert 3 <= p.stages <= 8
        assert 1024 + max(p.stages * stage, staged) + 16 * p.stages \
            <= ic.SMEM_MAX
        # every tap is read by exactly one phase
        assert sorted(m for t in p.taps for m in t) == list(range(kp))


def twin_accumulate(x, wq, stride, dil, padding):
    """The kernel's accumulators recomputed from its own weight rows, in
    the order its plan walks them (int64, then int32)."""
    n, t_in, cin = x.shape
    kp, _, cout = wq.shape
    lo = padding[0]
    p = ic.plan(x.shape, wq.shape, stride, dil, padding)
    rows = ic.Int8Weight(wq, torch.ones(cout)).rows().long()
    xl = x.long()
    acc = torch.zeros((n, p.t_out, cout), dtype=torch.long)

    def gather(idx, c0, width):
        """x rows `idx` [n, len] channels c0.., zero out of [0, T_in) (the
        TMA unit's zero fill)."""
        ok = (idx >= 0) & (idx < t_in)
        got = xl[:, idx.clamp(0, max(t_in - 1, 0)), c0:c0 + width]
        return got * ok[None, :, None]

    if p.path == "wgmma":
        for c in range(p.phases):
            for tile in range(p.tiles):
                j = tile * ic.BM + torch.arange(ic.BM)
                t = c + p.phases * j
                keep = t < p.t_out
                for m, c0, wcol in ic.chunks(p, kp, cin, c):
                    row = (tile * ic.BM + (c + m - lo) // dil if p.phases > 1
                           else tile * ic.BM * stride + m - lo)
                    a = torch.cat([gather(
                        row + (r0 + torch.arange(p.rb))
                        * (1 if p.phases > 1 else stride), c0, p.cw)
                        for r0 in range(0, ic.BM, p.rb)], dim=1)
                    b = rows[:cout, wcol:wcol + p.cw]
                    acc[:, t[keep]] += (a @ b.T)[:, keep]
    elif p.path == "stem":
        for tile in range(p.tiles):
            w0 = tile * ic.BM * stride - lo
            span = gather(w0 + torch.arange((ic.BM - 1) * stride + kp), 0, 1)
            a = torch.zeros((n, ic.BM, 32), dtype=torch.long)
            for k in range(kp):  # the im2col tile: row r, byte k
                a[:, :, k] = span[:, k + stride * torch.arange(ic.BM), 0]
            t = tile * ic.BM + torch.arange(ic.BM)
            keep = t < p.t_out
            acc[:, t[keep]] += (a @ rows[:cout, :32].T)[:, keep]
    else:  # gathered rows, tap by tap, over the lhs-dilated span
        t = torch.arange(p.t_out)
        for m in range(kp):
            u = t * stride + m - lo
            hit = (u % dil == 0) & (u >= 0) & (u < (t_in - 1) * dil + 1)
            a = gather(torch.where(hit, u // dil, -1), 0, cin)
            acc += a @ rows[:cout, m * cin:(m + 1) * cin].T
    return p, acc.to(torch.int32)


def _check_twin(geo, seed):
    n, t_in, cin, cout, kp, stride, dil, lo, hi = geo
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, (n, t_in, cin), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (kp, cin, cout), generator=g).to(
        torch.int8)
    p, got = twin_accumulate(x, wq, stride, dil, (lo, hi))
    _plan_invariants(p, x.shape, wq.shape, stride)
    want = ic.plain_accumulate(x, wq, stride=stride, lhs_dilation=dil,
                               padding=(lo, hi))
    assert got.shape == want.shape and torch.equal(got, want), (geo, p)
    return p


@pytest.mark.parametrize("geo", INT8_GEOMETRIES)
def test_twin_matches_plain_on_card_geometries(geo):
    """(b) The card tests' geometries, mirrored on the CPU (the large ones
    cut to 2 rows of batch and 300 steps: the tiling repeats)."""
    n, t_in, *rest = geo
    geo = (min(n, 2), min(t_in, 300), *rest)
    p = _check_twin(geo, seed=0)
    cin = geo[2]
    assert p.path == ("wgmma" if cin % 16 == 0 else "stem" if cin == 1
                      else "generic")


def _sweep_case(seed):
    rng = np.random.default_rng(seed)
    cin = int(rng.choice([1, 1, 16, 32, 48, 64, 128, 256, 4, 12]))
    cout = int(rng.choice([1, 3, 8, 32, 33, 65, 128, 200, 256, 300]))
    kp = int(rng.integers(1, 18 if cin > 1 else 33))
    if rng.random() < 0.5:
        stride, dil = int(rng.choice([1, 2, 2, 3, 4, 5, 8])), 1
    else:
        stride, dil = 1, int(rng.integers(2, 9))
    lo, hi = (int(v) for v in rng.integers(-3, 9, 2))
    t_in = int(rng.integers(1, 160)) | 1  # odd
    geo = (int(rng.integers(1, 4)), t_in, cin, cout, kp, stride, dil, lo, hi)
    if ic.out_length(t_in, kp, stride, dil, (lo, hi)) == 0:
        geo = (geo[0], t_in + 2 * kp + 6, *geo[2:])
    return geo


@pytest.mark.parametrize("seed", range(40))
def test_twin_matches_plain_on_a_seeded_sweep(seed):
    """(b) A seeded sweep: kp 1-17 (1-32 for Cin 1), stride 1-8 or lhs
    dilation 2-8, pads in [-3, 8], odd T_in, Cin 1-256 and Cout 1-300."""
    _check_twin(_sweep_case(seed), seed)


def test_sweep_reaches_every_path_and_channel_block():
    """The sweep above covers each path, every wgmma channel block (the
    four swizzles), the element strides' boxes of 128, 64 and 32 rows, the
    zero chunk, several column blocks and phases with no tap."""
    seen = set()
    for seed in range(40):
        geo = _sweep_case(seed)
        n, t_in, cin, cout, kp, stride, dil, lo, hi = geo
        p = ic.plan((n, t_in, cin), (kp, cin, cout), stride, dil, (lo, hi))
        seen.add(p.path)
        if p.path == "wgmma":
            seen |= {f"cw{p.cw}", f"rb{p.rb}"}
            if p.col_blocks > 1:
                seen.add("col_blocks")
            if any(not t for t in p.taps):
                seen.add("empty_phase")
            if any(len(ic.chunks(p, kp, cin, c)) > len(p.taps[c])
                   * (cin // p.cw) for c in range(p.phases)):
                seen.add("zero_chunk")
    assert seen >= {"wgmma", "stem", "generic", "cw128", "cw64", "cw32",
                    "cw16", "rb128", "rb64", "rb32", "col_blocks",
                    "empty_phase", "zero_chunk"}, seen


def test_reset_launch_count_clears_every_path():
    ic.launch_count_by_path["wgmma"] += 3
    ic.reset_launch_count()
    assert ic.launch_count == 0
    assert ic.launch_count_by_path == dict.fromkeys(ic.PATHS, 0)
