"""The frozen counts: the kernels' bounds as the program's records give
them (PERF.md's kernel table), and the model FLOPs from shapes equal to
torch's FLOP counter on the program's models."""
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import kernels as K
from benchmark.counts import models as C
from benchmark.tests.conftest import ROOT

CONFIG = json.loads((ROOT / "benchmark/configs/f32_default.json").read_text())
FAST = json.loads((ROOT / "benchmark/configs/bf16_fast_serve.json")
                  .read_text())


@pytest.mark.parametrize("count,ms", [
    (K.k1(88200, 64, 64), 2.76),
    (K.k1(11024, 640, 64, "bfloat16"), 1.35),
    (K.k2(44100, 16, 64), 0.539),
    (K.k3(44100, 16, 64), 0.690),
])
def test_kernel_bounds(count, ms):
    assert count["bound_ms"] == pytest.approx(ms, abs=0.005)


def _counted(fn) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("t", [512, 1000])
def test_model_flops_equal_torch_counter(t):
    from benchmark.harness.system import build_models

    models = build_models(CONFIG, "cpu", 3)
    x = torch.randn(1, 1, t)
    assert _counted(lambda: models["denoiser"](x)) == C.denoiser(
        t, **CONFIG["denoiser"])
    assert _counted(lambda: models["super_resolution"](x)) == \
        C.super_resolution(t, **CONFIG["super_resolution"])
    x = torch.randn(1, 1, t // 8)
    assert _counted(lambda: models["stereo_separator"](x)) == \
        C.stereo_separator(t // 8, **CONFIG["stereo_separator"])


def test_stereo_windows_follow_the_preset():
    assert C.stereo_windows(CONFIG, 88200, 22050) == [88200]
    # 0.25 s at 44.1 kHz, rounded to 4: 11,024; overlap 2,205; 10 windows
    assert C.stereo_windows(FAST, 88200, 22050) == [11024] * 10
    assert C.chain(FAST, 44100) > C.chain(CONFIG, 44100)


def test_peaks_are_the_data_sheet():
    assert K.peak_flops("float32") == 67e12
    assert K.peak_flops("bfloat16") == 989e12
    assert K.PEAKS["hbm_bytes_per_s"] == 3.35e12
