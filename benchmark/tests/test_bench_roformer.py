"""The `restore_enhance` driver (BS-RoFormer as the fourth restore stage)
at a tiny size on the CPU, in a temporary copy of the benchmark with a
tiny configuration and cell added by new files alone: a sound run is
correct, and each fault planted in the enhancer reads over the cell's
`out_err` limit: RoPE dropped, RoPE at another theta, the attention's
gates dropped, one band-axis transformer skipped. The same faults at the
cell's own size run on the card (`cuda`), one JSON line each, as
`test_bench_control_cuda.py` prints the controls."""
import json
import shutil
import time

import pytest
import torch

from benchmark.harness import cell
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bench_control_cuda import SEEDS, _run
from benchmark.tests.test_bench_faults import TINY

CELL = "bs_roformer_f32.restore_78_sides_enhance"
TINY_CELL = "tiny_rf.sides"
TINY_RF = {"dim": 32, "depth": 2, "heads": 2, "dim_head": 16,
           "freqs_per_bands": [4] * 8 + [8] * 6 + [16] * 2 + [17],
           "stft_n_fft": 256, "stft_hop_length": 100,
           "stft_win_length": 256}
LIMIT = 3e-4  # tiny widths in f32 on the CPU: a sound run reads ~4e-5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dst = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "benchmark", dst / "benchmark")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "benchmark/configs/bs_roformer_f32.json")
                        .read_text())
    for group, sizes in TINY.items():
        config[group].update(sizes)
    config["bs_roformer"].update(TINY_RF)
    config.update(name="tiny_rf")
    config["pipeline"].update(chunk_seconds=0.5, max_chunks_per_program=4)
    (dst / "benchmark/configs/tiny_rf.json").write_text(json.dumps(config))
    man["configs"].append({"name": "tiny_rf", "source": "a test",
                           "file": "benchmark/configs/tiny_rf.json",
                           "reduced": [], "why": "a test"})
    (dst / "benchmark/traffic/tiny_sides_enhance.json").write_text(
        json.dumps({"driver": "restore_enhance", "check_sides": 2,
                    "traced_units": 1, "why": "a test",
                    "side_seconds": {"low": 2.0, "high": 3.0, "count": 3}}))
    man["workloads"].append({"name": TINY_CELL, "config": "tiny_rf",
                             "traffic": "tiny_sides_enhance", "chips": 1,
                             "why": "a test"})
    (dst / f"benchmark/workloads/{TINY_CELL}.json").write_text(
        json.dumps({"limits": {"out_err": LIMIT}}))
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY_CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(man))
    return dst


def run(root, trace=False):
    torch.manual_seed(0)
    return cell.run(root, TINY_CELL, 2 ** 31 + 77, 0.3, trace,
                    time.perf_counter(), device="cpu", log=lambda s: None)


def test_sound_run_is_correct(root):
    r = run(root, trace=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["out_err"]["value"] < LIMIT / 3


def break_rope(monkeypatch):
    """RoPE left out of q and k."""
    from ml_audio_restoration_torch.models import bs_roformer as BR

    monkeypatch.setattr(BR, "rope", lambda x, table: x)


def break_rope_theta(monkeypatch):
    """RoPE's freqs built at theta 100,000 in place of 10,000."""
    from ml_audio_restoration_torch.models import bs_roformer as BR

    real = BR.RotaryEmbedding.__init__
    monkeypatch.setattr(BR.RotaryEmbedding, "__init__",
                        lambda self, dim, theta=1e4: real(self, dim, 1e5))


def break_gates(monkeypatch):
    """The attention's output taken ungated (every gate sigmoid(30))."""
    from ml_audio_restoration_torch.models import bs_roformer as BR

    real = BR.Attention.forward

    def ungated(self, x):
        gates = self.to_gates
        gates.forward = lambda v: v.new_full(
            (*v.shape[:-1], gates.out_features), 30.0)
        try:
            return real(self, x)
        finally:
            del gates.forward

    monkeypatch.setattr(BR.Attention, "forward", ungated)


def break_band_transformer(monkeypatch):
    """The first layer's band-axis transformer passes its input on."""
    from ml_audio_restoration_torch.models import bs_roformer as BR

    real = BR.BSRoformer.forward

    def skipped(self, audio):
        band = self.layers[0][1]
        band.forward = lambda x: x
        try:
            return real(self, audio)
        finally:
            del band.forward

    monkeypatch.setattr(BR.BSRoformer, "forward", skipped)


FAULTS = [break_rope, break_rope_theta, break_gates,
          break_band_transformer]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_broken_run_is_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    r = run(root)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_fails_at_the_cells_size(card, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(card, CELL, SEEDS[0], False, fault.__name__)
    assert not r["correct"], r["checks"]


def test_config_holds_the_published_widths():
    """The configuration's `bs_roformer` group is the ep_317 YAML's model
    group (ZFTurbo/Music-Source-Separation-Training, configs/viperx/
    model_bs_roformer_ep_317_sdr_12.9755.yaml), with nothing cut."""
    from ml_audio_restoration_torch.models import BSRoformer

    from benchmark.harness.manifest import Manifest

    man = Manifest(ROOT)
    config = man.config(man.cell(CELL))
    group = dict(config["bs_roformer"])
    assert man.configs["bs_roformer_f32"]["reduced"] == []
    assert group.pop("freqs_per_bands") == ([2] * 24 + [4] * 12 + [12] * 8
                                            + [24] * 8 + [48] * 8 + [128, 129])
    assert group == {"dim": 512, "depth": 12, "stereo": True, "num_stems": 1,
                     "time_transformer_depth": 1, "freq_transformer_depth": 1,
                     "dim_head": 64, "heads": 8, "mask_estimator_depth": 2,
                     "stft_n_fft": 2048,
                     "stft_hop_length": 441, "stft_win_length": 2048,
                     "stft_normalized": False}
    # 8 s at 22.05 kHz: the published 352,800-sample chunk after x2 SR
    assert config["pipeline"]["chunk_seconds"] * 22050 * 2 == 352800
    with torch.device("meta"):
        kw = dict(config["bs_roformer"])
        model = BSRoformer(kw.pop("dim"), **kw)
    assert sum(p.numel() for p in model.parameters()) == \
        config["params"]["bs_roformer"]
