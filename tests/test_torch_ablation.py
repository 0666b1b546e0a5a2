"""scripts/torch_lstm_ablation.py against the shipped kernel sources, on
the CPU: every design choice it takes back is a text patch that must find
its target exactly once, so a change to csrc/ that moves a target fails
here rather than on the card. Also the latency floors it and chip_smoke.py
count (ops/_latency.py)."""
import shutil
from pathlib import Path

import pytest

from ml_audio_restoration_torch.ops import _build, _latency

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "ml_audio_restoration_torch" / "csrc"


@pytest.fixture
def ablation(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    import torch_lstm_ablation
    return torch_lstm_ablation


def test_every_patch_finds_its_target(ablation):
    """Each variant builds from the shipped sources, and each one but a
    kernel's shipped form differs from it in its kernel or the header."""
    variants = ablation._variants(CSRC, None)
    shipped = {k: variants[f"{k}_shipped"][1] for k in ("k1", "k2", "k3")}
    for name, (kind, files, _) in variants.items():
        assert set(files) == {"lstm_common.cuh", (
            "lstm_recurrence.cu" if kind == "k1" else "lstm_train.cu")}, name
        assert (files == shipped[kind]) == name.endswith("_shipped"), name
    assert {n for n in variants if n.startswith("k2_")} == {
        "k2_shipped", "k2_precise", "k2_direct_loads", "k2_no_copies",
        "k2_no_stores"}


def test_k2_patches_touch_only_k2(ablation):
    """K2's patches leave K3's kernel (the same file) as it ships."""
    src = (CSRC / "lstm_train.cu").read_text()
    k3_start = src.index("// ------------------------------------------"
                         "------------------------ K3")
    for patch in (ablation.k2_direct_loads, ablation.k2_no_copies,
                  ablation.k2_no_stores):
        assert patch(src)[-(len(src) - k3_start):] == src[k3_start:]


def test_parent_variants_bring_their_header(ablation, tmp_path):
    """--parent: K1, K2 and K3 of an earlier checkout, each built with that
    checkout's own shared header."""
    dst = tmp_path / "ml_audio_restoration_torch" / "csrc"
    shutil.copytree(CSRC, dst)
    (dst / "lstm_common.cuh").write_text("// the parent's header\n")
    variants = ablation._variants(CSRC, tmp_path)
    for kind in ("k1", "k2", "k3"):
        got_kind, files, exact = variants[f"{kind}_parent"]
        assert got_kind == kind and exact
        assert files["lstm_common.cuh"] == "// the parent's header\n"


def test_k2_floor_is_k1_chain():
    """K2's counted step chain is K1's; at the step latencies the probe
    read on an H100 (PERF.md section 6, "Step latencies") K1's is 398
    cycles and K3's walk 245."""
    lat = {"ffma": 4.50, "fadd": 4.47, "gate_act": 70.5, "shfl_fadd": 30.3,
           "sts_bar_lds_fadd": 50.6}
    assert set(lat) == set(_latency.CHAINS)
    floor = _latency.floor_cycles(lat, 64)
    assert floor["k2"] == floor["k1"]
    assert floor["k1"] == pytest.approx(398.2, abs=0.1)
    assert floor["k3"] == pytest.approx(244.8, abs=0.1)


def test_latency_probe_is_a_package_source():
    """The probe builds like the kernels, from csrc/ with the shared header
    whose gate_act it times."""
    assert _build.sources(CSRC / f"{_latency.PROBE}.cu") == [
        CSRC / f"{_latency.PROBE}.cu", CSRC / "lstm_common.cuh"]


def test_int8_patches_find_their_targets(monkeypatch):
    """scripts/torch_int8_ablation.py: each int8 conv variant is the
    shipped source with its one patch applied, so each differs from it."""
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    import torch_int8_ablation as ab

    texts = ab.sources(CSRC)
    shipped = (CSRC / "int8_conv.cu").read_text()
    assert texts["shipped"] == shipped
    assert set(texts) == set(ab.VARIANTS)
    for name, text in texts.items():
        assert (text == shipped) == (name == "shipped"), name


def test_iir_patches_find_their_targets(monkeypatch):
    """scripts/torch_iir_ablation.py: each IIR scan variant is the shipped
    source with its one patch applied, so each differs from it."""
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    import torch_iir_ablation as ab

    texts = ab.sources(CSRC)
    shipped = (CSRC / "iir_scan.cu").read_text()
    assert texts["shipped"] == shipped
    assert set(texts) == set(ab.VARIANTS)
    for name, text in texts.items():
        assert (text == shipped) == (name == "shipped"), name
