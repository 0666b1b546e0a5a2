"""The manifest's names, units and keys, and every file a cell needs,
found by name."""
import json
import re

import pytest

from benchmark.harness.manifest import NAME, UNIT, Manifest
from benchmark.tests.conftest import ROOT

MAN = Manifest(ROOT)
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    d = MAN.data
    assert set(d) == TOP
    assert d["paths"] == ["benchmark"]
    assert d["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= d["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in d["end_to_end"])


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_names_and_units(kind, keys):
    names = [e["name"] for e in MAN.data[kind]]
    assert len(names) == len(set(names))
    for e in MAN.data[kind]:
        assert set(e) - {"workloads"} == keys, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e and kind != "end_to_end":
                assert LINE.match(e[text]), e[text]


def test_metrics_name_their_cells_and_moves():
    cells = set(MAN.cells)
    e2e = {m["name"]: m for m in MAN.data["end_to_end"]}
    for m in MAN.data["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in MAN.data["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in set(e2e[m["moves"]].get("workloads", cells))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in MAN.data["workloads"]:
        assert c["chips"] in (1, 4)
        assert MAN.metrics(c, trace=False), c["name"]
        assert MAN.metrics(c, trace=True), c["name"]


@pytest.mark.parametrize("name", sorted(MAN.cells))
def test_every_cell_file_is_found_by_name(name):
    cell = MAN.cell(name)
    config = MAN.config(cell)
    entry = MAN.configs[cell["config"]]
    assert entry["file"].startswith("benchmark/")
    assert config["name"] == cell["config"]
    traffic = MAN.traffic(cell)
    assert hasattr(MAN.driver(traffic), "Session")
    assert MAN.limits(cell)
    for trace in (False, True):
        for m in MAN.metrics(cell, trace):
            assert callable(MAN.reader(m).read)


def test_configs_keep_the_published_widths():
    for entry in MAN.data["configs"]:
        assert entry["reduced"] == []
        c = json.loads((ROOT / entry["file"]).read_text())
        assert c["denoiser"]["features"] == [32, 64, 128]
        assert c["super_resolution"]["base_channels"] == 32
        assert c["super_resolution"]["num_residual_blocks"] == 4
        assert c["stereo_separator"] == {"base_channels": 32,
                                         "lstm_hidden": 64,
                                         "num_lstm_layers": 1}


def test_published_parameter_counts():
    from ml_audio_restoration_torch.models import count_params

    from benchmark.harness.system import build_models

    c = MAN.config(MAN.cell("f32_default.restore_78_sides"))
    models = build_models(c, "cpu", 0)
    assert {k: count_params(m) for k, m in models.items()} == c["params"]
