"""The benchmark's manifest (`BENCHMARK.json`) and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by the name the manifest gives it:

- `configs[].file`                      the configuration as it is run;
- `benchmark/traffic/<traffic>.json`    a traffic mix: its parameters and
                                        the driver (`benchmark/traffic/
                                        <driver>.py`) that runs them;
- `benchmark/workloads/<cell>.json`     a cell's correctness limits;
- `benchmark/metrics/<metric>.py`       the reader of one metric.

So a later change adds a configuration, mix, cell or metric by adding
files and manifest entries, with no edit to a file that is already here.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Manifest:
    """BENCHMARK.json under `root`, with lookups by name."""

    def __init__(self, root):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {c["name"]: c for c in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    @property
    def bench(self) -> Path:
        return self.root / BENCH_DIR

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.cells)})")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        return json.loads((self.root / self.configs[cell["config"]]["file"])
                          .read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.bench / "traffic" / f"{cell['traffic']}.json")
                          .read_text())

    def limits(self, cell: dict) -> dict:
        return json.loads((self.bench / "workloads" / f"{cell['name']}.json")
                          .read_text())["limits"]

    def driver(self, traffic: dict):
        return load_module(self.bench / "traffic" / f"{traffic['driver']}.py")

    def metrics(self, cell: dict, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: its end-to-end metrics with
        --trace 0, its per-layer metrics with --trace 1. A metric without
        a `workloads` list belongs to every cell (end-to-end) or to every
        cell that reports the end-to-end metric it moves (per-layer)."""
        e2e = [m for m in self.data["end_to_end"] if _in(m, cell)]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: dict):
        return load_module(self.bench / "metrics" / f"{metric['name']}.py")


def _in(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def load_module(path: Path):
    """Import a benchmark file by path (metric names hold dots, so they
    are not importable module names)."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file not found: {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_" + re.sub(r"\W", "_", path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
