"""On the card, at each cell's own size: sound runs of the program are
correct; the control (the plain reference in the precision below the
configuration's, put in the program's place) and, for a training cell,
the planted half-batch fault each fail one of the cell's numbers; and so
does each fault that the training cell can have underneath its timed
path (K3 with dW_hh or dgx zeroed). This is where the limits in
`benchmark/workloads/` were read from: each run prints one JSON line of
its numbers and readings (seen with `-s`) and appends it to the file that
`CONTROL_OUT` names, when set. The benchmark's own runs never run this.

    python -m pytest benchmark/tests -m cuda -q -s

`CONTROL_SEEDS` (whole numbers, space-separated) replaces the three seeds
of the control runs, and `CONTROL_SECONDS` the window (the manifest's
`run_seconds` by default); the fault runs take the first three seeds.
"""
import json
import os
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import cell
from benchmark.harness.manifest import Manifest
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bench_faults import break_k3_dgx, break_k3_dw_hh

MAN = Manifest(ROOT)
SEEDS = tuple(int(s) for s in os.environ.get("CONTROL_SEEDS", "").split()) \
    or (2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503)
SECONDS = float(os.environ.get("CONTROL_SECONDS") or MAN.data["run_seconds"])
OUT = os.environ.get("CONTROL_OUT")


def _run(card, name, seed, control, run):
    r = cell.run(ROOT, name, seed, SECONDS, False, time.perf_counter(),
                 device=card, control=control, log=lambda s: None)
    line = json.dumps({
        "workload": name, "seed": seed, "run": run, "correct": r["correct"],
        "numbers": {k: v["value"] for k, v in r["checks"].items()},
        "readings": r.get("readings", {}),
        "memory_peak_bytes": r["device"]["memory_peak_bytes"]})
    print(line, flush=True)
    if OUT:
        Path(OUT).parent.mkdir(parents=True, exist_ok=True)
        with open(OUT, "a") as f:
            f.write(line + "\n")
    torch.cuda.empty_cache()
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MAN.cells))
def test_control_fails_and_program_passes(card, name):
    limits = MAN.limits(MAN.cell(name))
    bad = []  # every seed runs, and the test fails on any of them
    for seed in SEEDS:
        r = _run(card, name, seed, True, "control")
        if not r["correct"]:
            bad.append((seed, r["checks"]))
        readings = r["readings"]
        tags = {k.split(".", 1)[1] for k in readings if "." in k}
        if "control" not in tags:
            bad.append((seed, "no control"))
        for tag in tags:
            if not any(readings[f"{k}.{tag}"] > lim
                       for k, lim in limits.items()
                       if f"{k}.{tag}" in readings):
                bad.append((seed, tag, readings))
    assert not bad, bad


TRAIN = "f32_default.train_stereo_b16"


@pytest.mark.cuda
@pytest.mark.parametrize("name,fault", [
    (TRAIN, break_k3_dw_hh),
    (TRAIN, break_k3_dgx),
], ids=lambda v: getattr(v, "__name__", v))
def test_fault_fails_at_the_cells_size(card, name, fault, monkeypatch):
    fault(monkeypatch)
    passed = [(seed, r["checks"]) for seed in SEEDS[:3]
              if (r := _run(card, name, seed, False, fault.__name__))[
                  "correct"]]
    assert not passed, passed
