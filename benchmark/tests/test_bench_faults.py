"""Whole runs on the CPU at a tiny size: a cell added in a temporary copy
of the benchmark by new files alone runs through the harness, a sound run
comes out correct, and a run whose timed path is broken underneath comes
out not correct, once for each fault the cell can have. (The harness's
look for a chip is skipped by passing the device.)

Faults: a step that returns its state unchanged (the stream's LSTM carry,
the trainer's parameters), half of the batch left out with the mean taken
over the rest, and an answer altered where it is produced; in training
also K3's backward with dW_hh or dgx zeroed, and in a restore over stereo
sub-windows their crossfade cut hard. The exchange between chips has no
place on one chip; a restore carries no state. The training cell's
faults at its own size are `test_bench_control_cuda.py`'s."""
import json
import shutil
import time

import pytest
import torch

from benchmark.harness import cell
from benchmark.tests.conftest import ROOT

TINY = {"denoiser": {"features": [4, 8, 16]},
        "super_resolution": {"base_channels": 4, "num_residual_blocks": 1},
        "stereo_separator": {"base_channels": 4, "lstm_hidden": 8}}
MIXES = {
    "tiny_sides": {"driver": "restore", "check_sides": 2, "traced_units": 1,
                   "side_seconds": {"low": 2.0, "high": 3.0, "count": 3}},
    "tiny_stream": {"driver": "stream", "streams": 4, "block_seconds": 0.05,
                    "context": 1024, "lookahead": 512, "check_streams": 4,
                    "traced_units": 2},
    "tiny_train": {"driver": "train", "files": 12, "file_seconds": 0.3,
                   "traced_units": 1},
}
# limits for the tiny widths (f32 on the CPU): well above a sound run's
# readings and well below a broken one's
CELLS = {
    "tiny.sides": ("tiny_sides", {"out_err": 1e-4}),
    "tiny.stream": ("tiny_stream", {"out_err": 1e-4}),
    "tiny.train": ("tiny_train", {"batch_gap": 0.0, "out1_gap": 1e-4,
                                  "loss1_gap": 1e-4, "change1_gap": 0.05,
                                  "change_median_gap": 0.05}),
    "tiny_sub.sides": ("tiny_sides", {"out_err": 1e-4}),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with a tiny configuration, three mixes and
    three cells added as files and manifest entries; no file edited."""
    dst = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "benchmark", dst / "benchmark")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "benchmark/configs/f32_default.json")
                        .read_text())
    for group, sizes in TINY.items():
        config[group].update(sizes)
    config.update(name="tiny")
    config["pipeline"].update(chunk_seconds=0.5, max_chunks_per_program=4)
    config["train"]["batch_size"] = 4
    config["data"]["chunk_duration"] = 0.25
    # the same with the stereo stage over 0.1 s sub-windows (fast_serve's
    # path, in float32)
    sub = json.loads(json.dumps(config))
    sub.update(name="tiny_sub")
    sub["pipeline"]["stereo_chunk_seconds"] = 0.1
    for c in (config, sub):
        (dst / f"benchmark/configs/{c['name']}.json").write_text(
            json.dumps(c))
        man["configs"].append({"name": c["name"], "source": "a test",
                               "file": f"benchmark/configs/{c['name']}.json",
                               "reduced": [], "why": "a test"})
    for name, mix in MIXES.items():
        (dst / f"benchmark/traffic/{name}.json").write_text(
            json.dumps(dict(mix, why="a test")))
    for name, (mix, limits) in CELLS.items():
        man["workloads"].append({"name": name,
                                 "config": name.split(".")[0],
                                 "traffic": mix, "chips": 1,
                                 "why": "a test"})
        (dst / f"benchmark/workloads/{name}.json").write_text(
            json.dumps({"limits": limits}))
    moves = {"restore": "xrt", "stream": "feed_p95_ms",
             "train": "train_audio_s_per_s"}
    for m in man["end_to_end"] + man["per_layer"]:
        for name, (mix, _) in CELLS.items():
            if "workloads" in m and moves[MIXES[mix]["driver"]] in (
                    m["name"], m.get("moves")):
                m["workloads"].append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(man))
    return dst


# a window long enough that the stream emits past its first `context`
SECONDS = {"tiny.sides": 0.3, "tiny.stream": 2.0, "tiny.train": 0.3,
           "tiny_sub.sides": 0.3}


def run(root, name, trace=False, seconds=None):
    seconds = seconds or SECONDS[name]
    torch.manual_seed(0)
    return cell.run(root, name, 2 ** 31 + 77, seconds, trace,
                    time.perf_counter(), device="cpu", log=lambda s: None)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(root, name):
    r = run(root, name, trace=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"
    # enough feeds for a 95th percentile (20)
    end_to_end = run(root, name, seconds=8.0)["metrics"]
    assert "setup_s" in end_to_end and len(end_to_end) == 2


def _break_restore_output(monkeypatch):
    from ml_audio_restoration_torch.pipeline.restore import (
        RestorationPipeline)

    real = RestorationPipeline.restore

    def altered(self, audio, sample_rate=None):
        out, rate = real(self, audio, sample_rate)
        out = out.clone()
        out[0, out.shape[1] // 2] += 0.5
        return out, rate

    monkeypatch.setattr(RestorationPipeline, "restore", altered)


def _break_restore_half(monkeypatch):
    from ml_audio_restoration_torch.pipeline.restore import _Stages

    real = _Stages.stack

    def half(self, chunks):
        y = real(self, chunks)
        return torch.cat([y[:len(y) // 2], torch.zeros_like(
            y[len(y) // 2:])])

    monkeypatch.setattr(_Stages, "stack", half)


def break_sub_window_crossfade(monkeypatch):
    """The stereo sub-windows joined by a hard cut: each window's first
    `hop` samples, the last one whole, with no crossfade."""
    from ml_audio_restoration_torch.pipeline import restore

    def cut(chunks, hop, length, *, overlap=0, valid=None):
        n, c, size = chunks.shape
        out = torch.cat([chunks[:, :, :hop].transpose(0, 1).reshape(
            c, n * hop), chunks[-1, :, hop:]], dim=1)
        return out[:, :length]

    monkeypatch.setattr(restore, "overlap_add", cut)


def _break_stream_state(monkeypatch):
    from ml_audio_restoration_torch.pipeline import streaming

    real = streaming.stacked_lstm

    def unchanged(x, layers, *, carries=None, return_carries=False):
        out = real(x, layers, carries=carries,
                   return_carries=return_carries)
        return (out[0], carries) if return_carries else out

    monkeypatch.setattr(streaming, "stacked_lstm", unchanged)


def _break_stream_half(monkeypatch):
    from ml_audio_restoration_torch.pipeline.streaming import (
        StreamingRestorer)

    real = StreamingRestorer._step

    def half(self, window, ctx, n):
        y = real(self, window, ctx, n)
        y[len(y) // 2:] = 0.0
        return y

    monkeypatch.setattr(StreamingRestorer, "_step", half)


def _break_stream_output(monkeypatch):
    from ml_audio_restoration_torch.pipeline.streaming import (
        StreamingRestorer)

    real = StreamingRestorer.feed

    def altered(self, block):
        out = real(self, block).copy()
        out[..., -1] += 0.5
        return out

    monkeypatch.setattr(StreamingRestorer, "feed", altered)


def _break_train_state(monkeypatch):
    from ml_audio_restoration_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "_update", lambda self: None)


def _break_train_half(monkeypatch):
    from ml_audio_restoration_torch.train.trainer import Trainer

    real = Trainer._derive

    def half(self, batch, generator=None):
        inputs, targets = real(self, batch, generator)
        keep = len(inputs) // 2
        return inputs[:keep], targets[:keep]

    monkeypatch.setattr(Trainer, "_derive", half)


def _k3(monkeypatch, which: int):
    from ml_audio_restoration_torch.ops import lstm

    real = lstm._train_bwd

    def zeroed(*args):
        out = list(real(*args))
        out[which] = torch.zeros_like(out[which])
        return tuple(out)

    monkeypatch.setattr(lstm, "_train_bwd", zeroed)


def break_k3_dw_hh(monkeypatch):
    """K3 returns dW_hh as zeros."""
    _k3(monkeypatch, 1)


def break_k3_dgx(monkeypatch):
    """K3 returns dgx (the gates' gradient, all that reaches the layers
    below the LSTM) as zeros."""
    _k3(monkeypatch, 0)


def _break_train_loss(monkeypatch):
    from ml_audio_restoration_torch.train.trainer import Trainer

    real = Trainer._loss

    def altered(self, *args, **kwargs):
        total, rest = real(self, *args, **kwargs)
        return total * 1.01, rest

    monkeypatch.setattr(Trainer, "_loss", altered)


@pytest.mark.parametrize("name,fault", [
    ("tiny.sides", _break_restore_output),
    ("tiny.sides", _break_restore_half),
    ("tiny_sub.sides", break_sub_window_crossfade),
    ("tiny.stream", _break_stream_state),
    ("tiny.stream", _break_stream_half),
    ("tiny.stream", _break_stream_output),
    ("tiny.train", _break_train_state),
    ("tiny.train", _break_train_half),
    ("tiny.train", _break_train_loss),
    ("tiny.train", break_k3_dw_hh),
    ("tiny.train", break_k3_dgx),
], ids=lambda v: getattr(v, "__name__", v))
def test_broken_run_is_not_correct(root, name, fault, monkeypatch):
    fault(monkeypatch)
    r = run(root, name)
    assert not r["correct"], r["checks"]
