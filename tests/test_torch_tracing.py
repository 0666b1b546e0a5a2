"""The program's spans (utils/profiling.py `annotate`, `spans`): off, a
restore, a feed and a train step record nothing and call nothing of the
profiler; on, each span is where its work is, with its counts and parent,
and lies in the chrome trace as a `user_annotation` nested the same way;
outputs are bit for bit the same on and off; the buffer is bounded.

Tiny widths on the CPU. The one card test (marked `cuda`, it skips here)
imports nothing of JAX, as this file does not, so it runs on the card
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m cuda -q
"""
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ml_audio_restoration_torch.config import PipelineConfig, TrainConfig
from ml_audio_restoration_torch.data import DataLoader
from ml_audio_restoration_torch.models import (
    AudioDenoiser, AudioSuperResolution, StereoSeparator, init_params)
from ml_audio_restoration_torch.ops import num_chunks
from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                 StreamingRestorer)
from ml_audio_restoration_torch.train.trainer import Trainer
from ml_audio_restoration_torch.utils import profiling as P

RATE = 22050
CHUNK, OVERLAP = 1000, 100
HOP = CHUNK - OVERLAP
STAGES = ("restore.denoise", "restore.super_resolution", "restore.stereo")
SPANS = ("restore", *STAGES, "stream.feed", "stream.buffer", "stream.upload",
         "stream.download", "train.step", "train.update", "loader.wait")
T_TRAIN, B_TRAIN, N_FILES = 2048, 2, 4


@pytest.fixture(autouse=True)
def empty_buffer():
    P.clear_spans()
    yield
    P.clear_spans()


def _models(device="cpu"):
    gen = torch.Generator().manual_seed(0)
    return tuple(init_params(m, gen).to(device) for m in (
        AudioDenoiser(features=(8, 16)),
        AudioSuperResolution(base_channels=8, num_residual_blocks=2),
        StereoSeparator(base_channels=8, lstm_hidden=16)))


def _audio(t, seed=1):
    return np.random.default_rng(seed).normal(
        0, 0.1, (1, t)).astype(np.float32)


def _pipe(device="cpu", **cfg):
    dn, sr, st = _models(device)
    return RestorationPipeline(dn, sr, st, device=device, config=PipelineConfig(
        chunk_seconds=CHUNK / RATE, overlap_seconds=OVERLAP / RATE, **cfg))


def _restorer():
    dn, sr, st = _models()
    return StreamingRestorer(dn, sr, st, context=64, lookahead=64, batch=2,
                             device="cpu")


def _blocks(n=3, size=200):
    rng = np.random.default_rng(2)
    return [rng.normal(0, 0.1, (2, size)).astype(np.float32)
            for _ in range(n)]


class _Stereo:
    pairing = "mono_target_stereo"

    def __len__(self):
        return N_FILES

    def __getitem__(self, i):
        t = np.arange(T_TRAIN) / RATE
        left = np.sin(2 * np.pi * (220 + 40 * i) * t)
        return {"stereo": (0.3 * np.stack([left, 0.6 * left + 0.1 * np.cos(
            2 * np.pi * 330 * t)])).astype(np.float32)}


def _trainer():
    gen = torch.Generator().manual_seed(0)
    model = init_params(StereoSeparator(base_channels=4, lstm_hidden=8), gen)
    return Trainer("stereo_separator", model,
                   DataLoader(_Stereo(), B_TRAIN, seed=0), None,
                   config=TrainConfig(model="stereo_separator",
                                      learning_rate=1e-3, max_grad_norm=1.0,
                                      ema_decay=0.99),
                   sample_rate=RATE, device="cpu")


def _run(kind):
    """One restore, three feeds or one epoch; returns its output."""
    if kind == "restore":
        return _pipe().restore(_audio(4500), RATE)[0]
    if kind == "feed":
        r = _restorer()
        return np.concatenate([r.feed(b) for b in _blocks()], axis=-1)
    return _trainer().train_epoch()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, P.spans()


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


# ------------------------------------------------------------------- off
def test_off_check_is_torch_profiler_flag():
    """The off check is torch's own C flag of a profiler recording on this
    thread (about 0.05 us a call, against ~13 us for an ungated
    record_function), and off `annotate` returns one shared no-op."""
    assert P._profiler_enabled is torch._C._autograd._profiler_enabled
    assert not P._profiler_enabled()
    assert P.annotate("x") is P.annotate("y", True, rows=3) is P.NO_SPAN
    with P.annotate("x") as span:
        span.count(rows=1)
    assert P.spans() == []


@pytest.mark.parametrize("kind", ["restore", "feed", "step"])
def test_off_records_nothing(kind, monkeypatch):
    """With no profiler, the program calls no record_function of its own
    (torch's optimizer opens its own regions) and makes no CUDA event, and
    the buffer stays empty."""
    record_function = torch.autograd.profiler.record_function
    opened = []

    def spy(name, *args, **kwargs):
        opened.append(name)
        return record_function(name, *args, **kwargs)

    def forbidden(*args, **kwargs):
        raise AssertionError("a CUDA event with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    _run(kind)
    assert not set(opened) & set(SPANS)
    assert P.spans() == []


# -------------------------------------------------------------------- on
class _FakeEvent:
    def __init__(self, enable_timing=False):
        self.recorded = 0

    def record(self, stream=None):
        self.recorded += 1


@pytest.mark.parametrize("kind,timed", [
    ("restore", STAGES), ("feed", ("stream.upload", "stream.download")),
    ("step", ("train.update",))])
def test_events_only_on_device_spans(kind, timed, monkeypatch):
    """With CUDA initialised, only the spans whose readers take device ms
    (opened with `device_ms`) record CUDA events, one at entry and one at
    exit; the spans read on the host's clock record none."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    with profile(activities=[ProfilerActivity.CPU]):
        _run(kind)
    recs = list(P._RECORDER.records)  # spans() would resolve the events
    assert {r["name"] for r in recs} >= set(timed)
    for r in recs:
        if r["name"] in timed:
            assert [e.recorded for e in r["events"]] == [1, 1], r["name"]
        else:
            assert r["events"] is None, r["name"]


@pytest.mark.parametrize("t,cfg,rows_real,rows_run,programs", [
    (4500, {}, num_chunks(4500, CHUNK, HOP), 8, 1),             # bucketed
    (9000, {"max_chunks_per_program": 8},
     num_chunks(9000, CHUNK, HOP), 16, 2),                      # 2 slabs
    (4500, {"whole_file": True}, 1, 1, 1),
], ids=["bucketed", "slabbed", "whole_file"])
def test_restore_spans(t, cfg, rows_real, rows_run, programs):
    pipe = _pipe(**cfg)
    for _ in range(2):
        _, spans = _traced(lambda: pipe.restore(_audio(t), RATE))
        roots = _named(spans, "restore")
        assert len(roots) == 1
        root = roots[0]
        assert root["parent"] is None
        assert root["counts"] == {"rows_real": rows_real,
                                  "rows_run": rows_run}
        for name in STAGES:
            stage = _named(spans, name)
            assert len(stage) == programs
            assert all(s["parent"] == root["id"] for s in stage)
        for s in spans:
            assert s["device_ms"] is None and s["device_start_ms"] is None
            assert 0 <= s["host_ms"] <= root["host_ms"]
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"]
        P.clear_spans()


def test_feed_spans():
    """One stream.feed a feed, every other stream span inside one; one
    stream.upload and one stream.download a window, in its feed."""
    r = _restorer()
    windows = []
    step = r._step

    def spy(window, ctx, n):
        windows.append(P._RECORDER.stack()[-1])  # the span open around it
        return step(window, ctx, n)

    r._step = spy
    blocks = _blocks(4)
    _, spans = _traced(lambda: [r.feed(b) for b in blocks])
    feeds = _named(spans, "stream.feed")
    assert len(feeds) == len(blocks)
    ids = {f["id"] for f in feeds}
    assert all(s["parent"] in ids for s in spans if s not in feeds)
    assert set(windows) <= ids
    for name in ("stream.upload", "stream.download"):
        copies = _named(spans, name)
        assert [c["parent"] for c in copies] == windows, name
        assert all(c["counts"] == {} for c in copies)
    assert len(windows) >= 2  # the lookahead filled, then windows ran
    # every feed concatenates its block; every window is sliced and padded
    # and the history trimmed after it
    buffers = _named(spans, "stream.buffer")
    assert len(buffers) >= len(blocks) + 2 * len(windows)


def test_train_step_spans():
    """One train.step, loader.wait and train.update a step; the update
    inside its step, the wait before it (the loop fetches the batch)."""
    tr = _trainer()
    _, spans = _traced(tr.train_epoch)
    steps = _named(spans, "train.step")
    assert len(steps) == N_FILES // B_TRAIN == tr.global_step
    waits = _named(spans, "loader.wait")
    updates = _named(spans, "train.update")
    assert len(waits) == len(updates) == len(steps)
    assert [u["parent"] for u in updates] == [s["id"] for s in steps]
    assert all(w["parent"] is None for w in waits)
    for w, s in zip(waits, steps):
        assert w["end_ns"] <= s["start_ns"]


def test_chrome_trace_holds_every_span_nested_alike(tmp_path):
    """Each recorded span is a user_annotation of its name in the exported
    chrome trace, the k-th of a name matching the k-th, and a span's
    annotation lies inside its parent's."""
    pipe = _pipe(max_chunks_per_program=8)
    with P.trace(tmp_path):
        pipe.restore(_audio(9000), RATE)
    spans = P.spans()
    trace = json.loads(next(tmp_path.glob("trace_*.json")).read_text())
    events = {}
    for ev in trace["traceEvents"]:
        if ev.get("cat") == "user_annotation" and ev.get("ph") == "X":
            events.setdefault(ev["name"], []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    placed = {}
    for name in {s["name"] for s in spans}:
        mine = _named(spans, name)
        theirs = sorted(events.get(name, []))
        assert len(theirs) == len(mine), name
        placed.update((s["id"], e) for s, e in zip(mine, theirs))
    nested = [s for s in spans if s["parent"] is not None]
    assert len(nested) == 2 * len(STAGES)
    for s in nested:
        (c0, c1), (p0, p1) = placed[s["id"]], placed[s["parent"]]
        assert p0 <= c0 <= c1 <= p1, s["name"]


@pytest.mark.parametrize("kind", ["restore", "feed", "step"])
def test_outputs_equal_on_and_off(kind):
    """Restore output, feed output and an epoch's loss (its two steps,
    the second after the first's update) bit for bit the same with the
    spans on and off."""
    off = _run(kind)
    on, spans = _traced(lambda: _run(kind))
    assert spans
    if kind == "step":
        assert on == off
    else:
        assert np.array_equal(np.asarray(on), np.asarray(off))


def test_buffer_is_bounded():
    n = P.MAX_SPANS + 5
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n):
            with P.annotate("x", i=i):
                pass
    spans = P.spans()
    assert len(spans) == P.MAX_SPANS
    assert [s["counts"]["i"] for s in spans[:2]] == [5, 6]
    assert spans[-1]["counts"]["i"] == n - 1


def test_parents_per_thread_and_counts_inside():
    """Parents come from the span's own thread; counts given at entry and
    added inside are kept; an open span has no end."""
    def other():
        with P.annotate("other"):
            time.sleep(0.001)

    with profile(activities=[ProfilerActivity.CPU]):
        with P.annotate("outer", a=1) as span:
            span.count(b=2)
            with P.annotate("inner"):
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()
            open_ = P.annotate("open")
            open_.__enter__()
            during = P.spans()
            open_.__exit__(None, None, None)
    by = {s["name"]: s for s in P.spans()}
    assert by["outer"]["counts"] == {"a": 1, "b": 2}
    assert by["inner"]["parent"] == by["outer"]["id"]
    assert by["open"]["parent"] == by["outer"]["id"]
    # a thread the profiler does not record on opens no span
    assert "other" not in by
    assert {s["name"]: s["end_ns"] for s in during}["open"] is None
    assert by["outer"]["host_ms"] >= by["inner"]["host_ms"] >= 1.0


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_stage_device_ms_on_the_card():
    """On a card the three stage spans read device ms, and their sum is at
    most the synchronised wall of the restore that holds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pipe = _pipe(device="cuda", max_chunks_per_program=8)
    audio = _audio(9000)
    pipe.restore(audio, RATE)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        pipe.restore(audio, RATE)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = P.spans()
    stage_ms = [s["device_ms"] for s in spans if s["name"] in STAGES]
    assert len(stage_ms) == 2 * len(STAGES)
    assert _named(spans, "restore")[0]["device_ms"] is None  # host-read
    assert all(ms is not None and ms > 0 for ms in stage_ms)
    assert sum(stage_ms) <= wall_ms
