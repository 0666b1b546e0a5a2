"""The readers of the program's spans (`benchmark/harness/spans.py` and the
eight metrics that use it) on synthetic span records: None with no spans,
with a program that keeps none, and on the CPU for a device reading; the
right value a unit otherwise, a span's self time (its duration less the
union of its children's) included."""
import pytest

from benchmark.harness import spans as S
from benchmark.harness.manifest import Manifest
from benchmark.tests.conftest import ROOT
from ml_audio_restoration_torch.utils import profiling

MAN = Manifest(ROOT)
READERS = {m["name"]: MAN.reader(m) for m in MAN.data["per_layer"]}


def _span(i, name, host, device=None, parent=None, **counts):
    """A record as profiling.spans() gives it: host and device (start,
    end) in ms, device None on the CPU."""
    d0, d1 = device or (None, None)
    return {"id": i, "name": name, "parent": parent,
            "start_ns": int(host[0] * 1e6), "end_ns": int(host[1] * 1e6),
            "host_ms": host[1] - host[0], "counts": counts,
            "device_start_ms": d0, "device_end_ms": d1,
            "device_ms": None if device is None else d1 - d0}


def _restores(device=True):
    """Two restores: 3 and 2 programs; one denoise span holds two
    overlapping children (3-5 and 4-7 of its 2-10). As the program's, the
    spans read on the host's clock have no device reading."""
    def dev(a, b):
        return (a, b) if device else None

    return [
        _span(0, "restore", (0, 100), None, rows_real=140,
              rows_run=192),
        _span(1, "restore.denoise", (1, 2), dev(2, 10), 0),
        _span(2, "inner", (1, 2), dev(3, 5), 1),
        _span(3, "inner", (1, 2), dev(4, 7), 1),
        _span(4, "restore.super_resolution", (2, 3), dev(10, 12), 0),
        _span(5, "restore.stereo", (3, 4), dev(12, 40), 0),
        _span(6, "restore.denoise", (5, 6), dev(40, 44), 0),
        _span(7, "restore.super_resolution", (6, 7), dev(44, 46), 0),
        _span(8, "restore.stereo", (7, 8), dev(46, 70), 0),
        _span(9, "restore.denoise", (8, 9), dev(70, 73), 0),
        _span(10, "restore.super_resolution", (9, 10), dev(73, 74), 0),
        _span(11, "restore.stereo", (10, 11), dev(74, 99), 0),
        _span(12, "restore", (200, 300), None, rows_real=101,
              rows_run=128),
        _span(13, "restore.denoise", (201, 202), dev(100, 104), 12),
        _span(14, "restore.super_resolution", (202, 203), dev(104, 106),
              12),
        _span(15, "restore.stereo", (203, 204), dev(106, 150), 12),
        _span(16, "restore.denoise", (205, 206), dev(150, 153), 12),
        _span(17, "restore.super_resolution", (206, 207), dev(153, 154),
              12),
        _span(18, "restore.stereo", (207, 208), dev(154, 159), 12),
    ]


def _feeds(device=True):
    def dev(a, b):
        return (a, b) if device else None

    out = []
    for k in range(2):
        t = 100.0 * k
        out += [_span(10 * k, "stream.feed", (t, t + 35)),
                _span(10 * k + 1, "stream.buffer", (t, t + 0.5), None,
                      10 * k),
                _span(10 * k + 2, "stream.buffer", (t + 1, t + 1.25), None,
                      10 * k),
                _span(10 * k + 3, "stream.upload", (t + 2, t + 3),
                      dev(t + 2, t + 2.5 + k), 10 * k),
                _span(10 * k + 4, "stream.download", (t + 30, t + 34),
                      dev(t + 29, t + 33), 10 * k),
                _span(10 * k + 5, "stream.buffer", (t + 34, t + 34.75),
                      None, 10 * k)]
    return out


def _steps(device=True):
    def dev(a, b):
        return (a, b) if device else None

    out = []
    for k in range(3):
        t = 10.0 * k
        wait = 4.0 if k == 0 else 0.5
        out += [_span(10 * k, "loader.wait", (t, t + wait)),
                _span(10 * k + 1, "train.step", (t + 5, t + 9)),
                _span(10 * k + 2, "train.update", (t + 8, t + 8.5),
                      dev(t + 8, t + 8.2 + 0.1 * k), 10 * k + 1)]
    return out


CASES = {
    # denoise: (8 less the union 3-7 of its children) + 4 + 3 + 4 + 3
    "denoise_ms.restore": (_restores, (4 + 4 + 3 + 4 + 3) / 2),
    "super_res_ms.restore": (_restores, (2 + 2 + 1 + 2 + 1) / 2),
    "stereo_ms.restore": (_restores, (28 + 24 + 25 + 44 + 5) / 2),
    "chunk_fill.restore": (_restores, 100 * 241 / 320),
    "feed_buffer_ms.stream": (_feeds, (0.5 + 0.25 + 0.75) * 2 / 2),
    "feed_copy_ms.stream": (_feeds, (0.5 + 4 + 1.5 + 4) / 2),
    "loader_queue_wait_ms.train": (_steps, (4 + 0.5 + 0.5) / 3),
    "update_ms.train": (_steps, (0.2 + 0.3 + 0.4) / 3),
}
DEVICE = {m["name"] for m in MAN.data["per_layer"]
          if m["source"] == "device_trace"}


def _feed(monkeypatch, records):
    monkeypatch.setattr(profiling, "spans", lambda: records)


def test_every_span_reader_is_in_the_manifest():
    assert set(CASES) <= set(READERS)
    assert {n for n in CASES if n in DEVICE} == {
        "denoise_ms.restore", "super_res_ms.restore", "stereo_ms.restore",
        "feed_copy_ms.stream", "update_ms.train"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_value(name, monkeypatch):
    make, want = CASES[name]
    _feed(monkeypatch, make())
    assert READERS[name].read({}) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_none_without_spans(name, monkeypatch):
    _feed(monkeypatch, [])
    assert READERS[name].read({}) is None
    # another cell's spans hold none of this cell's units
    others = {"restore": _feeds, "stream": _steps, "train": _restores}
    _feed(monkeypatch, others[name.split(".")[-1]]())
    assert READERS[name].read({}) is None
    # a program that keeps no spans (the parent of the spans)
    monkeypatch.delattr(profiling, "spans")
    assert READERS[name].read({}) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_readers_none_on_the_cpu(name, monkeypatch):
    make, want = CASES[name]
    _feed(monkeypatch, make(device=False))
    got = READERS[name].read({})
    if name in DEVICE:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_self_time_on_each_clock():
    parent = _span(0, "p", (0, 10), (100, 110))
    kids = [_span(1, "c", (2, 4), (101, 103), 0),
            _span(2, "c", (3, 6), (109, 115), 0),   # past the parent's end
            _span(3, "c", (-1, 1), None, 0)]        # no device reading
    assert S.self_ms(parent, kids, "host") == pytest.approx(10 - 4 - 1)
    assert S.self_ms(parent, kids, "device") == pytest.approx(10 - 2 - 1)
    assert S.self_ms(parent, [], "device") == pytest.approx(10)
    assert S.self_ms(_span(4, "q", (0, 1)), [], "device") is None
    open_ = dict(parent, end_ns=None)
    assert S.self_ms(open_, kids, "host") is None
