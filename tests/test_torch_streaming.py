"""The port's StreamingRestorer against the JAX package's, stream by
stream, and the CLI's `stream` subcommand.

Both restorers get the same weights (the narrow widths of
test_torch_pipeline.SMALL, randomized BN) and the same seeded numpy blocks.
Bars:
- f32: 1e-4 max abs over the whole output, edges included, since both
  run the same block algorithm (observed ~1e-7);
- a batched run against single streams of the port: 1e-6 (the JAX test's);
- bf16: the JAX side runs its TPU route, the Pallas recurrence in interpret
  mode (f32 state, as K1), and the bar is twice the deviation of JAX's own
  bf16 stream from its f32 stream (test_torch_serving explains the 2);
  observed 4.9e-4 against a JAX bf16-vs-f32 deviation of 1.1e-3.
"""
import functools
import io
import sys
import types

import numpy as np
import pytest
import torch

import ml_audio_restoration_tpu.ops.pallas.lstm as pallas_lstm
from ml_audio_restoration_tpu.pipeline.streaming import (
    StreamingRestorer as JaxStreaming)
from ml_audio_restoration_torch import cli
from ml_audio_restoration_torch.audio import read_wav, save_audio
from ml_audio_restoration_torch.ops import lstm as L
from ml_audio_restoration_torch.pipeline import StreamingRestorer
from test_torch_models import port_model
from test_torch_pipeline import RATE, SMALL
from test_torch_serving import _checkpoints, stages  # noqa: F401

STREAM_BAR = 1e-4
BATCH_BAR = 1e-6
KEYS = {"denoiser": "denoiser", "super_resolution": "super_resolution",
        "stereo_separator": "stereo"}


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(4)
    t = np.arange(int(0.6 * RATE)) / RATE
    sig = (0.3 * np.sin(2 * np.pi * 330 * t)
           + 0.1 * np.sin(2 * np.pi * 1234 * t)
           + 0.02 * rng.normal(size=t.shape))
    return sig.astype(np.float32)[None]


def _pair(stages, names=tuple(SMALL), **kw):  # noqa: F811
    """(JAX restorer, port restorer) over the same stages."""
    jax_side = JaxStreaming(**{KEYS[n]: stages[n] for n in names}, **kw)
    port = StreamingRestorer(**{KEYS[n]: port_model(n, *stages[n])
                                for n in names}, device="cpu", **kw)
    return jax_side, port


def _run(restorer, blocks):
    outs = [restorer.feed(b) for b in blocks]
    outs.append(restorer.flush())
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("names,kw", [
    (tuple(SMALL), {}),
    (tuple(SMALL), {"mid_exact": True}),
    (tuple(SMALL), {"source_rate": True}),
    (("denoiser",), {}),
    (("denoiser", "stereo_separator"), {"context": 600, "lookahead": 400})])
def test_streaming_matches_jax(stages, audio, names, kw):  # noqa: F811
    jax_side, port = _pair(stages, names, **kw)
    blocks = np.array_split(audio, 4, axis=1)
    want, got = _run(jax_side, blocks), _run(port, blocks)
    ch = 2 if "stereo_separator" in names else 1
    f = 2 if "super_resolution" in names else 1
    assert got.shape == want.shape == (ch, audio.shape[1] * f)
    assert got.dtype == np.float32
    assert float(np.abs(got - want).max()) < STREAM_BAR


def test_irregular_blocks_match_jax(stages, audio):  # noqa: F811
    """Blocks of any size, one shorter than the alignment, one past the
    lookahead: the same output as the JAX restorer fed the same cuts."""
    jax_side, port = _pair(stages)
    cuts = [0, 5, 1111, 5000, 9999, audio.shape[1]]
    blocks = [audio[:, a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    want, got = _run(jax_side, blocks), _run(port, blocks)
    assert got.shape == (2, audio.shape[1] * 2)
    assert float(np.abs(got - want).max()) < STREAM_BAR


def test_batched_streams_match_single_streams(stages):  # noqa: F811
    """B lockstep streams equal B single-stream restorers, and the JAX
    batched restorer."""
    rng = np.random.default_rng(6)
    b, n_blocks, block = 3, 4, 1500
    streams = (rng.normal(size=(b, n_blocks * block)) * 0.1).astype(
        np.float32)
    blocks = [streams[:, i * block:(i + 1) * block] for i in range(n_blocks)]
    jax_side, port = _pair(stages, batch=b)
    got = _run(port, blocks)
    assert got.shape == (b, 2, n_blocks * block * 2)
    assert float(np.abs(got - _run(jax_side, blocks)).max()) < STREAM_BAR
    for i in range(b):
        single = _pair(stages)[1]
        want = _run(single, [x[i] for x in blocks])
        assert float(np.abs(got[i] - want).max()) < BATCH_BAR


def test_reset_stream_matches_jax(stages):  # noqa: F811
    """Slot 1 recycled mid-run: the port and JAX agree on both slots, and
    the recycled slot equals a fresh stream fed the zero gap and the new
    samples (JAX test_reset_stream_recycles_one_slot)."""
    rng = np.random.default_rng(7)
    b, block = 2, 1500
    pre = (rng.normal(size=(b, 3 * block)) * 0.1).astype(np.float32)
    post = (rng.normal(size=(b, 3 * block)) * 0.1).astype(np.float32)
    outs = {}
    for name, r in zip(("jax", "port"), _pair(stages, batch=b)):
        first = [r.feed(pre[:, i * block:(i + 1) * block]) for i in range(3)]
        r.reset_stream(1)
        second = _run(r, [post[:, i * block:(i + 1) * block]
                          for i in range(3)])
        outs[name] = (np.concatenate(first, axis=2), second)
    for a, c in zip(outs["jax"], outs["port"]):
        assert a.shape == c.shape
        assert float(np.abs(a - c).max()) < STREAM_BAR
    emitted = outs["port"][0].shape[2] // 2
    fresh = _pair(stages)[1]
    want = _run(fresh, [np.zeros(3 * block - emitted, np.float32)]
                + [post[1, i * block:(i + 1) * block] for i in range(3)])
    assert float(np.abs(outs["port"][1][1] - want).max()) < BATCH_BAR
    with pytest.raises(IndexError):
        fresh.reset_stream(1)


def test_bf16_streaming_matches_jax(stages, audio, monkeypatch):  # noqa: F811
    """bf16 compute: f32 output within the bar of the module docstring;
    the carries and the decoder history stay bf16, reset_stream's mask
    included (JAX test_streaming_bf16_tracks_f32_and_keeps_dtypes)."""
    blocks = np.array_split(audio, 3, axis=1)
    want32 = _run(_pair(stages)[0], blocks)
    monkeypatch.setattr(pallas_lstm, "lstm_recurrence_pallas",
                        functools.partial(pallas_lstm.lstm_recurrence_pallas,
                                          interpret=True))
    jax_side, port = _pair(stages, compute_dtype="bfloat16",
                           lstm_impl="pallas")
    want, got = _run(jax_side, blocks), _run(port, blocks)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert 0.0 < float(np.abs(got - want).max()) <= 2 * float(
        np.abs(want - want32).max())
    (carry,), (hist,) = port._lstm_carry, port._dec_hist_buf  # one shard
    for h, c in carry:
        assert h.dtype == c.dtype == torch.bfloat16
    assert hist.dtype == torch.bfloat16
    port.reset_stream(0)
    (carry,), (hist,) = port._lstm_carry, port._dec_hist_buf
    assert all(h.dtype == c.dtype == torch.bfloat16 for h, c in carry)
    assert hist.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        StreamingRestorer(compute_dtype="float16", device="cpu")


def test_feed_runs_the_recurrence_twice(stages, monkeypatch):  # noqa: F811
    """A feed that emits runs the recurrence over the committed frames from
    the carry, then over the lookahead frames from the new carry; the
    second run's state is not kept."""
    calls = []
    plain = L.lstm_recurrence_plain

    def spy(gates, w_hh, h0, c0):
        calls.append((gates.shape[0], h0.clone()))
        return plain(gates, w_hh, h0, c0)

    monkeypatch.setattr(L, "lstm_recurrence_plain", spy)
    port = _pair(stages)[1]
    block = np.random.default_rng(8).normal(size=4000).astype(np.float32)
    port.feed(block * 0.1)
    (t_new, h_in), (t_la, h_la) = calls
    # 4000 - 512 lookahead, on the 8 grid, at 2x; the lookahead at 2x
    assert (t_new, t_la) == (2 * 3488, 2 * 512)
    assert not h_in.any() and h_la.any()
    carry = port._lstm_carry[0][0][0]  # shard 0, layer 0, h
    calls.clear()
    port.feed(block[:1000] * 0.1)
    assert torch.equal(calls[0][1], carry.float())


def test_latency_is_the_lookahead(stages):  # noqa: F811
    s = StreamingRestorer(denoiser=port_model("denoiser",
                                              *stages["denoiser"]),
                          lookahead=512, device="cpu")
    assert s.feed(np.zeros((1, 512), np.float32)).shape[1] == 0
    assert s.feed(np.zeros((1, 104), np.float32)).shape[1] == 104


def test_feed_rejects_wrong_shapes(stages):  # noqa: F811
    one = StreamingRestorer(denoiser=port_model("denoiser",
                                                *stages["denoiser"]),
                            device="cpu")
    with pytest.raises(ValueError, match="mono"):
        one.feed(np.zeros((2, 1024), np.float32))
    assert one.feed(np.zeros(1024, np.float32)).shape[0] == 1
    two = _pair(stages, ("denoiser",), batch=2)[1]
    with pytest.raises(ValueError, match=r"\[2, n\]"):
        two.feed(np.zeros(2048, np.float32))


def test_warmup_then_reset(stages):  # noqa: F811
    """warmup feeds zero blocks until the window shapes settle, then
    resets: the next stream starts fresh."""
    port = _pair(stages, batch=2)[1]
    got = port.warmup(1500)
    assert got["programs"] >= 2 and got["seconds"] > 0
    assert port._fed == 0 and port._dec_hist_buf == [None]
    assert not port._lstm_carry[0][0][0].any()
    assert port.warmup(1500)["programs"] == 0


@pytest.mark.parametrize("block", [1500, 1501])
def test_warmup_covers_a_whole_stream(stages, block):  # noqa: F811
    """After warmup(block), a stream of whole blocks, on the pooling grid or
    off it, and its flush run no window length that warmup did not."""
    port = _pair(stages)[1]
    port.warmup(block)
    warmed = set(port._shapes)
    rng = np.random.default_rng(10)
    audio = (rng.normal(size=7 * block) * 0.1).astype(np.float32)
    got = _run(port, [audio[o:o + block] for o in range(0, 7 * block, block)])
    assert got.shape == (2, 2 * 7 * block)
    assert port._shapes == warmed


def test_streaming_turns_tf32_off(stages):  # noqa: F811
    """A restorer built first in a process runs its convolutions in full
    f32, as RestorationPipeline does (TF32 would part a batched stream from
    single streams by ~5e-5 on the card)."""
    backends = (torch.backends.cudnn, torch.backends.cuda.matmul)
    was = [b.allow_tf32 for b in backends]
    try:
        for b in backends:
            b.allow_tf32 = True
        _pair(stages, ("denoiser",))
        assert not any(b.allow_tf32 for b in backends)
    finally:
        for b, w in zip(backends, was):
            b.allow_tf32 = w


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingRestorer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingRestorer.from_checkpoints()


def test_cli_stream_two_files(stages, tmp_path, capsys):  # noqa: F811
    """Two recordings of different lengths ride as lockstep streams (the
    shorter zero-padded, trimmed back on save); each file equals a
    two-stream restorer fed the same blocks."""
    rng = np.random.default_rng(9)
    lens = (9000, 6100)
    paths = []
    for i, t in enumerate(lens):
        paths.append(tmp_path / f"take{i}.wav")
        save_audio(paths[-1], (rng.normal(size=(1, t)) * 0.1).astype(
            np.float32), RATE, subtype="FLOAT")
    out_dir = tmp_path / "streamed"
    rc = cli.main(["stream", *map(str, paths), "--output-dir", str(out_dir),
                   "--block-seconds", str(2000 / RATE), "--device", "cpu"]
                  + _checkpoints(stages, tmp_path))
    assert rc == 0
    assert capsys.readouterr().out.count("streamed ->") == 2
    batch = np.zeros((2, max(lens)), np.float32)
    for i, p in enumerate(paths):
        x = read_wav(p)[0][:, 0]
        batch[i, :x.shape[0]] = x
    direct = _pair(stages, batch=2)[1]
    want = _run(direct, [batch[:, o:o + 2000]
                         for o in range(0, max(lens), 2000)])
    for i, t in enumerate(lens):
        data, rate = read_wav(out_dir / f"take{i}_restored.wav")
        assert rate == 2 * RATE and data.shape == (2 * t, 2)
        assert float(np.abs(data.T - want[i, :, :2 * t]).max()) <= 1 / 32768


@pytest.mark.parametrize("fmt", ["f32le", "s16le"])
def test_cli_stream_pipe_matches_direct(stages, tmp_path, monkeypatch,
                                        fmt):  # noqa: F811
    """`stream -` (pipe mode): raw PCM through stdin/stdout, short reads
    included, equals driving the restorer directly (JAX
    test_cli_stream_pipe_bitmatches_direct)."""
    x = (0.3 * np.random.default_rng(7).normal(size=5000)).astype(np.float32)
    if fmt == "s16le":
        raw = np.clip(np.rint(x * 32767), -32768, 32767).astype(np.int16)
        x = raw.astype(np.float32) / 32768.0
    else:
        raw = x

    class ShortReads(io.BytesIO):
        def read(self, n=-1):
            return super().read(min(n, 1000) if n and n > 0 else n)

    fake_in = types.SimpleNamespace(buffer=ShortReads(raw.tobytes()))
    fake_out = types.SimpleNamespace(buffer=io.BytesIO())
    monkeypatch.setattr(sys, "stdin", fake_in)
    monkeypatch.setattr(sys, "stdout", fake_out)
    args = ["stream", "-", "--no-super-res", "--no-stereo", "--block-seconds",
            str(1500 / RATE), "--device", "cpu"]
    if fmt == "s16le":
        args += ["--pcm", "s16le"]
    rc = cli.main(args + _checkpoints(stages, tmp_path))
    monkeypatch.undo()
    assert rc == 0
    dtype = np.float32 if fmt == "f32le" else np.int16
    got = np.frombuffer(fake_out.buffer.getvalue(), dtype)
    direct = StreamingRestorer(denoiser=port_model("denoiser",
                                                   *stages["denoiser"]),
                               device="cpu")
    want = _run(direct, [x[o:o + 1500] for o in range(0, x.shape[0], 1500)])
    want = want[0]
    if fmt == "s16le":
        want = np.clip(np.rint(want * 32767), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(got, want)
