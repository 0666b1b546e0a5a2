"""The port's serving daemon, stream half (pipeline/server.py StreamServer
and stream_over_tcp) and `cli serve`: one counterpart of each streaming
test and of the CLI test of tests/test_server.py, and one TCP stream
through the JAX package's StreamServer and the port's.

The restorers run on the CPU with the denoiser at full width on the JAX
package's initial weights. Every socket, join and wait has a timeout of
its own, and the servers take short drain-stall windows.

Bars:
- a stream against a direct restorer with another batch size (a B-slot
  server against a batch-1 restorer): MANY_TOL, restore_many's contract
  (the CPU convolutions may sum in another order at another batch size);
- two streams through the same server (slot reuse, WebSocket vs TCP in
  test_torch_ws.py): bit for bit;
- the port's stream server against the JAX package's: STREAM_BAR, the bar
  of test_torch_streaming.py::test_streaming_matches_jax.
"""
import json
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.pipeline import (
    StreamingRestorer as JaxStreaming)
from ml_audio_restoration_tpu.pipeline import StreamServer as JaxStreamServer
from ml_audio_restoration_torch.audio import encode_wav, normalize_audio
from ml_audio_restoration_torch.parallel import Mesh, make_mesh
from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                 StreamingRestorer,
                                                 StreamServer)
from ml_audio_restoration_torch.pipeline.server import (restore_over_http,
                                                        stream_over_tcp)
from test_torch_models import port_model
from test_torch_pipeline import SMALL
from test_torch_server_http import (MANY_TOL, ROOT, SR,  # noqa: F401
                                    TIMEOUT, _save_denoiser, dn_stage,
                                    one_torch_thread, sine)
from test_torch_serving import stages  # noqa: F401
from test_torch_streaming import STREAM_BAR


def _restorer(dn_stage, batch=1):
    return StreamingRestorer(denoiser=port_model("denoiser", *dn_stage),
                             batch=batch, device="cpu")


def _stream(srv, sig, **kw):
    kw.setdefault("block", 2048)
    return stream_over_tcp(srv.host, srv.port, sig, timeout=TIMEOUT, **kw)


def _direct(dn_stage, sig, block):
    """A single-stream restorer fed `sig` in `block`s, then flushed."""
    direct = _restorer(dn_stage)
    outs = [direct.feed(sig[k:k + block]) for k in range(0, len(sig), block)]
    outs.append(direct.flush())
    return np.concatenate([o for o in outs if o.shape[-1]],
                          axis=-1)[:, :len(sig)]


def _near(got, want):
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= MANY_TOL


def _wait(cond, seconds=TIMEOUT):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def _tone(seconds, f0):
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def test_stream_server_matches_direct_restorer(dn_stage, sine):
    """One TCP stream == a direct single-stream StreamingRestorer fed the
    same samples (the server's zero-fill drain == flush padding), within
    MANY_TOL: the server's restorer runs 2 rows."""
    block = 2048
    with StreamServer(_restorer(dn_stage, batch=2), block=block) as srv:
        got = _stream(srv, sine, block=block)
    assert got.shape == (1, len(sine))
    _near(got, _direct(dn_stage, sine, block))


def test_stream_server_timed_tick_fills_underruns(dn_stage):
    """Live-feed mode (tick_seconds set): a client slower than the block
    clock gets its shortfall rendered as silence: underruns are counted,
    the inserted silence occupies real timeline positions (output grows
    past the input), and the server keeps serving cleanly afterwards."""
    block = 2048
    sig = _tone(4 * block / SR, 330)

    with StreamServer(_restorer(dn_stage, batch=2), block=block,
                      tick_seconds=0.05) as srv:
        sock = socket.create_connection((srv.host, srv.port), timeout=60)
        payload = sig.astype("<f4").tobytes()
        half = len(payload) // 2
        chunks = []

        def read_all():
            while True:
                try:
                    buf = sock.recv(1 << 16)
                except OSError:
                    return
                if not buf:
                    return
                chunks.append(buf)

        rd = threading.Thread(target=read_all, daemon=True)
        rd.start()
        sock.sendall(payload[:half])
        # stall past several tick deadlines: the clock must render the
        # missing samples as silence rather than blocking the batch
        assert _wait(lambda: srv.stats()["underruns"] >= 1, 30)
        sock.sendall(payload[half:])
        sock.shutdown(socket.SHUT_WR)
        rd.join(timeout=TIMEOUT)
        assert not rd.is_alive()
        sock.close()

        out = np.frombuffer(b"".join(chunks), "<f4")
        # silence fill occupies timeline: output >= the input's samples,
        # and the drain contract still closes the stream at exactly `owed`
        assert len(out) >= len(sig)
        assert np.isfinite(out).all()

        # the slot is reusable: a follow-up stream is served to completion
        # (under a 50 ms live clock its own feed may also underrun on a
        # slow host, so assert the drain contract, not equality)
        got = _stream(srv, sig, block=block)
    assert got.shape[0] == 1 and got.shape[1] >= len(sig)
    assert np.isfinite(got).all()


def test_stream_server_two_concurrent_streams(dn_stage):
    """Two lockstep connections each match an independent restorer
    (MANY_TOL: the server's restorer runs 2 rows)."""
    block = 2048
    sigs = [_tone(0.9, 250), _tone(0.9, 620)]
    results = {}
    with StreamServer(_restorer(dn_stage, batch=2), block=block) as srv:
        def run(i):
            results[i] = _stream(srv, sigs[i], block=block)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
        assert not any(th.is_alive() for th in threads)

    assert set(results) == {0, 1}
    for i, sig in enumerate(sigs):
        _near(results[i], _direct(dn_stage, sig, block))


def test_stream_server_late_join_skips_pre_join_timeline(dn_stage):
    """A stream that connects AFTER the clock has advanced must not receive
    the batch's pre-join emission (the lockstep timeline it wasn't part
    of): its output still matches an independent restorer (MANY_TOL)."""
    block = 2048
    early, late = _tone(0.7, 210), _tone(0.7, 770)
    with StreamServer(_restorer(dn_stage, batch=2), block=block) as srv:
        results = {}

        def run_early():
            results["early"] = _stream(srv, early, block=block)

        th = threading.Thread(target=run_early)
        th.start()
        # wait until the clock has demonstrably advanced (emission lags
        # feeds, so ticks > 1 means the global timeline is past zero)
        assert _wait(lambda: srv.stats()["ticks"] >= 2)
        results["late"] = _stream(srv, late, block=block)
        th.join(timeout=TIMEOUT)
        assert not th.is_alive()

    for name, sig in (("early", early), ("late", late)):
        _near(results[name], _direct(dn_stage, sig, block))


def test_stream_server_slot_reuse(dn_stage):
    """A second connection after the first finishes reuses its slot with a
    clean state (reset_stream before the first feed): identical input ->
    identical output, bit for bit (the same restorer)."""
    block = 2048
    sig = _tone(0.6, 333)
    with StreamServer(_restorer(dn_stage), block=block) as srv:
        first = _stream(srv, sig, block=block)
        # wait for the slot to free before reconnecting
        assert _wait(lambda: srv.stats()["active_streams"] == 0)
        second = _stream(srv, sig, block=block)
        stats = srv.stats()

    np.testing.assert_array_equal(first, second)
    assert stats["connections"] == 2


def test_stereo_slot_reuse_is_a_fresh_stream_after_the_gap(stages):  # noqa: F811
    """With the stereo stage, a slot that joins a running clock (here
    reused after a first stream) equals a fresh restorer fed the
    restorer's unemitted gap as zeros, then its samples, with the gap's
    output dropped: reset_stream's contract
    (test_torch_streaming.py::test_reset_stream_matches_jax). The stereo
    LSTM consumes the gap's frames, so it is not a fresh restorer fed the
    samples alone; the JAX package's server does the same (its
    reset_stream zeroes the carry at the reset too). MANY_TOL: batch 2
    against batch 1."""
    keys = {"denoiser": "denoiser", "super_resolution": "super_resolution",
            "stereo_separator": "stereo"}
    models = {keys[n]: port_model(n, *stages[n]) for n in SMALL}
    block = 2048
    first, second = _tone(0.3, 210), _tone(0.4, 530)
    restorer = StreamingRestorer(**models, batch=2, device="cpu")
    with StreamServer(restorer, block=block) as srv:
        _stream(srv, first, block=block, channels=2)
        assert _wait(lambda: srv.stats()["active_streams"] == 0)
        gap = restorer._fed - restorer._emitted
        got = _stream(srv, second, block=block, channels=2)
    fresh = StreamingRestorer(**models, device="cpu")
    x = np.concatenate([np.zeros(gap, np.float32), second])
    outs = [fresh.feed(x[k:k + block]) for k in range(0, len(x), block)]
    outs.append(fresh.flush())
    want = np.concatenate(outs, axis=-1)[:, 2 * gap:2 * len(x)]
    assert gap > 0
    _near(got, want)
    # and the gap matters: a fresh restorer on the samples alone differs
    alone = StreamingRestorer(**models, device="cpu")
    outs = [alone.feed(second[k:k + block])
            for k in range(0, len(second), block)]
    outs.append(alone.flush())
    alone_out = np.concatenate(outs, axis=-1)[:, :2 * len(second)]
    assert float(np.abs(got - alone_out).max()) > MANY_TOL


def test_stream_server_refuses_when_full(dn_stage):
    """batch=1 server: a second simultaneous connection is closed without
    output (refused), the first is unaffected."""
    block = 1024
    with StreamServer(_restorer(dn_stage), block=block) as srv:
        # occupy the only slot with a half-open connection
        holder = socket.create_connection((srv.host, srv.port), timeout=60)
        holder.sendall(np.zeros(block, np.float32).tobytes())
        assert _wait(lambda: srv.stats()["active_streams"] == 1)

        second = socket.create_connection((srv.host, srv.port), timeout=60)
        second.settimeout(TIMEOUT)
        # refused connections are closed immediately: recv -> b""
        assert second.recv(4) == b""
        second.close()

        holder.shutdown(socket.SHUT_WR)
        out = bytearray()
        while True:
            buf = holder.recv(1 << 16)
            if not buf:
                break
            out.extend(buf)
        holder.close()
        stats = srv.stats()

    assert stats["refused"] == 1
    assert len(out) == block * 4  # full first block restored and returned


def test_stream_server_slow_consumer_isolated_and_dropped(dn_stage):
    """Offline mode: a client that never reads its output pauses the clock
    (backpressure) but is reaped after drain_stall_seconds of zero read
    progress, so it cannot stall the other lockstep streams forever. The
    concurrent well-behaved stream still matches an independent restorer
    (MANY_TOL), and the freed slot is reusable."""
    block = 2048
    payload_bytes = block * 4  # one tick's output for a mono f32 stream
    slow_sig, fast_sig = _tone(1.5, 150), _tone(1.5, 480)

    # tiny kernel + outbox budgets so congestion appears within ~2 s of
    # audio, and a short stall window so the reap is fast
    with StreamServer(_restorer(dn_stage, batch=2), block=block,
                      max_outbox_bytes=2 * payload_bytes,
                      sndbuf=4096, drain_stall_seconds=0.75) as srv:
        # slow client: shrink its receive window BEFORE connecting, send
        # everything, half-close, and never read a byte
        slow = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        slow.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        slow.settimeout(60)
        slow.connect((srv.host, srv.port))
        slow.sendall(slow_sig.astype("<f4").tobytes())
        slow.shutdown(socket.SHUT_WR)

        got_fast = _stream(srv, fast_sig, block=block)

        assert _wait(lambda: srv.stats()["dropped_slow"] >= 1)
        slow.close()

        # the freed slot serves a new connection to completion
        assert _wait(lambda: srv.stats()["active_streams"] == 0)
        got_again = _stream(srv, fast_sig, block=block)
        stats_end = srv.stats()

    assert stats_end["connections"] == 3
    want = _direct(dn_stage, fast_sig, block)
    _near(got_fast, want)
    _near(got_again, want)


def test_stream_server_live_mode_drops_on_overflow(dn_stage):
    """Live mode (tick_seconds set): the clock never waits on a consumer:
    a never-reading client is dropped as soon as its outbox would exceed
    max_outbox_bytes."""
    block = 2048
    payload_bytes = block * 4
    sig = _tone(2.0, 150)
    with StreamServer(_restorer(dn_stage, batch=2), block=block,
                      tick_seconds=0.05, max_outbox_bytes=2 * payload_bytes,
                      sndbuf=4096) as srv:
        slow = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        slow.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        slow.settimeout(60)
        slow.connect((srv.host, srv.port))
        slow.sendall(sig.astype("<f4").tobytes())
        slow.shutdown(socket.SHUT_WR)

        assert _wait(lambda: srv.stats()["dropped_slow"] >= 1)
        stats = srv.stats()
        slow.close()
    assert stats["active_streams"] == 0  # the dropped slot was freed


def test_stream_server_s16le(dn_stage):
    """s16le transport: output matches the f32 path up to 16-bit
    quantization of input and output (plus MANY_TOL: the server's
    restorer and the direct one are both batch 1, but the comparison
    runs through the PCM rounding anyway)."""
    block = 2048
    sig = _tone(0.5, 500)
    # what the server will see after s16 encode->decode of the input
    sig_q = (np.clip(np.rint(sig * 32767.0), -32768, 32767)
             / 32768.0).astype(np.float32)

    with StreamServer(_restorer(dn_stage), block=block, fmt="s16le") as srv:
        got = _stream(srv, sig, fmt="s16le", block=block)

    want = _direct(dn_stage, sig_q, block)
    assert got.shape == want.shape
    # output went through one s16 round trip
    assert np.max(np.abs(got - want)) <= 1.0 / 32768.0 + 1e-7


def test_stream_server_rejects_unknown_format(dn_stage):
    with pytest.raises(ValueError, match="f32le"):
        StreamServer(_restorer(dn_stage), fmt="f64le")


# ----------------------------------------------------- against the JAX one

@pytest.mark.parametrize("names", [("denoiser",), tuple(SMALL)],
                         ids=["denoiser", "three_stages"])
def test_stream_matches_jax_stream_server(dn_stage, stages, sine,  # noqa: F811
                                          names):
    """One TCP stream through the JAX package's StreamServer and through
    the port's, over the same weights (the denoiser at full width, or the
    three stages at SMALL widths) and the same 2-slot lockstep batch."""
    if names == ("denoiser",):
        weights = {"denoiser": dn_stage}
    else:
        weights = {n: stages[n] for n in names}
    keys = {"denoiser": "denoiser", "super_resolution": "super_resolution",
            "stereo_separator": "stereo"}
    jax_side = JaxStreaming(**{keys[n]: w for n, w in weights.items()},
                            batch=2)
    port = StreamingRestorer(**{keys[n]: port_model(n, *w)
                                for n, w in weights.items()},
                             batch=2, device="cpu")
    ch = 2 if "stereo_separator" in names else 1
    block = 2048
    sig = sine[:int(0.6 * SR)]
    with JaxStreamServer(jax_side, block=block) as jsrv:
        want = _stream(jsrv, sig, block=block, channels=ch)
    with StreamServer(port, block=block) as srv:
        got = _stream(srv, sig, block=block, channels=ch)
    f = 2 if "super_resolution" in names else 1
    assert got.shape == want.shape == (ch, len(sig) * f)
    assert float(np.abs(got - want).max()) < STREAM_BAR


# --------------------------------------------------------------------- CLI

def _lines(proc):
    """A queue of the process's stdout lines, read on a thread so every
    wait for a line has a timeout."""
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return lines


def _serve(tmp_path, dn_stage, *extra):
    ckpt = _save_denoiser(tmp_path / "dn.pth", dn_stage)
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "ml_audio_restoration_torch", "serve",
         "--port", "0", "--denoiser", str(ckpt), "--no-super-res",
         "--no-stereo", "--device", "cpu", "--socket-timeout", "30",
         "--request-timeout", "60", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})


def _announced(lines, want: tuple, seen=None) -> dict:
    """The ports the daemon prints: {"http": port, "tcp": port}; the
    lines read on the way are appended to `seen`."""
    found = {}
    deadline = time.monotonic() + TIMEOUT
    while set(found) != set(want) and time.monotonic() < deadline:
        line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        assert line is not None, "serve exited early"
        if seen is not None:
            seen.append(line)
        for kind in want:
            m = re.search(kind + r"://[\d.]+:(\d+)", line)
            if m:
                found[kind] = int(m.group(1))
    assert set(found) == set(want), f"serve announced only {found}"
    return found


def _stop(proc, sig):
    proc.send_signal(sig)
    try:
        proc.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=TIMEOUT)


def test_cli_serve_smoke(dn_stage, tmp_path):
    """`cli serve` end to end in a subprocess: warms up (a YAML caps the
    chunk buckets at 4 so the CPU warmup is short), starts, answers
    /healthz (naming its device), restores over HTTP, serves a TCP stream,
    and shuts down cleanly on SIGINT."""
    cfg = tmp_path / "serve.yaml"
    cfg.write_text("pipeline:\n  chunk_seconds: 0.25\n"
                   "  max_chunks_per_program: 4\n")
    proc = _serve(tmp_path, dn_stage, "--stream-port", "0",
                  "--stream-slots", "2", "--warmup", "--config", str(cfg))
    try:
        printed = []
        ports = _announced(_lines(proc), ("http", "tcp"), printed)
        health = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{ports['http']}/healthz", timeout=TIMEOUT))
        assert health["status"] == "ok" and health["devices"] == ["cpu"]

        t = np.arange(SR // 2) / SR
        sig = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        got, rate = restore_over_http("127.0.0.1", ports["http"],
                                      encode_wav(sig[:, None], SR),
                                      timeout=TIMEOUT)
        assert rate == SR and got.shape == (1, len(sig))
        streamed = stream_over_tcp("127.0.0.1", ports["tcp"], sig,
                                   block=2048, timeout=TIMEOUT)
        assert streamed.shape == (1, len(sig))
        assert np.isfinite(streamed).all()
    finally:
        _stop(proc, signal.SIGINT)
    assert proc.returncode == 0
    # --warmup ran both engines before the ports were announced
    assert any(ln.lstrip().startswith("pipeline:") for ln in printed)
    assert any(ln.lstrip().startswith("streaming:") for ln in printed)


def test_cli_serve_int8_persists_scales(dn_stage, tmp_path):
    """`serve --int8 --int8-scales`: the daemon calibrates on its first
    request and writes the scales file when SIGTERM drains it."""
    scales = tmp_path / "scales.json"
    proc = _serve(tmp_path, dn_stage, "--int8", "--int8-scales",
                  str(scales))
    try:
        ports = _announced(_lines(proc), ("http",))
        t = np.arange(SR // 2) / SR
        sig = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        got, rate = restore_over_http("127.0.0.1", ports["http"],
                                      encode_wav(sig[:, None], SR),
                                      timeout=TIMEOUT)
        assert rate == SR and np.isfinite(got).all()
        assert not scales.exists()  # written at shutdown
    finally:
        _stop(proc, signal.SIGTERM)
    assert proc.returncode == 0
    from ml_audio_restoration_torch.ops.quant import load_scales_file

    assert set(load_scales_file(scales)) == {"denoiser"}


def test_cli_serve_data_parallel_raises(dn_stage, tmp_path):
    """`serve --data-parallel 2 --device cpu` shards the HTTP pipeline over
    a two-entry mesh of the CPU: /healthz lists both entries and a request
    is answered as the unsharded pipeline answers it (JAX
    tests/test_pipeline.py:181's bar). A mesh with a 'model' axis
    (sequence parallelism, from the library) restores as the unsharded
    pipeline does too, at that bar."""
    proc = _serve(tmp_path, dn_stage, "--data-parallel", "2")
    try:
        ports = _announced(_lines(proc), ("http",))
        health = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{ports['http']}/healthz", timeout=TIMEOUT))
        assert health["devices"] == ["cpu", "cpu"]
        t = np.arange(SR // 2) / SR
        sig = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        got, rate = restore_over_http("127.0.0.1", ports["http"],
                                      encode_wav(sig[:, None], SR,
                                                 subtype="FLOAT"),
                                      subtype="FLOAT", timeout=TIMEOUT)
    finally:
        _stop(proc, signal.SIGINT)
    assert proc.returncode == 0
    pipe = RestorationPipeline.from_checkpoints(
        denoiser_path=tmp_path / "dn.pth", device="cpu")
    want, _ = pipe.restore(normalize_audio(sig[None]), SR)
    assert rate == SR
    np.testing.assert_allclose(got, normalize_audio(want.numpy()),
                               atol=2e-5, rtol=1e-4)
    plain, _ = pipe.restore(sig, SR)
    pipe.mesh = make_mesh(1, model_parallel=2, devices=["cpu"] * 2)
    assert pipe.mesh == Mesh(((torch.device("cpu"),) * 2,))
    seq, _ = pipe.restore(sig, SR)
    np.testing.assert_allclose(seq.numpy(), plain.numpy(), atol=2e-5,
                               rtol=1e-4)
