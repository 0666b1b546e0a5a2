"""The port's serving daemon, HTTP half (pipeline/server.py
RestorationServer, restore_over_http and `cli serve`): one counterpart of
each HTTP test of tests/test_server.py, the hot-reload regressions, and
the daemon against the JAX package's. `cli serve` is tested in
test_torch_server_stream.py, which has the time for its subprocesses.

The port's pipelines run on the CPU: the denoiser at full width with
0.25 s chunks, as the JAX tests' `_pipe`, on the JAX package's initial
weights (carried by compat/weights.py::state_dict_from_jax). Every socket,
join and wait has a timeout of its own and the servers take short socket
and request timeouts, so a hang fails the test instead of the run.

Bars:
- a response at the shape of a solo restore: `restore` + `normalize_audio`
  bit for bit (the same function on the same input);
- a coalesced member against its solo restore: MANY_TOL, restore_many's
  contract (the model stack runs on a larger chunk batch, and the CPU
  convolutions may sum in another order at another batch size);
- the port's daemon against the JAX package's daemon on the same body:
  1e-4 for the denoiser at full width (the model bar), 1e-3 for the three
  stages at test_torch_pipeline.SMALL widths (the chain bar).
"""
import ast
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ml_audio_restoration_tpu.config import PipelineConfig as JaxConfig
from ml_audio_restoration_tpu.models import denoiser as jax_denoiser
from ml_audio_restoration_tpu.pipeline import RestorationPipeline as JaxPipe
from ml_audio_restoration_tpu.pipeline import (
    RestorationServer as JaxServer)
from ml_audio_restoration_tpu.pipeline.server import _Job as JaxJob
from ml_audio_restoration_torch.audio import (decode_wav, encode_wav,
                                              normalize_audio, write_flac)
from ml_audio_restoration_torch.compat import save_pth, state_dict_from_jax
from ml_audio_restoration_torch.config import PipelineConfig
from ml_audio_restoration_torch.pipeline import (RestorationPipeline,
                                                 RestorationServer,
                                                 StreamingRestorer,
                                                 StreamServer)
from ml_audio_restoration_torch.pipeline.server import (_Job, _ReloadJob,
                                                        restore_over_http,
                                                        stream_over_tcp)
from test_torch_models import port_model
from test_torch_pipeline import CHAIN_BAR, CHUNKED, SMALL
from test_torch_serving import stages  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SR = 22050
TIMEOUT = 60.0     # every socket, join and wait of these tests
MANY_TOL = 1e-5    # a coalesced member vs its solo restore
MODEL_BAR = 1e-4   # one model, the port vs the JAX package


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run. The servers call torch
    from several threads of one process, each with an OpenMP team of its
    own, and beside the suite's other workers those teams' barriers stall
    on an oversubscribed CPU: the stream tests ran tens of times slower
    there than alone. Both sides of every comparison here run in this
    process, under the same setting."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def dn_stage():
    return jax_denoiser.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def sine():
    t = np.arange(int(1.5 * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * np.sin(2 * np.pi * 1450 * t)).astype(np.float32)


def _pipe(dn_stage, **cfg):
    config = PipelineConfig(chunk_seconds=0.25, overlap_seconds=0.02, **cfg)
    return RestorationPipeline(denoiser=port_model("denoiser", *dn_stage),
                               config=config, device="cpu")


def _server(pipe, **kw):
    kw.setdefault("request_timeout", TIMEOUT)
    kw.setdefault("socket_timeout", TIMEOUT)
    return RestorationServer(pipe, **kw)


def _post(srv, body, **kw):
    return restore_over_http(srv.host, srv.port, body, timeout=TIMEOUT, **kw)


def _get(srv, path):
    return urllib.request.urlopen(f"http://{srv.host}:{srv.port}{path}",
                                  timeout=TIMEOUT)


def _open(req):
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _want(pipe, x, normalize=True):
    """What the daemon must answer for mono `x`: restore_file's contract,
    input normalization (optional), restore, output normalization."""
    audio = np.asarray(normalize_audio(x[None])) if normalize else x[None]
    out, _ = pipe.restore(audio, SR)
    return np.asarray(normalize_audio(out.numpy()), np.float32)


def _save_denoiser(path, stage):
    save_pth(path, "denoiser", state_dict_from_jax("denoiser", *stage))
    return path


def _reload(srv, payload):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/v1/reload",
        data=json.dumps(payload).encode(), method="POST")
    return json.load(_open(req))


# ------------------------------------------------------------------- codec

def test_wav_bytes_roundtrip(sine):
    buf = encode_wav(np.stack([sine, 0.5 * sine], axis=1), SR,
                     subtype="FLOAT")
    data, rate = decode_wav(buf)
    assert rate == SR
    np.testing.assert_array_equal(data[:, 0], sine)
    np.testing.assert_array_equal(data[:, 1], (0.5 * sine).astype(np.float32))


# -------------------------------------------------------------------- HTTP

def test_http_restore_matches_pipeline(dn_stage, sine):
    """POST /v1/restore == restore() + output normalization, bit for bit
    (FLOAT response subtype so the comparison isn't PCM-quantized)."""
    with _server(_pipe(dn_stage)) as srv:
        body = encode_wav(sine[:, None], SR, subtype="FLOAT")
        got, rate = _post(srv, body, subtype="FLOAT")
    assert rate == SR
    np.testing.assert_array_equal(got, _want(_pipe(dn_stage), sine))


def test_http_healthz_stats_and_errors(dn_stage, sine):
    with _server(_pipe(dn_stage)) as srv:
        health = json.load(_get(srv, "/healthz"))
        assert health["status"] == "ok"
        assert health["stages"] == ["denoiser"]
        assert health["sample_rate"] == SR
        assert health["devices"] == ["cpu"]  # the pipeline's device

        # bad body -> 400 with a JSON error
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/v1/restore", data=b"not a wav",
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            _open(req)
        assert err.value.code == 400
        assert "cannot decode" in json.load(err.value)["error"]

        # unknown path -> 404
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv, "/nope")
        assert err.value.code == 404

        # one good request, then stats reflect it
        _post(srv, encode_wav(sine[:, None], SR))
        stats = json.load(_get(srv, "/v1/stats"))
        assert stats["requests"] == 1
        assert stats["errors"] == 1  # the 400 above
        assert stats["audio_seconds_in"] == pytest.approx(1.5, abs=0.01)


def test_http_concurrent_requests_each_correct(dn_stage):
    """Three overlapping clients with different signals each get their own
    restoration. Requests that queue behind a busy worker are coalesced
    into one restore_many program, so each response is held to its solo
    restore at MANY_TOL (module docstring), not bit for bit."""
    t = np.arange(SR) / SR
    signals = [(0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
               for f0 in (180, 440, 900)]
    results = {}

    with _server(_pipe(dn_stage)) as srv:
        def post(i):
            body = encode_wav(signals[i][:, None], SR, subtype="FLOAT")
            results[i] = _post(srv, body, subtype="FLOAT")

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
        assert not any(th.is_alive() for th in threads)

    assert set(results) == {0, 1, 2}
    ref = _pipe(dn_stage)
    for i, sig in enumerate(signals):
        got, rate = results[i]
        assert rate == SR
        want = _want(ref, sig)
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= MANY_TOL


def test_http_accepts_flac_body(dn_stage, sine, tmp_path):
    """POST /v1/restore sniffs the container by magic bytes: a FLAC body
    (lossless) produces the same response as the equivalent 16-bit WAV,
    and garbage is a 400."""
    pcm16 = (np.clip(np.rint(sine * 32767.0), -32768, 32767)
             .astype(np.int16))
    flac_path = tmp_path / "in.flac"
    write_flac(flac_path, pcm16[:, None], SR, bits=16)
    flac_body = flac_path.read_bytes()
    wav_body = encode_wav((pcm16.astype(np.float32) / 32768.0)[:, None],
                          SR, subtype="FLOAT")

    with _server(_pipe(dn_stage)) as srv:
        got_flac, rate = _post(srv, flac_body, subtype="FLOAT")
        got_wav, _ = _post(srv, wav_body, subtype="FLOAT")
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/v1/restore",
            data=b"\x00not-audio\x00" * 10, method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            _open(req)
        assert exc.value.code == 400
    assert rate == SR
    np.testing.assert_array_equal(got_flac, got_wav)


def test_http_normalize_off(dn_stage, sine):
    """?normalize=0 skips INPUT normalization (output normalization is
    unconditional, matching restore_file's contract)."""
    with _server(_pipe(dn_stage)) as srv:
        body = encode_wav(sine[:, None], SR, subtype="FLOAT")
        got, _ = _post(srv, body, normalize=False, subtype="FLOAT")
    np.testing.assert_array_equal(
        got, _want(_pipe(dn_stage), sine, normalize=False))


def test_http_hot_reload_swaps_weights(dn_stage, sine, tmp_path):
    """POST /v1/reload swaps a stage's checkpoint between restore batches:
    the next response matches a pipeline built on the NEW weights, and bad
    requests (unknown stage / missing file / disabled stage) are
    4xx/5xx."""
    ckpt = _save_denoiser(tmp_path / "dn_new.pth",
                          jax_denoiser.init(jax.random.PRNGKey(42)))
    body = encode_wav(sine[:, None], SR, subtype="FLOAT")
    with _server(_pipe(dn_stage)) as srv:
        before, _ = _post(srv, body, subtype="FLOAT")
        assert _reload(srv, {"denoiser": str(ckpt)}) == {
            "reloaded": ["denoiser"]}
        after, _ = _post(srv, body, subtype="FLOAT")

        # error paths: unknown stage name, nonexistent file, disabled stage
        for payload, want_code in (
                ({"nonsense": "x"}, 400),
                ({}, 400),
                ({"denoiser": str(tmp_path / "missing.pth")}, 500),
                ({"stereo": str(ckpt)}, 400)):  # stereo disabled
            with pytest.raises(urllib.error.HTTPError) as exc:
                _reload(srv, payload)
            assert exc.value.code == want_code

        stats = json.load(_get(srv, "/v1/stats"))
        assert stats["reloads"] == 1

    fresh = RestorationPipeline.from_checkpoints(
        denoiser_path=ckpt, device="cpu",
        config=PipelineConfig(chunk_seconds=0.25, overlap_seconds=0.02))
    np.testing.assert_array_equal(after, _want(fresh, sine))
    assert not np.array_equal(before, after)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hot_reload_drops_the_cached_stage_models(dn_stage, sine, tmp_path,
                                                  dtype):
    """After a restore the pipeline serves its stages from `_copies` (in
    f32 the old modules themselves, in bf16 copies of them), so a reload that
    only set the attribute would keep serving the old weights: the
    response after /v1/reload must equal a fresh pipeline on the new
    checkpoint and differ from the old one, in both compute dtypes, and
    the new stage must lie on the pipeline's device in eval mode."""
    ckpt = _save_denoiser(tmp_path / "dn_new.pth",
                          jax_denoiser.init(jax.random.PRNGKey(7)))
    pipe = _pipe(dn_stage, compute_dtype=dtype)
    body = encode_wav(sine[:, None], SR, subtype="FLOAT")
    with _server(pipe) as srv:
        before, _ = _post(srv, body, subtype="FLOAT")
        # the stage models of this dtype
        assert getattr(torch, dtype) in {k[1] for k in pipe._copies.copies}
        assert _reload(srv, {"denoiser": str(ckpt)}) == {
            "reloaded": ["denoiser"]}
        after, _ = _post(srv, body, subtype="FLOAT")
    assert not pipe.denoiser.training
    assert {p.device for p in pipe.denoiser.parameters()} == {pipe.device}
    fresh = RestorationPipeline.from_checkpoints(
        denoiser_path=ckpt, device="cpu",
        config=PipelineConfig(chunk_seconds=0.25, overlap_seconds=0.02,
                              compute_dtype=dtype))
    np.testing.assert_array_equal(after, _want(fresh, sine))
    assert not np.array_equal(before, after)


def test_http_metrics_prometheus(dn_stage, sine):
    """GET /metrics exposes the stats counters in Prometheus text format."""
    with _server(_pipe(dn_stage)) as srv:
        _post(srv, encode_wav(sine[:, None], SR, subtype="FLOAT"))
        resp = _get(srv, "/metrics")
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    lines = text.strip().splitlines()
    assert "# TYPE mlar_requests_total counter" not in text  # raw names
    assert "# TYPE mlar_requests counter" in lines
    metrics = {ln.split()[0]: float(ln.split()[1])
               for ln in lines if not ln.startswith("#")}
    assert metrics["mlar_requests"] == 1.0
    assert metrics["mlar_queue_depth"] == 0.0
    assert metrics["mlar_uptime_seconds"] > 0


def test_http_stats_include_stream_block(dn_stage, sine):
    """With extra_stats wired (as cli serve does), /v1/stats gains a
    nested stream block and /metrics flattens it to mlar_stream_*."""
    restorer = StreamingRestorer(denoiser=port_model("denoiser", *dn_stage),
                                 batch=2, device="cpu")
    with StreamServer(restorer) as ssrv, _server(_pipe(dn_stage)) as hsrv:
        hsrv.extra_stats = ssrv.stats
        stream_over_tcp(ssrv.host, ssrv.port, sine[:4096], block=2048,
                        timeout=TIMEOUT)
        stats = json.load(_get(hsrv, "/v1/stats"))
        assert stats["stream"]["connections"] == 1
        assert "active_streams" in stats["stream"]
        met = _get(hsrv, "/metrics").read().decode()
        assert "mlar_stream_connections 1" in met
        assert "# TYPE mlar_stream_active_streams gauge" in met


def _coalesced(srv, job_cls, signals):
    """Drive one coalesced batch by hand (the server is never started, so
    the drain is deterministic): -> the jobs after _run_jobs."""
    jobs = [job_cls(s[None], SR) for s in signals]
    for j in jobs[1:]:
        srv._queue.put(j)
    batch, reload_job, saw_stop = srv._drain(jobs[0])
    assert batch == jobs and reload_job is None and not saw_stop
    srv._run_jobs(batch)
    return jobs


def _three_signals():
    t = np.arange(SR) / SR
    return [(0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
            for f0 in (200, 500, 950)]


def test_http_worker_coalesces_queued_requests(dn_stage):
    """Dynamic batching: queued jobs drain into ONE restore_many batch, and
    every member is its individual restore within MANY_TOL (module
    docstring: another chunk batch size)."""
    srv = _server(_pipe(dn_stage), max_coalesce=4)
    try:
        jobs = _coalesced(srv, _Job, _three_signals())
        assert srv._stats["coalesced"] == 3
        ref = _pipe(dn_stage)
        for j in jobs:
            assert j.error is None and j.event.is_set()
            assert j.copied is None  # the CPU: no copy event to wait on
            want, rate = ref.restore(j.audio, SR)
            assert j.rate == rate
            assert j.out.shape == want.shape
            assert float((j.out - want).abs().max()) <= MANY_TOL
    finally:
        srv._httpd.server_close()


def test_http_drain_respects_max_coalesce_and_stop(dn_stage):
    """The drain caps at max_coalesce and a shutdown sentinel ends it."""
    srv = _server(_pipe(dn_stage), max_coalesce=2, max_queue=8)
    try:
        jobs = [_Job(np.zeros((1, 100), np.float32), SR) for _ in range(3)]
        for j in jobs[1:]:
            srv._queue.put(j)
        batch, reload_job, saw_stop = srv._drain(jobs[0])
        assert batch == jobs[:2] and reload_job is None and not saw_stop
        srv._queue.put(None)  # shutdown sentinel behind job 3
        first = srv._queue.get(timeout=TIMEOUT)  # the worker's get
        assert first is jobs[2]
        batch2, reload2, saw_stop2 = srv._drain(first)
        assert batch2 == [jobs[2]] and reload2 is None and saw_stop2
    finally:
        srv._httpd.server_close()


def test_http_drain_holds_reload_aside_and_applies_after_batch(dn_stage,
                                                               tmp_path):
    """A reload drained mid-batch is held aside (never re-queued: a
    blocking put-back into a full queue would deadlock the worker) and
    applied right after the batch, even with the queue at capacity."""
    ck = _save_denoiser(tmp_path / "dn_held.pth",
                        jax_denoiser.init(jax.random.PRNGKey(7)))
    srv = _server(_pipe(dn_stage), max_coalesce=4, max_queue=3)
    try:
        jobs = [_Job(np.zeros((1, 100), np.float32), SR) for _ in range(2)]
        reload_job = _ReloadJob({"denoiser": str(ck)})
        # fill the queue completely: restore, reload, restore
        srv._queue.put(jobs[1])
        srv._queue.put(reload_job)
        srv._queue.put(_Job(np.zeros((1, 100), np.float32), SR))
        batch, held, saw_stop = srv._drain(jobs[0])
        assert batch == jobs and held is reload_job and not saw_stop
        # the reload was NOT re-queued: the trailing restore is still the
        # only queued item (a put-back ahead of it would reorder/deadlock)
        assert srv._queue.qsize() == 1
        srv._run_jobs(batch)
        assert all(j.error is None for j in batch)
        srv._apply_reload(held)
        assert held.error is None and held.loaded == ["denoiser"]
        assert held.event.is_set()
        assert srv._stats["reloads"] == 1
    finally:
        srv._httpd.server_close()


def test_http_shutdown_drains_accepted_work(dn_stage, sine):
    """shutdown() completes every accepted restore before returning (no
    504s on supervisor-driven stops), immediately fails a job that raced
    its enqueue in behind the shutdown sentinel, and 503s new requests
    once stopping."""
    pipe = _pipe(dn_stage)
    release = threading.Event()
    orig = pipe.restore

    def slow_restore(a, s):
        release.wait(TIMEOUT)
        return orig(a, s)

    pipe.restore = slow_restore
    # max_coalesce=1: jobs go through the (patched, blocking) single path
    # one at a time, so the queue state below is deterministic
    srv = _server(pipe, max_coalesce=1).start()
    body = encode_wav(sine[:, None], SR, subtype="FLOAT")
    results = {}

    def post(i):
        try:
            results[i] = _post(srv, body, subtype="FLOAT")
        except RuntimeError as e:
            results[i] = str(e)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        # wait until ALL THREE are accepted: one blocking the worker, two
        # queued
        deadline = time.monotonic() + 10
        while srv._queue.qsize() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv._queue.qsize() == 2

        # 503 gate: a request arriving once stopping is set is refused,
        # not queued behind the sentinel
        srv._stopping = True
        with pytest.raises(RuntimeError, match="503"):
            _post(srv, body)
        srv._stopping = False

        stopper = threading.Thread(target=srv.shutdown)
        stopper.start()
        # wait for the sentinel to actually land (httpd.shutdown() blocks
        # up to its poll interval first): queue is then [job1, job2, None]
        deadline = time.monotonic() + 10
        while srv._queue.qsize() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv._queue.qsize() == 3
        late = _Job(np.zeros((1, 100), np.float32), SR)
        srv._queue.put(late)  # raced in behind the sentinel
    finally:
        release.set()
    stopper.join(TIMEOUT)
    for t in threads:
        t.join(TIMEOUT)
    assert not stopper.is_alive() and not srv._worker.is_alive()
    assert not any(t.is_alive() for t in threads)
    # every ACCEPTED request completed with a real response
    assert all(isinstance(results[i], tuple) for i in range(3)), results
    assert late.event.wait(5)
    assert isinstance(late.error, RuntimeError)


def _recv_all(s) -> bytes:
    resp = b""
    while True:
        try:
            chunk = s.recv(65536)
        except OSError:
            break
        if not chunk:
            break
        resp += chunk
    return resp


def test_http_robustness_malformed_requests(dn_stage, sine):
    """The daemon survives protocol abuse: truncated bodies, lying
    Content-Length, oversized bodies, bogus methods/paths: each gets an
    orderly error (or a dropped connection), never a hang or a crash, and
    a well-formed request afterwards still succeeds."""
    with _server(_pipe(dn_stage), max_body_bytes=1 << 20) as srv:
        base = f"http://{srv.host}:{srv.port}"

        # Content-Length larger than the actual body: the read blocks
        # until the client closes; server must not crash
        s = socket.create_connection((srv.host, srv.port), timeout=30)
        s.sendall(b"POST /v1/restore HTTP/1.1\r\n"
                  b"Host: x\r\nContent-Length: 5000\r\n\r\nRIFFxxxx")
        s.close()  # truncate mid-body

        # body over max_body_bytes -> 413 without reading it all (urllib
        # may instead see the connection break while still writing)
        req = urllib.request.Request(f"{base}/v1/restore",
                                     data=b"\0" * ((1 << 20) + 1),
                                     method="POST")
        with pytest.raises(urllib.error.URLError) as err:
            _open(req)
        if isinstance(err.value, urllib.error.HTTPError):
            assert err.value.code == 413

        # negative / non-numeric Content-Length -> 400
        for cl in (b"-5", b"banana"):
            s = socket.create_connection((srv.host, srv.port), timeout=30)
            s.sendall(b"POST /v1/restore HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: " + cl + b"\r\n\r\n")
            resp = s.recv(4096)
            assert (b"400" in resp.split(b"\r\n", 1)[0]
                    or resp == b""), resp
            s.close()

        # bogus method
        s = socket.create_connection((srv.host, srv.port), timeout=30)
        s.sendall(b"BREW /v1/restore HTTP/1.1\r\nHost: x\r\n\r\n")
        resp = s.recv(4096)
        assert b"501" in resp.split(b"\r\n", 1)[0] or resp == b""
        s.close()

        # a WAV that lies about its data size (truncated payload)
        good = encode_wav(sine[:, None], SR, subtype="FLOAT")
        req = urllib.request.Request(f"{base}/v1/restore",
                                     data=good[: len(good) // 2],
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            _open(req)
        assert err.value.code == 400

        # after all of that, a clean request restores fine
        got, rate = _post(srv, good, subtype="FLOAT")
        assert rate == SR and np.isfinite(got).all()


def test_http_error_paths_keepalive_safe(dn_stage, sine):
    """Error responses on requests whose body was not consumed must close
    the connection (advertised via Connection: close), otherwise the
    unread body bytes get parsed as the next request on the keep-alive
    socket. And the error must actually REACH a client still mid-upload:
    the server drains a bounded slice of the body before closing so the
    kernel doesn't RST the response away."""
    with _server(_pipe(dn_stage), max_body_bytes=1 << 20) as srv:
        def send_and_read_all(payload: bytes) -> bytes:
            s = socket.create_connection((srv.host, srv.port), timeout=30)
            s.sendall(payload)
            resp = _recv_all(s)
            s.close()
            return resp

        # POST to an unknown path WITH a body: 404, Connection: close,
        # and the socket reaches EOF (the body can't desync a next req)
        body = b"x" * 1000
        resp = send_and_read_all(
            b"POST /v1/nope HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body) + body)
        head = resp.split(b"\r\n\r\n", 1)[0]
        assert b"404" in head.split(b"\r\n", 1)[0]
        assert b"connection: close" in head.lower()

        # mid-upload oversized body: the client is still sending when the
        # 413 is written; the bounded drain lets the response through
        s = socket.create_connection((srv.host, srv.port), timeout=30)
        big = (1 << 20) + 4096
        s.sendall(b"POST /v1/restore HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: %d\r\n\r\n" % big)
        sent = 0
        try:
            while sent < big:  # keep pushing body while the 413 lands
                s.sendall(b"\0" * 65536)
                sent += 65536
        except OSError:
            pass  # server closed after its bounded drain: fine
        resp = _recv_all(s)
        s.close()
        assert b"413" in resp.split(b"\r\n", 1)[0], resp[:200]

        # chunked transfer encoding: explicit 411 (http.server never
        # decodes chunked; reading framing bytes as audio would be junk)
        resp = send_and_read_all(
            b"POST /v1/restore HTTP/1.1\r\nHost: x\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n"
            b"4\r\nRIFF\r\n0\r\n\r\n")
        assert b"411" in resp.split(b"\r\n", 1)[0], resp[:200]

        # reload with negative Content-Length: immediate 400, never a
        # blocking rfile.read(-1) that pins the handler thread
        t0 = time.monotonic()
        resp = send_and_read_all(
            b"POST /v1/reload HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: -1\r\n\r\n")
        assert b"400" in resp.split(b"\r\n", 1)[0], resp[:200]
        assert time.monotonic() - t0 < 10

        # the server is still healthy
        good = encode_wav(sine[:, None], SR, subtype="FLOAT")
        got, rate = _post(srv, good, subtype="FLOAT")
        assert rate == SR and np.isfinite(got).all()


def test_http_socket_timeout_reclaims_stalled_upload(dn_stage, sine):
    """A client that declares more Content-Length than it sends and then
    just holds the socket open must not pin a handler thread forever: the
    per-connection socket timeout fires, the server drops the connection,
    and service continues."""
    with _server(_pipe(dn_stage), socket_timeout=1.0) as srv:
        s = socket.create_connection((srv.host, srv.port), timeout=30)
        s.sendall(b"POST /v1/restore HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: 100000\r\n\r\n" + b"\0" * 10)
        # stall: the handler blocks in rfile.read until its socket timeout
        s.settimeout(15)
        deadline = time.monotonic() + 15
        closed = False
        while time.monotonic() < deadline:
            try:
                if s.recv(4096) == b"":
                    closed = True
                    break
            except OSError:
                closed = True
                break
        s.close()
        assert closed, "server never reclaimed the stalled connection"

        good = encode_wav(sine[:, None], SR, subtype="FLOAT")
        got, rate = _post(srv, good, subtype="FLOAT")
        assert rate == SR and np.isfinite(got).all()


def test_http_large_response_survives_slow_reader(dn_stage):
    """The per-connection socket timeout is the TOTAL budget of one
    sendall, so a single-write response would be silently truncated for a
    slow-but-progressing client once the restore output outgrows
    socket_timeout x link rate. _send_wav writes in slices: a client
    making progress gets a fresh window per slice and must receive the
    COMPLETE body."""
    audio = (0.2 * np.sin(2 * np.pi * 330 * np.arange(12 * SR) / SR)
             ).astype(np.float32)
    wav_in = encode_wav(audio[:, None], SR, subtype="FLOAT")
    with _server(_pipe(dn_stage), socket_timeout=0.5) as srv:
        srv._SEND_SLICE = 1 << 16  # instance override: 64 KB slices
        s = socket.create_connection((srv.host, srv.port), timeout=60)
        # small receive buffer so the server's sendall actually blocks on
        # our read pace instead of the kernel swallowing the whole body
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 14)
        s.sendall(b"POST /v1/restore?subtype=FLOAT HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(wav_in) + wav_in)
        resp = b""
        s.settimeout(TIMEOUT)
        while b"\r\n\r\n" not in resp:  # headers (restore runs here)
            chunk = s.recv(1024)
            assert chunk, f"connection closed during headers: {resp[:200]}"
            resp += chunk
        head, body = resp.split(b"\r\n\r\n", 1)
        assert b"200" in head.split(b"\r\n", 1)[0], head[:200]
        length = int([ln for ln in head.split(b"\r\n")
                      if ln.lower().startswith(b"content-length")][0]
                     .split(b":")[1])
        assert length > 4 * (1 << 16)  # meaningfully larger than a slice
        while len(body) < length:  # deliberately slow, steady reader
            chunk = s.recv(1 << 15)
            if not chunk:
                break
            body += chunk
            time.sleep(0.1)
        s.close()
    assert len(body) == length, (f"truncated response: {len(body)} of "
                                 f"{length} bytes")
    got, rate = decode_wav(body)
    assert rate == SR and got.shape[0] == audio.shape[0]


def test_http_reject_drain_is_time_bounded(dn_stage):
    """_reject's body drain is bounded in TIME as well as bytes: a client
    trickling its body one byte per fresh read-timeout window must not
    hold the drain loop (and its handler thread) beyond the wall
    deadline."""
    with _server(_pipe(dn_stage)) as srv:
        s = socket.create_connection((srv.host, srv.port), timeout=30)
        s.sendall(b"POST /v1/nope HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: 1000000\r\n\r\n")
        t0 = time.monotonic()
        s.settimeout(0.3)
        closed = False
        while time.monotonic() - t0 < 20:
            try:
                s.sendall(b"\0")  # trickle: keeps each read1 window fresh
            except OSError:
                closed = True
                break
            try:
                if s.recv(4096) == b"":
                    closed = True
                    break
            except TimeoutError:
                pass
            except OSError:
                closed = True
                break
            time.sleep(0.2)
        s.close()
        took = time.monotonic() - t0
        assert closed, "drain loop never gave up on the trickling client"
        assert took < 15, f"drain held the connection {took:.1f}s"

        # the server is still healthy
        assert "requests" in json.load(_get(srv, "/v1/stats"))


def test_http_unread_hint_chunked_is_unknown(dn_stage):
    """A chunked upload has no Content-Length; the 404/503 reject paths
    must treat its unread size as UNKNOWN (bounded drain) rather than 0
    (no drain): a skipped drain lets the close RST the error response
    away from a mid-upload client."""
    with _server(_pipe(dn_stage)) as srv:
        class H:  # minimal handler stand-in: only .headers is consulted
            headers = {"Transfer-Encoding": "chunked"}
        assert srv._unread_hint(H) is None
        H.headers = {"Content-Length": "123"}
        assert srv._unread_hint(H) == 123
        H.headers = {}
        assert srv._unread_hint(H) == 0

        # behavioral: a chunked POST to an unknown path mid-upload still
        # receives its 404 (the bounded drain unblocks the client's send)
        s = socket.create_connection((srv.host, srv.port), timeout=30)
        s.sendall(b"POST /v1/nope HTTP/1.1\r\nHost: x\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n")
        try:
            for _ in range(8):
                s.sendall(b"8000\r\n" + b"\0" * 0x8000 + b"\r\n")
        except OSError:
            pass  # server closed after its drain: fine
        s.settimeout(15)
        resp = _recv_all(s)
        s.close()
        assert b"404" in resp.split(b"\r\n", 1)[0], resp[:200]


def test_http_console_page(dn_stage):
    """GET / (and /console) serves the self-contained demo console with
    the right content type; it references only same-origin endpoints that
    exist (no external assets, no build step)."""
    with _server(_pipe(dn_stage)) as srv:
        for path in ("/", "/console"):
            resp = _get(srv, path)
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/html")
            page = resp.read().decode()
        for marker in ("/v1/restore", "/v1/stream", "/v1/stats",
                       "/healthz", "new ArrayBuffer(0)"):
            assert marker in page, marker
        assert "http://" not in page.split("<body>")[1]  # same-origin only


def test_console_page_is_the_ports_own_file(dn_stage):
    """The page served is the port's own console.html, beside its
    server.py and in its package data; the server module names no path
    into the JAX package (an import scan would not see a file path)."""
    own = ROOT / "ml_audio_restoration_torch" / "pipeline" / "console.html"
    with _server(_pipe(dn_stage)) as srv:
        assert _get(srv, "/").read() == own.read_bytes()
    for name in ("server.py", "ws.py"):
        tree = ast.parse((own.parent / name).read_text())
        docs = {id(node.body[0].value) for node in ast.walk(tree)
                if isinstance(node, (ast.Module, ast.ClassDef,
                                     ast.FunctionDef))
                and node.body and isinstance(node.body[0], ast.Expr)}
        strings = [node.value for node in ast.walk(tree)
                   if isinstance(node, ast.Constant)
                   and isinstance(node.value, str) and id(node) not in docs]
        assert not [v for v in strings if "ml_audio_restoration_tpu" in v]
    assert ('"ml_audio_restoration_torch.pipeline" = ["console.html"]'
            in (ROOT / "pyproject.toml").read_text())


# ----------------------------------------------------- against the JAX one

def _parity_pipes(dn_stage, stages, case):  # noqa: F811
    """(JAX pipeline, port pipeline, bar) on the same weights."""
    if case == "denoiser":
        cfg = {"chunk_seconds": 0.25, "overlap_seconds": 0.02}
        return (JaxPipe(denoiser=dn_stage, config=JaxConfig(**cfg)),
                _pipe(dn_stage), MODEL_BAR)
    names = {"denoiser": "denoiser", "super_resolution": "super_resolution",
             "stereo_separator": "stereo"}
    jax_pipe = JaxPipe(**{names[n]: stages[n] for n in SMALL},
                       config=JaxConfig(**CHUNKED))
    port = RestorationPipeline(
        *(port_model(n, *stages[n]) for n in SMALL),
        config=PipelineConfig(**CHUNKED), device="cpu")
    return jax_pipe, port, CHAIN_BAR


@pytest.mark.parametrize("case", ["denoiser", "three_stages"])
def test_http_response_matches_jax_daemon(dn_stage, stages, sine,  # noqa: F811
                                          case):
    """The same WAV body POSTed to the JAX package's daemon and to the
    port's, both in-process: the responses agree within the bar."""
    jax_pipe, port, bar = _parity_pipes(dn_stage, stages, case)
    body = encode_wav(sine[:11025, None], SR, subtype="FLOAT")
    with JaxServer(jax_pipe, request_timeout=TIMEOUT,
                   socket_timeout=TIMEOUT) as jsrv:
        want, want_rate = _post(jsrv, body, subtype="FLOAT")
    with _server(port) as srv:
        got, rate = _post(srv, body, subtype="FLOAT")
    assert rate == want_rate
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= bar


@pytest.mark.parametrize("case", ["denoiser", "three_stages"])
def test_coalesced_batch_matches_jax_daemon(dn_stage, stages,  # noqa: F811
                                            case):
    """A coalesced batch of three, driven by hand through _drain /
    _run_jobs on both daemons: each member agrees within the bar."""
    jax_pipe, port, bar = _parity_pipes(dn_stage, stages, case)
    signals = [s[:11025] for s in _three_signals()]
    jsrv = JaxServer(jax_pipe, max_coalesce=4)
    srv = _server(port, max_coalesce=4)
    try:
        want = _coalesced(jsrv, JaxJob, signals)
        got = _coalesced(srv, _Job, signals)
    finally:
        jsrv._httpd.server_close()
        srv._httpd.server_close()
    assert jsrv._stats["coalesced"] == srv._stats["coalesced"] == 3
    for w, g in zip(want, got):
        assert g.error is None and w.error is None
        assert g.rate == w.rate
        w_out = np.asarray(w.out)
        assert tuple(g.out.shape) == w_out.shape
        assert float(np.abs(g.out.numpy() - w_out).max()) <= bar
