"""Network serving daemon: HTTP batch restore + TCP PCM streaming.

Counterpart of ml_audio_restoration_tpu/pipeline/server.py: the same
routes, status codes, JSON keys, Prometheus names and wire formats, over
the port's two serving engines:

- `RestorationServer`: an HTTP service (stdlib http.server) exposing
  `POST /v1/restore` (audio in -> restored WAV out), `POST /v1/reload`,
  `GET /healthz`, `/v1/stats`, `/metrics`, the console page and the
  WebSocket upgrade at `/v1/stream`. One device-worker thread launches the
  restores while handler threads decode, copy back and encode, so host
  work for request i+1 overlaps the device program of request i. The
  worker never waits for the device: after launching a program it starts
  the output's copy into pinned host memory and records a CUDA event
  behind it (restore.py::_to_host), and the handler waits on that event.
  On one stream the copy runs right after its own program, ahead of the
  next one the worker launches, so a response never waits for a later
  request's program. Bounded queue -> 503 backpressure.

- `StreamServer`: a raw-TCP streaming frontend over the batched
  `StreamingRestorer` (streaming.py): each connection is one lockstep
  stream slot; a block clock feeds all active slots through one
  `feed` per tick. Protocol = the `stream` CLI's pipe mode over a socket:
  the client writes raw mono PCM at the model rate, half-closes when done,
  and reads restored interleaved PCM (channels x rate x upscale) until the
  server closes.

The HTTP worker and the stream clock both launch on the default stream of
the one device, which serializes their programs there; every tensor they
make names the device of its pipeline or restorer, since the current CUDA
device is per thread, and their tensor code runs under
`torch.inference_mode()`, which is per thread too.
"""
from __future__ import annotations

import json
import queue
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import numpy as np
import torch


# --------------------------------------------------------------------- HTTP

def _decode_body(body: bytes):
    """Decode an HTTP audio body by magic bytes -> ([T, C] float32, rate).

    WAV decodes in memory; FLAC / Ogg / MP3 go through the package codecs
    (audio/io.py::_read_any: the C++ codec for FLAC, the system mpg123 /
    vorbisfile for mp3/ogg) via a temp file, since those readers are
    seek-based. Raises ValueError on an unrecognized container."""
    from ..audio import decode_wav

    if body[:4] == b"RIFF":
        return decode_wav(body)
    if body[:4] == b"fLaC":
        suffix = ".flac"
    elif body[:4] == b"OggS":
        suffix = ".ogg"
    elif body[:3] == b"ID3" or (len(body) > 1 and body[0] == 0xFF
                                and (body[1] & 0xE0) == 0xE0):
        suffix = ".mp3"
    else:
        raise ValueError("unrecognized audio container (expected WAV, "
                         "FLAC, Ogg or MP3 magic bytes)")
    import os
    import tempfile

    from ..audio.io import _read_any

    fd, tmp = tempfile.mkstemp(suffix=suffix, prefix="mlar_body_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(body)
        return _read_any(tmp)
    finally:
        os.unlink(tmp)


class _Job:
    """One restore: `out` is the output's host tensor, valid once `copied`
    (its CUDA event; None on the CPU) has completed. `host_out`, when
    given, is the pinned buffer the output is copied into."""

    __slots__ = ("audio", "sample_rate", "event", "out", "rate", "error",
                 "copied", "host_out")

    def __init__(self, audio, sample_rate, host_out=None):
        self.audio = audio
        self.sample_rate = sample_rate
        self.event = threading.Event()
        self.out = None
        self.rate = None
        self.error = None
        self.copied = None
        self.host_out = host_out


class _ReloadJob:
    """Hot checkpoint swap, applied ON the worker thread so it serializes
    with in-flight restores (the pipeline's stages are only ever read and
    written there). `stages`: {stage_name: checkpoint_path}."""

    __slots__ = ("stages", "event", "loaded", "error")

    def __init__(self, stages):
        self.stages = stages
        self.event = threading.Event()
        self.loaded = None
        self.error = None


class RestorationServer:
    """HTTP serving over one `RestorationPipeline`.

    POST /v1/restore          body: an audio file (WAV / FLAC / Ogg / MP3,
                              sniffed by magic bytes) -> 200: restored WAV
        query params: normalize=0   skip input RMS normalization
                      subtype=FLOAT|PCM_16|PCM_24   output encoding
    POST /v1/reload           body: {"denoiser": path, ...}: hot checkpoint
                              swap, applied between restore batches
    GET  /healthz             liveness, loaded stages, the device
    GET  /v1/stats            request counters / throughput / queue depth
    GET  /metrics             the same counters in Prometheus text format

    The handler threads (one per in-flight request, stdlib threading
    server) decode + resample + normalize on the host, then enqueue the job
    for the single device worker. The worker only launches: it runs
    `pipeline.restore` (which returns as soon as the program is queued on
    the card), starts the output's copy to pinned host memory, records an
    event after it and picks up the next job. The handler waits on that
    event, so the worker is already launching request i+1 while request
    i's output transfers and encodes.

    Dynamic batching: when requests have queued up behind a busy device,
    the worker drains up to `max_coalesce` of them and serves the batch
    through ONE device program (`pipeline.restore_many`): short requests
    stop paying per-request chunk-bucket padding and launches. An idle
    server never waits to batch, so single-request latency is unchanged,
    and each coalesced response is its solo response up to the
    convolutions' batch-size-dependent summation order (restore_many's
    contract).
    """

    def __init__(self, pipeline, host: str = "127.0.0.1", port: int = 0,
                 max_queue: int = 8, max_body_bytes: int = 512 << 20,
                 request_timeout: float = 600.0, quiet: bool = True,
                 max_coalesce: int = 4,
                 stream_addr: tuple[str, int] | None = None,
                 socket_timeout: float = 120.0):
        self.pipeline = pipeline
        # (host, port) of a StreamServer: enables GET /v1/stream WebSocket
        # upgrades bridged to it (pipeline/ws.py), so browsers reach the
        # lockstep streaming engine
        self.stream_addr = stream_addr
        self._queue: "queue.Queue[_Job]" = queue.Queue(maxsize=max_queue)
        self._max_coalesce = max(1, int(max_coalesce))
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "errors": 0, "rejected": 0,
                       "coalesced": 0, "reloads": 0,
                       "audio_seconds_in": 0.0, "busy_seconds": 0.0}
        self._max_body = max_body_bytes
        self._timeout = request_timeout
        self._socket_timeout = socket_timeout
        self._started = time.monotonic()
        self._stopping = False
        # serializes "check _stopping then enqueue" against "set _stopping
        # then enqueue the sentinel": without it a handler could check the
        # flag, get descheduled, and land its job behind the sentinel after
        # the worker's final sweep, stranding the client until the 504
        self._put_lock = threading.Lock()
        # restore handlers still transferring/encoding a response (the
        # worker's event fires at launch; the copy wait and the encode
        # happen on the handler)
        self._inflight = 0
        # optional callable returning a dict merged into /v1/stats under
        # "stream" (cli serve points it at StreamServer.stats so one scrape
        # covers both frontends)
        self.extra_stats = None

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # per-recv/send socket timeout (BaseRequestHandler.setup applies
            # it to the connection). Bounds every blocking body read: a
            # client that declares more Content-Length than it sends and
            # holds the socket open would otherwise pin a handler thread
            # forever. http.server's handle_one_request catches the
            # resulting socket.timeout and closes the connection. Cleared
            # on WebSocket upgrade, whose long-lived idle connections are
            # policed by TCP keepalive instead (ws.bridge_to_tcp).
            timeout = socket_timeout

            def log_message(self, fmt, *args):  # noqa: N802
                if not quiet:
                    BaseHTTPRequestHandler.log_message(self, fmt, *args)

            def do_GET(self):  # noqa: N802
                server._handle_get(self)

            def do_POST(self):  # noqa: N802
                server._handle_post(self)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._worker = threading.Thread(target=self._worker_loop,
                                        daemon=True, name="restore-worker")
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http-accept")

    # ------------------------------------------------------------ lifecycle
    def start(self):
        self._worker.start()
        self._http_thread.start()
        return self

    def shutdown(self, drain: bool = True):
        """Stop accepting, then (drain=True) wait for every already-queued
        restore to complete AND its response to be written, so a
        supervisor-driven stop never discards accepted work. Requests
        arriving during shutdown get 503."""
        with self._put_lock:
            # flag + sentinel under the enqueue lock: every handler either
            # saw _stopping (503) or enqueued ahead of the sentinel (served)
            self._stopping = True
            self._queue.put(None)
        self._httpd.shutdown()
        self._httpd.server_close()
        if drain and self._worker.is_alive():
            # the worker serves everything queued ahead of the sentinel,
            # fails anything behind it, then exits
            self._worker.join(timeout=self._timeout)
            if self._worker.is_alive():
                import warnings

                warnings.warn("shutdown drain timed out with restores "
                              "still running; their responses may be lost")
        if drain:
            # the worker's event fires at LAUNCH; handler threads still pay
            # the copy wait + encode + socket write: wait for those too
            # (bounded: a response write can't outlive the socket for long)
            deadline = time.monotonic() + min(self._timeout, 60.0)
            while time.monotonic() < deadline:
                with self._stats_lock:
                    if self._inflight == 0:
                        break
                time.sleep(0.02)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # --------------------------------------------------------------- worker
    def _job(self, audio, sample_rate) -> _Job:
        """The job of a mono [1, T] recording. On the card its input and
        output live in pinned host memory, allocated here on the handler
        thread: the worker's upload and copy back then queue on the stream
        without waiting for the programs before them (an upload from
        pageable memory would), and it allocates no pinned memory itself."""
        p = self.pipeline
        if p.device.type != "cuda":
            return _Job(audio, sample_rate)
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
        out = torch.empty((p.out_channels, x.shape[-1] * p.upscale_factor),
                          pin_memory=True)
        return _Job(x.pin_memory(), sample_rate, out)

    def _drain(self, first: _Job):
        """Dynamic batching: sweep whatever is already queued (up to
        max_coalesce) into one batch for `pipeline.restore_many`. No wait:
        an idle server keeps single-request latency; only requests that
        were going to queue anyway get coalesced. Returns (jobs, reload,
        saw_stop); a shutdown sentinel ends the loop after this batch
        completes."""
        jobs, reload_job, saw_stop = [first], None, False
        while len(jobs) < self._max_coalesce:
            try:
                j = self._queue.get_nowait()
            except queue.Empty:
                break
            if j is None:
                saw_stop = True
                break
            if isinstance(j, _ReloadJob):
                # don't mix a weight swap into a restore batch: hold it
                # aside and apply it right after this batch. Held aside,
                # NOT re-queued: a blocking put-back into a full queue
                # would deadlock the worker, the queue's only consumer.
                reload_job = j
                break
            jobs.append(j)
        return jobs, reload_job, saw_stop

    def _run_jobs(self, jobs):
        """Launch one drained batch and the copies of its outputs to host
        memory; never waits for the device (the handlers wait on the copy
        event), so the worker is already on the next batch while this
        one's outputs transfer and encode. `busy_seconds` is launch time.
        A batch-level failure fails every member (each handler gets the
        same 500)."""
        from .restore import _to_host

        t0 = time.monotonic()
        try:
            with torch.inference_mode():
                if len(jobs) == 1:
                    outs = [self.pipeline.restore(jobs[0].audio,
                                                  jobs[0].sample_rate)]
                else:
                    # all jobs arrive resampled to the pipeline rate
                    outs = self.pipeline.restore_many(
                        [j.audio for j in jobs], jobs[0].sample_rate)
                into = [j.host_out for j in jobs]
                host, copied = _to_host(
                    outs, None if any(b is None for b in into) else into)
            for j, (o, r) in zip(jobs, host):
                j.out, j.rate, j.copied = o, r, copied
        except Exception as e:  # surfaced as a 500 on the handler(s)
            for j in jobs:
                j.error = e
        with self._stats_lock:
            self._stats["busy_seconds"] += time.monotonic() - t0
            if len(jobs) > 1:
                self._stats["coalesced"] += len(jobs)
        for j in jobs:
            j.event.set()

    def _apply_reload(self, job: _ReloadJob):
        """Swap stage checkpoints (RestorationPipeline.reload_stages: onto
        the pipeline's device, its cached models and int8 calibration
        dropped, so the next request runs the new weights)."""
        try:
            job.loaded = self.pipeline.reload_stages(job.stages)
            with self._stats_lock:
                self._stats["reloads"] += 1
        except Exception as e:
            job.error = e
        job.event.set()

    def _fail_pending(self):
        """Exit path: a handler that raced its enqueue in behind the
        shutdown sentinel must get an immediate error, not a full
        request_timeout 504 (its event would otherwise never be set)."""
        while True:
            try:
                j = self._queue.get_nowait()
            except queue.Empty:
                return
            if j is None:
                continue
            j.error = RuntimeError("server is shutting down")
            j.event.set()

    def _worker_loop(self):
        while True:
            job = self._queue.get()
            if job is None:
                if self._stopping:
                    self._fail_pending()
                    return
                continue
            if isinstance(job, _ReloadJob):
                self._apply_reload(job)
                continue
            jobs, reload_job, saw_stop = self._drain(job)
            self._run_jobs(jobs)
            if reload_job is not None:
                self._apply_reload(reload_job)
            if saw_stop and self._stopping:
                self._fail_pending()
                return

    # ------------------------------------------------------------- handlers
    def _json(self, h, code: int, payload: dict,
              extra_headers: tuple = ()):
        try:
            body = json.dumps(payload).encode()
            h.send_response(code)
            h.send_header("Content-Type", "application/json")
            for name, value in extra_headers:
                h.send_header(name, value)
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        except OSError:
            # client hung up before the response: nothing to tell it, and
            # a dead socket must not take the handler thread down noisily
            h.close_connection = True

    # how much unread request body _reject will drain before the close:
    # enough to unblock a mid-upload client's send() so the error response
    # isn't RST away, bounded so an abusive body can't pin the thread
    _REJECT_DRAIN = 1 << 20

    # response-body sendall slice (see _send_wav); class attribute so tests
    # can shrink it to exercise the slow-reader path quickly
    _SEND_SLICE = 1 << 20

    def _reject(self, h, code: int, payload: dict,
                unread: int | None = None):
        """Error response on a connection whose request body was not
        (fully) consumed. The unread bytes would desync HTTP/1.1
        keep-alive, so the connection must close, and saying so matters
        twice over: stdlib http.server never derives a `Connection: close`
        header from the close_connection flag (a pipelining client would
        keep sending), and an abrupt close() with unread data in the
        kernel buffer sends RST, discarding the very error response for a
        client still blocked mid-upload in send(). So: advertise the
        close, write the error, then drain a bounded slice of the body
        under a short timeout before the server closes the socket.

        `unread` = bytes known to remain (skips the drain when 0);
        None = unknown (bad/absent Content-Length, chunked) -> bounded.
        """
        h.close_connection = True
        try:
            self._json(h, code, payload,
                       extra_headers=(("Connection", "close"),))
            h.wfile.flush()
            left = (self._REJECT_DRAIN if unread is None
                    else min(unread, self._REJECT_DRAIN))
            if left > 0:
                # byte-bounded AND time-bounded: each read1 gets a fresh
                # 2 s window, so without the wall deadline a client
                # trickling one byte per 1.9 s could hold the loop for
                # ~1M iterations
                deadline = time.monotonic() + 5.0
                h.connection.settimeout(2.0)
                while left > 0 and time.monotonic() < deadline:
                    # read1: at most one recv, so a stalled client costs
                    # one 2 s timeout, not one per buffered-read refill
                    chunk = h.rfile.read1(min(left, 65536))
                    if not chunk:
                        break
                    left -= len(chunk)
        except OSError:
            pass

    @staticmethod
    def _content_length(h) -> int | None:
        """Parsed Content-Length, or None when unparseable/negative (both
        mean the body size, and thus the stream state, is unknowable)."""
        try:
            length = int(h.headers.get("Content-Length", "0"))
        except ValueError:
            return None
        return length if length >= 0 else None

    @classmethod
    def _unread_hint(cls, h) -> int | None:
        """How many request-body bytes remain unread, for _reject paths
        that never read any body. A chunked upload has no Content-Length,
        which must map to None (unknown -> bounded drain), NOT 0: a
        skipped drain would let the close RST the error response away
        from a client still mid-upload."""
        if h.headers.get("Transfer-Encoding"):
            return None
        return cls._content_length(h)

    def _devices(self) -> list:
        """The devices the pipeline serves on (every entry of its mesh, row
        by row, else its own device), each CUDA device with the card's
        name."""
        mesh = self.pipeline.mesh
        devs = [self.pipeline.device] if mesh is None else mesh.flat_devices
        return [f"{d} ({torch.cuda.get_device_name(d)})" if d.type == "cuda"
                else str(d) for d in devs]

    def _handle_get(self, h):
        path = urlparse(h.path).path
        if path in ("/", "/console"):
            # self-contained demo console (console.html beside this module):
            # restore a file or a synthetic tone, stream over WS, watch
            # stats; the browser-facing face of the same public API
            import pathlib

            body = (pathlib.Path(__file__).parent
                    / "console.html").read_bytes()
            h.send_response(200)
            h.send_header("Content-Type", "text/html; charset=utf-8")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        elif path == "/v1/stream":
            self._handle_ws_upgrade(h)
        elif path == "/healthz":
            p = self.pipeline
            stages = [n for n, m in
                      (("denoiser", p.denoiser),
                       ("super_resolution", p.super_resolution),
                       ("stereo", p.stereo)) if m is not None]
            self._json(h, 200, {
                "status": "ok",
                "stages": stages,
                "devices": self._devices(),
                "sample_rate": p.config.sample_rate,
                "output_rate": p.config.sample_rate * p.upscale_factor,
            })
        elif path == "/v1/stats":
            self._json(h, 200, self._snapshot_stats())
        elif path == "/metrics":
            # Prometheus text exposition (so the daemon drops into a
            # standard scrape config without an adapter)
            gauges = ("queue_depth", "uptime_seconds", "active_streams",
                      "rss_mb")
            flat = []
            for k, v in self._snapshot_stats().items():
                if isinstance(v, dict):  # the nested "stream" block
                    flat.extend((f"{k}_{k2}", v2) for k2, v2 in v.items())
                else:
                    flat.append((k, v))
            lines = []
            for k, v in flat:
                kind = ("gauge" if any(k.endswith(g) for g in gauges)
                        else "counter")
                lines.append(f"# TYPE mlar_{k} {kind}")
                lines.append(f"mlar_{k} {v}")
            body = ("\n".join(lines) + "\n").encode()
            h.send_response(200)
            h.send_header("Content-Type",
                          "text/plain; version=0.0.4; charset=utf-8")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        else:
            self._json(h, 404, {"error": f"no such path: {path}"})

    def _handle_ws_upgrade(self, h):
        """GET /v1/stream with Upgrade: websocket: bridge the connection to
        the TCP stream server (pipeline/ws.py). 503 when no stream backend
        is configured; 400 on a non-upgrade request."""
        from . import ws

        if self.stream_addr is None:
            self._json(h, 503, {"error": "streaming is not enabled on "
                                         "this server (--stream-port)"})
            return
        if (h.headers.get("Upgrade", "").lower() != "websocket"
                or not h.headers.get("Sec-WebSocket-Key")):
            self._json(h, 400, {"error": "/v1/stream is a WebSocket "
                                         "endpoint (send Upgrade: "
                                         "websocket)"})
            return
        accept = ws.accept_key(h.headers["Sec-WebSocket-Key"])
        h.close_connection = True
        # lift the HTTP per-recv socket timeout: a WS stream may sit idle
        # between blocks for longer than any HTTP read should. Dead peers
        # are caught by the keepalive probes bridge_to_tcp arms; alive
        # peers that stop READING are caught by its SO_SNDTIMEO send
        # bound (keepalive can't see those: zero-window probes are acked)
        h.connection.settimeout(None)
        h.wfile.write(b"HTTP/1.1 101 Switching Protocols\r\n"
                      b"Upgrade: websocket\r\n"
                      b"Connection: Upgrade\r\n"
                      b"Sec-WebSocket-Accept: " + accept.encode()
                      + b"\r\n\r\n")
        h.wfile.flush()
        with self._stats_lock:
            self._stats["ws_streams"] = self._stats.get("ws_streams", 0) + 1
        ws.bridge_to_tcp(h, *self.stream_addr,
                         send_timeout=self._socket_timeout)

    def _snapshot_stats(self) -> dict:
        with self._stats_lock:
            stats = dict(self._stats)
        stats["queue_depth"] = self._queue.qsize()
        stats["uptime_seconds"] = time.monotonic() - self._started
        try:  # resident set size, for ops dashboards / leak watch
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        stats["rss_mb"] = round(int(line.split()[1])
                                                / 1024.0, 1)
                        break
        except OSError:
            pass
        if self.extra_stats is not None:
            try:
                stats["stream"] = dict(self.extra_stats())
            except Exception:  # a dying stream server must not break stats
                pass
        return stats

    def _handle_post(self, h):
        path = urlparse(h.path).path
        if path == "/v1/reload":
            self._handle_reload(h)
            return
        if path != "/v1/restore":
            # a POST body may be attached; respond-and-close via _reject
            # so its unread bytes can't desync the keep-alive stream
            self._reject(h, 404, {"error": f"no such path: {path}"},
                         unread=self._unread_hint(h))
            return
        if self._stopping:
            # before the body read: a shutdown-window request must not pay
            # (or make the server pay) a multi-hundred-MB decode for a 503
            with self._stats_lock:
                self._stats["rejected"] += 1
            self._reject(h, 503, {"error": "server is shutting down"},
                         unread=self._unread_hint(h))
            return
        q = parse_qs(urlparse(h.path).query)
        if h.headers.get("Transfer-Encoding"):
            # http.server never decodes chunked bodies; reading `length`
            # bytes of chunk framing as audio would be garbage
            self._reject(h, 411, {"error": "chunked bodies are not "
                                           "supported; send Content-Length"})
            return
        length = self._content_length(h)
        if length is None:
            self._reject(h, 400, {"error": "bad Content-Length"})
            return
        if length == 0:
            # nothing unread: the connection is clean, keep-alive is fine
            self._json(h, 400, {"error": "empty body (send a WAV file)"})
            return
        if length > self._max_body:
            self._reject(h, 413, {"error": f"body {length} bytes exceeds "
                                           f"limit {self._max_body}"},
                         unread=length)
            return
        body = h.rfile.read(length)
        if len(body) != length:
            # short read = the client died (or lied) mid-body; a truncated
            # WAV can still decode, so this must not fall through to a
            # silent partial restore. read() returned short => EOF was
            # seen, so there is nothing left to drain
            self._reject(h, 400, {"error": f"incomplete body: got "
                                           f"{len(body)} of {length} "
                                           f"bytes"}, unread=0)
            return

        from ..audio import normalize_audio, resample

        try:
            data, sr_in = _decode_body(body)
        except Exception as e:  # malformed bodies raise ValueError or
            # struct.error: either way the client sent undecodable audio
            self._json(h, 400, {"error": f"cannot decode audio body: {e}"})
            with self._stats_lock:
                self._stats["errors"] += 1
            return

        audio = data.T.astype(np.float32)  # [C, T]
        if audio.shape[0] > 1:
            audio = audio.mean(axis=0, keepdims=True)
        target_sr = self.pipeline.config.sample_rate
        if sr_in != target_sr:
            audio = resample(audio, sr_in, target_sr)
        if q.get("normalize", ["1"])[0] not in ("0", "false"):
            audio = np.asarray(normalize_audio(audio))

        job = self._job(audio, target_sr)
        # flag-check + enqueue under the lock shutdown() uses for flag +
        # sentinel: a job can only enter the queue AHEAD of the sentinel
        # (served by the drain), never behind the worker's final sweep
        accepted = stopping = False
        with self._put_lock:
            if self._stopping:
                stopping = True
            else:
                try:
                    self._queue.put(job, timeout=0.05)
                    accepted = True
                except queue.Full:
                    pass
        if not accepted:
            with self._stats_lock:
                self._stats["rejected"] += 1
            self._json(h, 503,
                       {"error": "server is shutting down"} if stopping
                       else {"error": "server at capacity, retry later",
                             "queue_depth": self._queue.qsize()})
            return
        # accepted: count this handler as in-flight until the RESPONSE is
        # written (shutdown's drain waits on this, not just the worker:
        # the worker's event fires at launch, the copy wait and the encode
        # happen here)
        with self._stats_lock:
            self._inflight += 1
        try:
            if not job.event.wait(self._timeout):
                with self._stats_lock:
                    self._stats["errors"] += 1
                self._json(h, 504, {"error": "restore timed out"})
                return
            if job.error is not None:
                with self._stats_lock:
                    self._stats["errors"] += 1
                self._json(h, 500, {"error": f"{type(job.error).__name__}: "
                                             f"{job.error}"})
                return

            # wait for this job's own copy (queued right behind its
            # program, ahead of anything launched after it), then the
            # output normalization exactly like restore_file
            if job.copied is not None:
                job.copied.synchronize()
            restored = normalize_audio(job.out.numpy())
            return self._send_wav(h, q, job, restored, audio, target_sr)
        finally:
            with self._stats_lock:
                self._inflight -= 1

    def _handle_reload(self, h):
        """POST /v1/reload  body: {"denoiser": path, "super_resolution":
        path, "stereo": path} (any subset; .pth or JAX .msgpack). The swap
        happens on the worker thread between restore batches, so no
        request ever sees half-new weights; int8 calibration is discarded
        (it's weight-dependent)."""
        if h.headers.get("Transfer-Encoding"):
            self._reject(h, 411, {"error": "chunked bodies are not "
                                           "supported; send Content-Length"})
            return
        length = self._content_length(h)
        if length is None:
            # a negative length would make rfile.read(-1) block until
            # client EOF with no deadline: same rejection as unparseable
            self._reject(h, 400, {"error": "bad Content-Length"})
            return
        if length > (1 << 20):  # a stage->path map is tiny; don't let a
            # mislabeled upload (or abuse) buffer hundreds of MB here
            self._reject(h, 413, {"error": f"reload body {length} bytes "
                                           f"exceeds limit {1 << 20}"},
                         unread=length)
            return
        body = h.rfile.read(length)
        if len(body) != length:  # EOF mid-body: stream state unknowable
            self._reject(h, 400, {"error": f"incomplete body: got "
                                           f"{len(body)} of {length} "
                                           f"bytes"}, unread=0)
            return
        try:
            req = json.loads(body or b"{}")
        except ValueError:
            self._json(h, 400, {"error": "body must be JSON"})
            return
        known = ("denoiser", "super_resolution", "stereo")
        if (not isinstance(req, dict) or not req
                or not all(k in known and isinstance(v, str)
                           for k, v in req.items())):
            self._json(h, 400, {
                "error": "expected a non-empty JSON object mapping any of "
                         f"{known} to a checkpoint path"})
            return
        missing = [k for k in req if getattr(self.pipeline, k) is None]
        if missing:
            self._json(h, 400, {
                "error": f"stage(s) {missing} are disabled on this server; "
                         f"a hot reload can't enable new stages"})
            return
        job = _ReloadJob(dict(req))
        accepted = stopping = False
        with self._put_lock:  # same enqueue-vs-sentinel ordering as restore
            if self._stopping:
                stopping = True
            else:
                try:
                    self._queue.put(job, timeout=1.0)
                    accepted = True
                except queue.Full:
                    pass
        if not accepted:
            self._json(h, 503,
                       {"error": "server is shutting down"} if stopping
                       else {"error": "server at capacity, retry later"})
            return
        if not job.event.wait(self._timeout):
            self._json(h, 504, {"error": "reload timed out"})
            return
        if job.error is not None:
            self._json(h, 500, {"error": f"{type(job.error).__name__}: "
                                         f"{job.error}"})
            return
        self._json(h, 200, {"reloaded": job.loaded})

    def _send_wav(self, h, q, job, restored, audio, target_sr):
        from ..audio import encode_wav

        subtype = q.get("subtype", ["PCM_16"])[0]
        wav = encode_wav(restored.T, job.rate, subtype=subtype)
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["audio_seconds_in"] += audio.shape[1] / target_sr
        try:
            h.send_response(200)
            h.send_header("Content-Type", "audio/wav")
            h.send_header("Content-Length", str(len(wav)))
            h.send_header("X-Sample-Rate", str(job.rate))
            h.send_header("X-Channels", str(restored.shape[0]))
            h.end_headers()
            # write in slices: the per-connection socket timeout is the
            # TOTAL budget of one sendall, and wfile is unbuffered so one
            # write(wav) would be one sendall: a slow-but-alive client
            # pulling a large WAV slower than len(wav)/socket_timeout would
            # get a silently truncated response AFTER the restore
            # succeeded. Per-slice sendalls give a progressing client a
            # fresh window every slice while a fully stalled one still
            # times out within socket_timeout.
            view = memoryview(wav)
            step = self._SEND_SLICE
            for off in range(0, len(view), step):
                h.wfile.write(view[off:off + step])
        except OSError:
            # client hung up while its restore ran: the work is done, the
            # response has nowhere to go; don't let the dead socket dump a
            # traceback through handle_error for every impatient client
            h.close_connection = True


# ---------------------------------------------------------------- streaming

class _Conn:
    """Per-connection bounded outbox + writer thread.

    The block clock must NEVER block on a client's TCP window: one slow
    reader would stall the lockstep step for every other stream (head-of-
    line blocking). The clock therefore only *enqueues* payloads here; a
    dedicated writer thread per connection pays the blocking `sendall`.
    The outbox is bounded (`max_pending` bytes): a consumer that falls
    further behind than that is dropped (`dead`), the realtime-serving
    policy; unbounded buffering would turn one stuck client into unbounded
    host memory. The writer owns the socket's lifecycle from the moment
    the slot hands it over: `close_when_drained()` lets it flush
    everything already queued, then close, so a finished slot can be
    reused immediately while the old connection's tail is still in flight
    on its own thread."""

    __slots__ = ("sock", "cv", "outbox", "pending", "dead", "closing",
                 "over_limit", "drained_total", "thread")

    def __init__(self, sock, name: str):
        import collections

        self.sock = sock
        self.cv = threading.Condition()
        self.outbox = collections.deque()
        self.pending = 0      # queued bytes not yet handed to the kernel
        self.dead = False     # client unreachable or too slow: discard
        self.closing = False  # flush the outbox, then close
        self.over_limit = False  # dead specifically because it fell behind
        self.drained_total = 0   # bytes actually handed to the kernel: the
        #                          clock's progress signal for telling a
        #                          slow-but-alive reader from a dead one
        self.thread = threading.Thread(target=self._writer_loop,
                                       daemon=True, name=name)
        self.thread.start()

    def send(self, payload: bytes, max_pending: int) -> bool:
        """Enqueue without blocking. False = connection is (now) dead."""
        with self.cv:
            if self.dead:
                return False
            if self.pending + len(payload) > max_pending:
                self.dead = True
                self.over_limit = True
                self.outbox.clear()
                self.pending = 0
                self.cv.notify_all()
                return False
            self.outbox.append(payload)
            self.pending += len(payload)
            self.cv.notify_all()
            return True

    def close_when_drained(self):
        # bound the terminal flush: once the slot is gone, a client that
        # stops reading must not pin this writer thread forever. Kernel
        # send timeout (not a Python socket timeout, which would also
        # change recv semantics for the reader thread sharing the fd):
        # any single send() making no progress for 60 s raises, marking
        # the connection dead.
        import struct

        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                                 struct.pack("ll", 60, 0))
        except OSError:
            pass
        with self.cv:
            self.closing = True
            self.cv.notify_all()

    def _writer_loop(self):
        while True:
            with self.cv:
                while not (self.outbox or self.closing or self.dead):
                    self.cv.wait()
                if self.dead or (self.closing and not self.outbox):
                    break
                payload = self.outbox.popleft()
                self.pending -= len(payload)
            try:
                self.sock.sendall(payload)
            except OSError:
                with self.cv:
                    self.dead = True
                    self.outbox.clear()
                    self.pending = 0
                break
            with self.cv:
                self.drained_total += len(payload)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class _Slot:
    """One lockstep stream slot: connection state + sample accounting."""

    __slots__ = ("sock", "conn", "inbuf", "eof", "fed", "sent", "owed",
                 "underruns", "active", "needs_reset", "started", "skip")

    def __init__(self):
        self.active = False
        self.sock = None
        self.conn = None   # _Conn: the writer-side of the connection
        self.inbuf = bytearray()
        self.eof = False
        self.fed = 0       # timeline samples consumed into the restorer
        #                    (client samples + any underrun silence; the
        #                    silence occupies real output positions)
        self.sent = 0      # output samples forwarded to the client
        self.owed = None   # total output samples due (set at EOF)
        self.underruns = 0
        self.needs_reset = False
        self.started = False
        self.skip = 0      # emitted samples to drop before forwarding: a
        #                    slot joining mid-clock sees the batch's global
        #                    emission timeline, whose first (fed - emitted)
        #                    x f samples predate this stream's first sample


class StreamServer:
    """TCP streaming frontend over a batched StreamingRestorer.

    Each accepted connection takes one of the restorer's `batch` slots
    (a full house refuses further connections until a slot frees). A
    block-clock thread assembles a [batch, block] feed every tick: slots
    advance in lockstep through ONE `feed`, the amortization that makes
    many live streams cheaper than one restorer each.

    Tick policy: a tick fires as soon as every active, still-sending
    connection has a full block buffered (offline clients are therefore
    served as fast as the device allows), or when `tick_seconds` elapses;
    then a starved live client's missing samples are filled with silence
    and counted as an underrun, exactly how a realtime audio interface
    treats a dropout. `tick_seconds=None` waits indefinitely
    (deterministic; the test-suite mode). After a client half-closes, its
    slot keeps riding the clock on zero-fill until the final `lookahead`
    worth of output drains (the flush contract), then the server closes
    the connection.

    Sample format `fmt`: "f32le" | "s16le", both directions (input mono
    at the model rate; output interleaved channels at rate x upscale).

    Output isolation: the clock thread never writes to a socket; each
    connection gets a writer thread draining a bounded outbox
    (`max_outbox_bytes`). The slow-consumer policy is mode-dependent:

    - live mode (`tick_seconds` set): the clock never waits on a client;
      a consumer that falls further behind than the bound is dropped
      (stat `dropped_slow`) and its slot freed.
    - offline mode (`tick_seconds=None`): an outbox above high water
      (half the bound) pauses the clock (real backpressure, so a
      deliberately slow reader such as 1x-realtime playback paces the
      server instead of being dropped); but a consumer making ZERO drain
      progress for `drain_stall_seconds` is reaped so a dead client
      can't stall the other lockstep streams forever.

    `sndbuf` optionally caps SO_SNDBUF on accepted sockets so TCP
    autotuning can't hide multi-MB kernel buffering beyond the outbox
    budget.
    """

    def __init__(self, restorer, host: str = "127.0.0.1", port: int = 0,
                 block: int = 11025, fmt: str = "f32le",
                 tick_seconds: float | None = None, quiet: bool = True,
                 max_outbox_bytes: int = 32 << 20,
                 sndbuf: int | None = None,
                 drain_stall_seconds: float = 30.0):
        if fmt not in ("f32le", "s16le"):
            raise ValueError(f"fmt must be f32le|s16le, got {fmt!r}")
        self.restorer = restorer
        # round the block up to the restorer's alignment (the U-Net pooling
        # grid): a multiple-of-align block keeps every late-joining slot's
        # local timeline on the same grid phase as a fresh restorer, which
        # is what makes per-stream output match an independent restorer
        self.block = -(-int(block) // restorer._align) * restorer._align
        self.fmt = fmt
        self.dtype = np.dtype(np.float32 if fmt == "f32le" else np.int16)
        self.tick_seconds = tick_seconds
        self.quiet = quiet
        self.max_outbox_bytes = int(max_outbox_bytes)
        self.sndbuf = sndbuf  # SO_SNDBUF for accepted sockets (None = OS
        #                       default); bounds kernel-side buffered
        #                       latency so max_outbox_bytes is the real
        #                       slow-consumer budget
        self.drain_stall_seconds = float(drain_stall_seconds)
        self._slots = [_Slot() for _ in range(restorer.batch)]
        self._cv = threading.Condition()
        self._stopping = False
        self._stats = {"connections": 0, "refused": 0, "underruns": 0,
                       "ticks": 0, "samples_in": 0, "dropped_slow": 0}

        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="stream-accept")
        self._clock_thread = threading.Thread(
            target=self._clock_loop, daemon=True, name="stream-clock")

    # ------------------------------------------------------------ lifecycle
    def start(self):
        self._accept_thread.start()
        self._clock_thread.start()
        return self

    def shutdown(self):
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        try:
            self._listener.close()
        except OSError:
            pass
        for s in self._slots:
            if s.conn is not None:
                with s.conn.cv:
                    s.conn.dead = True
                    s.conn.cv.notify_all()
            if s.sock is not None:
                try:
                    s.sock.close()
                except OSError:
                    pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    def stats(self) -> dict:
        with self._cv:
            d = dict(self._stats)
            d["active_streams"] = sum(s.active for s in self._slots)
        return d

    # --------------------------------------------------------------- accept
    def _accept_loop(self):
        while not self._stopping:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            if self.sndbuf is not None:
                try:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                    self.sndbuf)
                except OSError:
                    pass
            with self._cv:
                idx = next((i for i, s in enumerate(self._slots)
                            if not s.active), None)
                if idx is None:
                    self._stats["refused"] += 1
                    try:
                        sock.close()
                    except OSError:
                        pass
                    continue
                slot = self._slots[idx]
                slot.__init__()  # reset accounting
                slot.active = True
                slot.sock = sock
                slot.conn = _Conn(sock, name=f"stream-write-{idx}")
                # the restorer's per-slot recurrent/conv state is zeroed by
                # the CLOCK thread right before this slot's first feed
                # (reset_stream must not race the in-flight device step:
                # only the clock thread touches the restorer)
                slot.needs_reset = True
                self._stats["connections"] += 1
                self._cv.notify_all()
            threading.Thread(target=self._read_loop, args=(idx, sock),
                             daemon=True, name=f"stream-read-{idx}").start()

    def _read_loop(self, idx: int, sock: socket.socket):
        slot = self._slots[idx]
        while True:
            try:
                buf = sock.recv(1 << 16)
            except OSError:
                buf = b""
            with self._cv:
                if not slot.active or slot.sock is not sock:
                    return
                if buf:
                    slot.inbuf.extend(buf)
                else:
                    slot.eof = True
                    # total output due: every real input sample yields
                    # upscale_factor output samples
                    whole = len(slot.inbuf) // self.dtype.itemsize
                    slot.owed = (slot.fed + whole) * self.restorer.f
                self._cv.notify_all()
                if not buf:
                    return

    # ---------------------------------------------------------------- clock
    def _ready(self):
        """A tick may fire when some slot is active AND every active,
        still-sending slot has a full block (or has hit EOF). In offline
        mode (tick_seconds=None) a congested outbox also holds the tick:
        that is the backpressure contract."""
        active = [s for s in self._slots if s.active]
        if not active:
            return False
        want = self.block * self.dtype.itemsize
        if not all(s.eof or len(s.inbuf) >= want for s in active):
            return False
        return self.tick_seconds is not None or not self._congested()

    def _congested(self):
        """Indices of active slots whose outbox is above high water (half
        the bound, so one tick's enqueue can never trip the drop backstop
        on a slot the clock just cleared for feeding)."""
        hw = self.max_outbox_bytes // 2
        return [i for i, s in enumerate(self._slots)
                if s.active and s.conn is not None
                and s.conn.pending > hw]

    def _reap_stalled(self, stall: dict):
        """Offline-mode congestion: track per-slot drain progress and drop
        any consumer that has made none for drain_stall_seconds (a live
        slow reader keeps draining; a dead one pins its outbox). Called
        with self._cv held."""
        cong = set(self._congested())
        now = time.monotonic()
        for i in sorted(cong):
            c = self._slots[i].conn
            with c.cv:
                drained = c.drained_total
            prev = stall.get(i)
            if prev is None or prev[0] != drained:
                stall[i] = (drained, now)
            elif now - prev[1] >= self.drain_stall_seconds:
                with c.cv:
                    c.dead = True
                    c.over_limit = True
                    c.outbox.clear()
                    c.pending = 0
                    c.cv.notify_all()
                self._stats["dropped_slow"] += 1
                self._close_slot_locked(i)
                stall.pop(i, None)
        for i in list(stall):
            if i not in cong:
                del stall[i]

    def _clock_loop(self):
        stall = {}  # slot index -> (drained_total snapshot, since)
        while True:
            with self._cv:
                deadline = (None if self.tick_seconds is None
                            else time.monotonic() + self.tick_seconds)
                while not self._stopping and not self._ready():
                    if not any(s.active for s in self._slots):
                        # fully idle: sleep until a connection arrives,
                        # then restart the tick timer
                        stall.clear()
                        self._cv.wait()
                        deadline = (None if self.tick_seconds is None else
                                    time.monotonic() + self.tick_seconds)
                        continue
                    if self.tick_seconds is None and self._congested():
                        # backpressure wait: poll for drain progress and
                        # reap consumers that are making none
                        self._reap_stalled(stall)
                        self._cv.wait(timeout=min(
                            0.25, max(0.05, self.drain_stall_seconds / 4)))
                    elif deadline is None:
                        self._cv.wait()
                    else:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break  # timed tick: starved slots get silence
                        self._cv.wait(timeout=left)
                if self._stopping:
                    return
                with torch.inference_mode():
                    for i, s in enumerate(self._slots):
                        if s.needs_reset:
                            self.restorer.reset_stream(i)
                            s.needs_reset = False
                feed, outputs = self._assemble_feed()
            # the device step runs OUTSIDE the lock so reads keep landing
            out = self.restorer.feed(feed)
            if out.ndim == 2:
                out = out[None]
            self._dispatch_output(out, outputs)

    def _assemble_feed(self):
        """Under the lock: consume up to one block per active slot
        (zero-filling shortfalls), return the [B, block] feed and the
        list of slots that expect output."""
        feed = np.zeros((len(self._slots), self.block), np.float32)
        receivers = []
        for i, s in enumerate(self._slots):
            if not s.active:
                continue
            if not s.started:
                # the restorer's emission lags its feeds by the lookahead
                # holdback; everything already in flight belongs to the
                # OTHER streams' timeline: this slot's samples begin at
                # the current global feed position
                s.skip = ((self.restorer._fed - self.restorer._emitted)
                          * self.restorer.f)
                s.started = True
            take = min(len(s.inbuf) // self.dtype.itemsize, self.block)
            if take:
                raw = bytes(s.inbuf[:take * self.dtype.itemsize])
                del s.inbuf[:take * self.dtype.itemsize]
                x = np.frombuffer(raw, self.dtype).astype(np.float32)
                if self.fmt == "s16le":
                    x /= 32768.0
                feed[i, :take] = x
            if take < self.block and not s.eof:
                s.underruns += 1
                self._stats["underruns"] += 1
            # pre-EOF, the whole block enters the stream's timeline (any
            # shortfall was filled with silence: a rendered dropout the
            # client is owed); post-EOF zero-fill is flush padding, not owed
            s.fed += take if s.eof else self.block
            self._stats["samples_in"] += take
            receivers.append(i)
        self._stats["ticks"] += 1
        return feed, receivers

    def _dispatch_output(self, out: np.ndarray, receivers):
        """Enqueue each receiving slot's new output samples on its
        connection's writer (never blocking the clock on a client's TCP
        window); close slots whose post-EOF drain is complete or whose
        consumer fell behind the outbox bound."""
        for i in receivers:
            s = self._slots[i]
            with self._cv:
                if not s.active:
                    continue
                conn = s.conn
                seg = out[i]  # [ch, m*f]
                # drop any pre-join samples, then cap at what the client
                # is owed (the EOF drain overshoots)
                drop = min(s.skip, seg.shape[1])
                s.skip -= drop
                seg = seg[:, drop:]
                total = seg.shape[1]
                limit = (s.owed - s.sent if s.owed is not None else total)
                n = max(0, min(total, limit))
                s.sent += total
                done = s.eof and s.owed is not None and s.sent >= s.owed
            if n > 0:
                inter = np.ascontiguousarray(seg[:, :n].T)  # [n, ch]
                if self.fmt == "s16le":
                    payload = np.clip(np.rint(inter * 32767.0), -32768,
                                      32767).astype("<i2").tobytes()
                else:
                    payload = inter.astype("<f4").tobytes()
                if not conn.send(payload, self.max_outbox_bytes):
                    # client gone or too slow to keep up: free the slot
                    done = True
                    if conn.over_limit:
                        with self._cv:
                            self._stats["dropped_slow"] += 1
            if done:
                self._close_slot(i)

    def _close_slot(self, idx: int):
        with self._cv:
            self._close_slot_locked(idx)

    def _close_slot_locked(self, idx: int):
        s = self._slots[idx]
        if not s.active:
            return
        conn, s.conn = s.conn, None
        s.sock, s.active = None, False
        s.inbuf.clear()
        self._cv.notify_all()
        # the writer thread flushes anything still queued, then closes the
        # socket on its own time: the slot is already reusable
        conn.close_when_drained()


# --------------------------------------------------------------- client lib

def restore_over_http(url_host: str, port: int, wav_bytes: bytes,
                      normalize: bool = True, subtype: str = "PCM_16",
                      timeout: float = 600.0):
    """Minimal client for RestorationServer (stdlib http.client): send WAV
    bytes, return (restored [C, T] float32, rate). Raises RuntimeError with
    the server's error message on non-200."""
    import http.client

    from ..audio import decode_wav

    conn = http.client.HTTPConnection(url_host, port, timeout=timeout)
    try:
        path = f"/v1/restore?subtype={subtype}"
        if not normalize:
            path += "&normalize=0"
        conn.request("POST", path, body=wav_bytes,
                     headers={"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"server returned {resp.status}: "
                               f"{body[:500].decode(errors='replace')}")
        data, rate = decode_wav(body)
        return data.T.astype(np.float32), rate
    finally:
        conn.close()


def stream_over_tcp(host: str, port: int, samples: np.ndarray,
                    fmt: str = "f32le", block: int = 4096,
                    channels: int = 1, timeout: float = 600.0):
    """Minimal client for StreamServer: stream mono `samples` (float32 at
    the model rate), half-close, collect the restored interleaved PCM ->
    [channels, T_out] float32. A writer thread feeds while the main thread
    reads, so large streams can't deadlock on TCP buffers."""
    dtype = np.dtype(np.float32 if fmt == "f32le" else np.int16)
    x = np.asarray(samples, np.float32).reshape(-1)
    if fmt == "s16le":
        payload = np.clip(np.rint(x * 32767.0), -32768,
                          32767).astype("<i2").tobytes()
    else:
        payload = x.astype("<f4").tobytes()

    sock = socket.create_connection((host, port), timeout=timeout)

    def write():
        try:
            for off in range(0, len(payload), block * dtype.itemsize):
                sock.sendall(payload[off:off + block * dtype.itemsize])
            sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    w = threading.Thread(target=write, daemon=True)
    w.start()
    chunks = []
    while True:
        try:
            buf = sock.recv(1 << 16)
        except OSError:
            break
        if not buf:
            break
        chunks.append(buf)
    w.join(timeout=timeout)
    sock.close()
    raw = b"".join(chunks)
    y = np.frombuffer(raw, dtype).astype(np.float32)
    if fmt == "s16le":
        y /= 32768.0
    return y.reshape(-1, channels).T  # de-interleave -> [ch, T_out]
