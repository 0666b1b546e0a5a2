"""The port's WebSocket support (pipeline/ws.py and the /v1/stream bridge
of RestorationServer): one counterpart of each WebSocket test of
tests/test_server.py, and the codec byte for byte against the JAX
package's ws.py.

Every socket, join and wait has a timeout of its own. A WebSocket stream
is a pure bridge to the TCP stream server, so it equals its TCP twin bit
for bit (the same restorer, the same slot arithmetic).
"""
import base64
import io
import json
import os
import socket
import struct
import time

import numpy as np
import pytest

from ml_audio_restoration_tpu.pipeline import ws as jax_ws
from ml_audio_restoration_torch.pipeline import StreamServer, ws
from ml_audio_restoration_torch.pipeline.server import stream_over_tcp
from test_torch_server_http import (TIMEOUT, _get, _pipe,  # noqa: F401
                                    _server, dn_stage, one_torch_thread,
                                    sine)
from test_torch_server_stream import _restorer

SIZES = (0, 1, 125, 126, 65535, 65536)  # the 7/16/64-bit length encodings


def _payload(n):
    return bytes(range(256)) * (n // 256) + bytes(range(n % 256))


def test_ws_frame_codec_roundtrip():
    """RFC 6455 frame codec: masked/unmasked, the 7/16/64-bit length
    encodings, and fragmented-message reassembly."""
    for n in SIZES:
        payload = _payload(n)
        for mask in (False, True):
            buf = io.BytesIO(ws.encode_frame(ws.BINARY, payload, mask=mask))
            fin, op, got = ws.read_frame(buf)
            assert fin and op == ws.BINARY and got == payload, (n, mask)

    # fragmentation: BINARY(fin=0) + CONT(fin=0) + CONT(fin=1)
    def frag(opcode, payload, fin):
        head = bytearray([(0x80 if fin else 0) | opcode, len(payload)])
        return bytes(head) + payload

    stream = (frag(ws.BINARY, b"ab", False) + frag(ws.CONT, b"cd", False)
              + frag(ws.CONT, b"ef", True)
              + ws.encode_frame(ws.CLOSE, struct.pack(">H", 1000)))
    buf = io.BytesIO(stream)
    op, msg = ws.read_message(buf)
    assert op == ws.BINARY and msg == b"abcdef"
    op, msg = ws.read_message(buf)
    assert op == ws.CLOSE


def test_ws_control_frame_mid_fragment_preserves_message():
    """RFC 6455 §5.4-5.5: a PING interleaved between the fragments of a
    data message is returned first and the fragments survive: the
    message reassembles on the next read."""
    def frag(opcode, payload, fin):
        return bytes([(0x80 if fin else 0) | opcode,
                      len(payload)]) + payload

    stream = (frag(ws.BINARY, b"ab", False)
              + ws.encode_frame(ws.PING, b"ka")
              + frag(ws.CONT, b"cd", False)
              + ws.encode_frame(ws.PONG, b"ka")
              + frag(ws.CONT, b"ef", True)
              + ws.encode_frame(ws.CLOSE, struct.pack(">H", 1000)))
    reader = ws.MessageReader(io.BytesIO(stream))
    assert reader.read() == (ws.PING, b"ka")
    assert reader.read() == (ws.PONG, b"ka")
    assert reader.read() == (ws.BINARY, b"abcdef")
    assert reader.read()[0] == ws.CLOSE


def test_ws_frame_and_message_size_limits():
    """A hostile declared length is rejected BEFORE allocation, and a
    fragmented message that grows past the bound is rejected too."""
    # 64-bit length header claiming 1 TB: ValueError, no payload read
    huge = bytes([0x80 | ws.BINARY, 127]) + (1 << 40).to_bytes(8, "big")
    with pytest.raises(ValueError, match="exceeds limit"):
        ws.read_frame(io.BytesIO(huge), max_frame=1 << 20)

    # fragments individually under the cap but 3 x 600 > 1024 total
    def frag(opcode, payload, fin):
        return (bytes([(0x80 if fin else 0) | opcode, 126])
                + struct.pack(">H", len(payload)) + payload)

    stream = (frag(ws.BINARY, b"x" * 600, False)
              + frag(ws.CONT, b"y" * 600, False)
              + frag(ws.CONT, b"z" * 600, True))
    reader = ws.MessageReader(io.BytesIO(stream), max_message=1024)
    with pytest.raises(ValueError, match="exceeds limit"):
        reader.read()


def test_ws_mask_vectorized_roundtrip():
    """The numpy-vectorized (un)masking path (>=1 KB payloads) matches
    the per-byte definition."""
    key = b"\x37\xfa\x21\x3d"
    for n in (1023, 1024, 4096, 65537):  # straddle the fast-path threshold
        payload = bytes((i * 31) & 0xFF for i in range(n))
        want = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        got = ws._apply_mask(payload, key)
        assert got == want
        assert ws._apply_mask(got, key) == payload


def test_ws_stream_matches_tcp(dn_stage, sine):
    """A WebSocket /v1/stream client gets output bit-identical to the raw
    TCP protocol (the WS endpoint is a pure bridge)."""
    block = 2048
    with StreamServer(_restorer(dn_stage, batch=2), block=block) as ssrv, \
            _server(_pipe(dn_stage), stream_addr=None) as hsrv:
        hsrv.stream_addr = (ssrv.host, ssrv.port)
        got_ws = ws.stream_over_ws(hsrv.host, hsrv.port, sine, block=block,
                                   timeout=TIMEOUT)
        got_tcp = stream_over_tcp(ssrv.host, ssrv.port, sine, block=block,
                                  timeout=TIMEOUT)
        stats = json.load(_get(hsrv, "/v1/stats"))
    assert got_ws.shape == (1, len(sine))
    np.testing.assert_array_equal(got_ws, got_tcp)
    assert stats["ws_streams"] == 1


def test_ws_handshake_errors(dn_stage):
    """Non-upgrade GET -> 400; WS upgrade without a stream backend -> 503;
    a ping mid-stream gets a pong."""
    import urllib.error

    with _server(_pipe(dn_stage)) as hsrv:
        # plain GET on the WS path (no backend configured) -> 503
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(hsrv, "/v1/stream")
        assert err.value.code == 503

        # backend configured but no Upgrade header -> 400
        hsrv.stream_addr = ("127.0.0.1", 1)  # never dialed for a 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(hsrv, "/v1/stream")
        assert err.value.code == 400

    # ping/pong on a live bridge
    with StreamServer(_restorer(dn_stage), block=1024) as ssrv, \
            _server(_pipe(dn_stage)) as hsrv:
        hsrv.stream_addr = (ssrv.host, ssrv.port)
        sock = socket.create_connection((hsrv.host, hsrv.port), timeout=60)
        key = base64.b64encode(b"fedcba9876543210").decode()
        sock.sendall((f"GET /v1/stream HTTP/1.1\r\n"
                      f"Host: {hsrv.host}:{hsrv.port}\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        rfile = sock.makefile("rb")
        assert b"101" in rfile.readline()
        while rfile.readline().strip():
            pass
        sock.sendall(ws.encode_frame(ws.PING, b"hello", mask=True))
        op, payload = ws.read_message(rfile)
        assert op == ws.PONG and payload == b"hello"
        # end-of-input marker on an empty stream -> server closes cleanly
        sock.sendall(ws.encode_frame(ws.BINARY, b"", mask=True))
        deadline = time.monotonic() + 60
        closed = False
        while time.monotonic() < deadline:
            op, payload = ws.read_message(rfile)
            if op == ws.CLOSE:
                assert struct.unpack(">H", payload[:2])[0] == 1000
                closed = True
                break
        sock.close()
        assert closed


def test_ws_nonreading_peer_is_dropped(dn_stage, monkeypatch):
    """An alive WebSocket peer that stops READING (backgrounded tab) acks
    keepalive probes forever, so only the SO_SNDTIMEO send bound can
    reclaim its bridge: once the pump's send makes no progress for
    socket_timeout, the bridge tears down and the peer's connection dies
    instead of pinning two threads indefinitely. The server-side send
    buffer is clamped so the output backlog needed is small."""
    orig_bridge = ws.bridge_to_tcp

    def small_sndbuf_bridge(handler, *a, **kw):
        handler.connection.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_SNDBUF, 1 << 14)
        return orig_bridge(handler, *a, **kw)

    monkeypatch.setattr(ws, "bridge_to_tcp", small_sndbuf_bridge)

    with StreamServer(_restorer(dn_stage, batch=2), block=8192) as ssrv, \
            _server(_pipe(dn_stage), socket_timeout=1.0) as hsrv:
        hsrv.stream_addr = (ssrv.host, ssrv.port)
        # warm the streaming windows first, so the non-reading phase below
        # measures buffer backpressure, not first-call costs
        ws.stream_over_ws(hsrv.host, hsrv.port, np.zeros(8192, np.float32),
                          block=8192, timeout=TIMEOUT)

        s = socket.socket()
        # tiny receive buffer: the server's WS sends hit a closed window
        # (and then its SO_SNDTIMEO) after ~tens of KB, not megabytes
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 14)
        s.settimeout(30)
        s.connect((hsrv.host, hsrv.port))
        s.sendall(b"GET /v1/stream HTTP/1.1\r\nHost: x\r\n"
                  b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
                  b"Sec-WebSocket-Version: 13\r\n\r\n")
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = s.recv(1024)
            assert chunk, "no 101 response"
            resp += chunk
        assert b"101" in resp.split(b"\r\n", 1)[0]

        # feed PCM forever, never read: restored output backs up through
        # the bridge into our closed receive window
        pcm = np.zeros(8192, np.float32).tobytes()
        frame = ws.encode_frame(ws.BINARY, pcm, mask=True)
        t0 = time.monotonic()
        dropped = False
        try:
            while time.monotonic() - t0 < 90:
                s.sendall(frame)
        except OSError:
            dropped = True
        s.close()
        assert dropped, ("bridge never dropped the non-reading peer "
                         "within 90s")


# ----------------------------------------------------- against the JAX one

def test_accept_key_matches_jax():
    for key in ("dGhlIHNhbXBsZSBub25jZQ==",
                base64.b64encode(b"0123456789abcdef").decode()):
        assert ws.accept_key(key) == jax_ws.accept_key(key)
    # RFC 6455 section 1.3's worked example
    assert (ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==")
            == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo=")


@pytest.mark.parametrize("n", SIZES)
def test_frames_match_jax_bytes(n, monkeypatch):
    """encode_frame unmasked and masked (a fixed key through os.urandom,
    which both modules read), _apply_mask, read_frame and MessageReader
    give the JAX package's bytes."""
    payload = _payload(n)
    key = b"\x9e\x01\xc3\x55"
    assert ws._apply_mask(payload, key) == jax_ws._apply_mask(payload, key)
    monkeypatch.setattr(os, "urandom", lambda k: key[:k])
    for opcode in (ws.BINARY, ws.PING, ws.CLOSE):
        for mask in (False, True):
            frame = ws.encode_frame(opcode, payload, mask=mask)
            assert frame == jax_ws.encode_frame(opcode, payload, mask=mask)
            assert (ws.read_frame(io.BytesIO(frame))
                    == jax_ws.read_frame(io.BytesIO(frame)))
    stream = (ws.encode_frame(ws.PING, b"ka", mask=True)
              + ws.encode_frame(ws.BINARY, payload, mask=True)
              + ws.encode_frame(ws.CLOSE, struct.pack(">H", 1000)))
    mine, theirs = (m.MessageReader(io.BytesIO(stream)) for m in (ws,
                                                                  jax_ws))
    for _ in range(3):
        assert mine.read() == theirs.read()
