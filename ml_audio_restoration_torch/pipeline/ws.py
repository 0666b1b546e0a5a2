"""Minimal RFC 6455 WebSocket support for the serving daemon.

Counterpart of ml_audio_restoration_tpu/pipeline/ws.py: the same functions,
the same bytes on the wire. Raw-TCP PCM streaming (`StreamServer`) covers
native clients, but browsers can only open WebSockets. This module
implements just enough of RFC 6455 (handshake, frame codec, ping/pong,
close) to bridge a browser to the same lockstep streaming engine:

    browser --ws--> RestorationServer /v1/stream --tcp--> StreamServer

The bridge is a thin per-connection proxy: binary WS messages carry raw
PCM in the stream protocol's format (mono samples at the model rate in;
interleaved restored channels out), so every StreamServer contract
(lockstep batching, per-stream equality with a direct restorer, underrun
accounting, slow-consumer policy) applies to WS clients unchanged. The
standard library and numpy only.
"""
from __future__ import annotations

import base64
import hashlib
import socket
import struct
import threading

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# opcodes
CONT, TEXT, BINARY, CLOSE, PING, PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA


def accept_key(client_key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key."""
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def _apply_mask(payload: bytes, key: bytes) -> bytes:
    """XOR `payload` with the repeating 4-byte mask `key` (RFC 6455 §5.3).

    Every browser payload arrives masked, so this runs on the bridge's
    hot input path: vectorize through numpy above a threshold (a Python
    per-byte loop caps a streaming client at a few MB/s)."""
    if len(payload) >= 1024:
        import numpy as np

        arr = np.frombuffer(payload, np.uint8)
        k = np.frombuffer(key * ((len(payload) + 3) // 4), np.uint8)
        return (arr ^ k[:len(payload)]).tobytes()
    return bytes(b ^ key[i % 4] for i, b in enumerate(payload))


def encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    """One FIN frame. Servers send unmasked; clients MUST mask."""
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < (1 << 16):
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        import os

        key = os.urandom(4)
        head += key
        payload = _apply_mask(payload, key)
    return bytes(head) + payload


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise EOFError("websocket peer closed mid-frame")
        buf += chunk
    return buf


def read_frame(rfile, max_frame: int | None = None):
    """-> (fin, opcode, payload) with masking removed. EOFError on EOF.

    `max_frame` bounds the DECLARED payload length BEFORE any allocation:
    a hostile 64-bit length header must not make the server try to buffer
    gigabytes (ValueError tears the connection down instead)."""
    b0, b1 = _read_exact(rfile, 2)
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", _read_exact(rfile, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", _read_exact(rfile, 8))
    if max_frame is not None and n > max_frame:
        raise ValueError(f"frame of {n} bytes exceeds limit {max_frame}")
    key = _read_exact(rfile, 4) if masked else None
    payload = _read_exact(rfile, n) if n else b""
    if key:
        payload = _apply_mask(payload, key)
    return fin, opcode, payload


class MessageReader:
    """Stateful message reassembler for one WebSocket connection.

    Control frames may legally arrive BETWEEN the fragments of a data
    message (RFC 6455 §5.4-5.5); they are returned as they arrive while
    the partial data fragments are retained for the next `read()` call —
    a stateless reader would silently drop the fragments and then choke
    on the resumed continuation frame. `max_message` bounds both the
    per-frame declared length and the reassembled message size."""

    def __init__(self, rfile, max_message: int = 16 << 20):
        self._rfile = rfile
        self._max = max_message
        self._op = None      # data opcode of the in-progress message
        self._parts = []     # its fragments so far
        self._size = 0

    def read(self):
        """-> (opcode, payload): the next control frame or complete
        (reassembled) data message."""
        while True:
            fin, op, payload = read_frame(self._rfile, self._max)
            if op in (CLOSE, PING, PONG):
                return op, payload
            if op == CONT:
                if self._op is None:
                    raise ValueError("continuation frame with no message "
                                     "in progress")
                self._parts.append(payload)
            else:
                if self._op is not None:
                    raise ValueError(f"data frame {op:#x} inside a "
                                     f"fragmented message")
                self._op, self._parts = op, [payload]
                self._size = 0
            self._size += len(payload)
            if self._size > self._max:
                raise ValueError(f"message exceeds limit {self._max}")
            if fin:
                op, parts = self._op, self._parts
                self._op, self._parts, self._size = None, [], 0
                return op, b"".join(parts)


def read_message(rfile):
    """One-shot `MessageReader.read()` — convenience for callers that
    know no control frame will interleave mid-fragment (fragment state
    does NOT survive across calls; hold a MessageReader for that)."""
    return MessageReader(rfile).read()


def bridge_to_tcp(handler, stream_host: str, stream_port: int,
                  max_message: int = 16 << 20,
                  send_timeout: float | None = 120.0):
    """Proxy an upgraded WebSocket connection to the TCP stream server.

    `handler` is the http.server request handler AFTER the 101 response
    has been written. Client->server binary messages are raw PCM fed to
    the TCP socket; TCP output comes back as binary messages. An EMPTY
    binary message is the end-of-input marker (the WS analogue of the TCP
    protocol's half-close): the server then drains the restorer's flush
    tail as further binary messages and finally sends CLOSE. A browser
    client therefore sends `new ArrayBuffer(0)` when done and keeps the
    socket open until the server's close event — calling ws.close()
    directly also works for non-browser clients, but browsers drop
    messages received after close(), losing the tail. Text messages are
    a protocol error (binary-only)."""
    try:
        # a silently-vanished browser (no CLOSE, no RST) would otherwise pin
        # this handler thread and its stream slot until the OS gives up on
        # the connection. SO_KEEPALIVE alone uses the kernel defaults
        # (~2h idle before the first probe on Linux) — tighten the probe
        # schedule so a dead peer frees its slot in ~2 minutes:
        # 60 s idle + 4 probes x 15 s.
        conn = handler.connection
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        for opt, val in (("TCP_KEEPIDLE", 60), ("TCP_KEEPINTVL", 15),
                         ("TCP_KEEPCNT", 4)):
            if hasattr(socket, opt):  # Linux; other OSes keep defaults
                conn.setsockopt(socket.IPPROTO_TCP,
                                getattr(socket, opt), val)
        # keepalive only detects DEAD peers — an alive browser that has
        # stopped READING (backgrounded tab) acks zero-window probes
        # forever while the pump's sendall blocks on the full send buffer,
        # pinning both bridge threads. SO_SNDTIMEO bounds each send()
        # syscall at the kernel level WITHOUT touching the Python-level
        # socket timeout, which must stay None: the read side legitimately
        # idles between PCM blocks for arbitrarily long. A send that makes
        # no progress for `send_timeout` raises (EAGAIN -> OSError), the
        # pump treats the peer as a non-consumer and tears the bridge down.
        if send_timeout is not None:
            sec = int(send_timeout)
            usec = int((send_timeout - sec) * 1e6)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack("ll", sec, usec))
    except OSError:
        pass
    try:
        tcp = socket.create_connection((stream_host, stream_port),
                                       timeout=600)
    except OSError:
        try:
            handler.wfile.write(encode_frame(
                CLOSE, struct.pack(">H", 1011) + b"stream backend down"))
        except OSError:
            pass
        return

    wlock = threading.Lock()  # pong + data frames share the WS socket

    def pump_tcp_to_ws():
        try:
            while True:
                buf = tcp.recv(1 << 16)
                if not buf:
                    break
                with wlock:
                    handler.wfile.write(encode_frame(BINARY, buf))
                    handler.wfile.flush()
            with wlock:
                handler.wfile.write(encode_frame(
                    CLOSE, struct.pack(">H", 1000)))
                handler.wfile.flush()
            # nothing more is expected from the client (its end-of-input
            # already arrived — that's what produced the tcp EOF), so
            # half-close our read side. This delivers EOF to the handler
            # thread blocked in reader.read() — which would otherwise
            # wait forever on a client that never echoes CLOSE — while
            # the kernel still drains our queued CLOSE frame to the
            # client, and a late CLOSE echo is discarded (acked, no RST)
            # rather than blowing up the connection like a full close
            # with unread data would.
            try:
                handler.connection.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        except OSError:
            # send timed out (SO_SNDTIMEO: peer alive but not consuming)
            # or the socket died. Either way the bridge is over — the
            # handler thread may still be blocked in reader.read() on this
            # very socket, so shut it down to deliver EOF there; leaving
            # it would pin the handler thread for as long as the silent
            # peer stays connected.
            try:
                handler.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    pump = threading.Thread(target=pump_tcp_to_ws, daemon=True,
                            name="ws-tcp-pump")
    pump.start()
    reader = MessageReader(handler.rfile, max_message)
    try:
        while True:
            op, payload = reader.read()
            if op == BINARY:
                if not payload:
                    break  # end-of-input marker: flush + close via pump
                tcp.sendall(payload)
            elif op == PING:
                with wlock:
                    handler.wfile.write(encode_frame(PONG, payload))
                    handler.wfile.flush()
            elif op == CLOSE:
                # client is done sending; don't echo yet — the pump sends
                # the final CLOSE after the flush tail (data between the
                # client's close and ours is legal per RFC 6455 §5.5.1)
                break
            elif op == PONG:
                continue
            else:  # TEXT or unknown: binary-only protocol
                break
    except (EOFError, ValueError, OSError):
        pass
    try:
        tcp.shutdown(socket.SHUT_WR)
    except OSError:
        pass
    pump.join(timeout=600)
    try:
        tcp.close()
    except OSError:
        pass


# ------------------------------------------------------------------ client

def stream_over_ws(host: str, port: int, samples, fmt: str = "f32le",
                   block: int = 4096, channels: int = 1,
                   timeout: float = 600.0, path: str = "/v1/stream"):
    """Minimal WS client mirroring server.stream_over_tcp: stream mono
    `samples`, close, collect restored PCM -> [channels, T_out] float32."""
    import numpy as np

    dtype = np.dtype(np.float32 if fmt == "f32le" else np.int16)
    x = np.asarray(samples, np.float32).reshape(-1)
    if fmt == "s16le":
        payload = np.clip(np.rint(x * 32767.0), -32768,
                          32767).astype("<i2").tobytes()
    else:
        payload = x.astype("<f4").tobytes()

    sock = socket.create_connection((host, port), timeout=timeout)
    key = base64.b64encode(b"0123456789abcdef").decode()
    sock.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                  "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    rfile = sock.makefile("rb")
    status = rfile.readline()
    if b"101" not in status:
        raise RuntimeError(f"handshake rejected: {status!r}")
    want_accept = accept_key(key).encode()
    got_accept = None
    while True:
        line = rfile.readline().strip()
        if not line:
            break
        k, _, v = line.partition(b":")
        if k.strip().lower() == b"sec-websocket-accept":
            got_accept = v.strip()
    if got_accept != want_accept:
        raise RuntimeError(f"bad Sec-WebSocket-Accept: {got_accept!r}")

    def write():
        try:
            step = block * dtype.itemsize
            for off in range(0, len(payload), step):
                sock.sendall(encode_frame(BINARY, payload[off:off + step],
                                          mask=True))
            # empty binary message = end-of-input marker; keep the socket
            # open to collect the flush tail until the server's CLOSE
            sock.sendall(encode_frame(BINARY, b"", mask=True))
        except OSError:
            pass

    w = threading.Thread(target=write, daemon=True)
    w.start()
    chunks = []
    reader = MessageReader(rfile)
    try:
        while True:
            op, data = reader.read()
            if op == BINARY:
                chunks.append(data)
            elif op == PING:
                sock.sendall(encode_frame(PONG, data, mask=True))
            elif op == CLOSE:
                break
    except (EOFError, OSError):
        pass
    w.join(timeout=timeout)
    sock.close()
    raw = b"".join(chunks)
    import numpy as np

    y = np.frombuffer(raw, dtype).astype(np.float32)
    if fmt == "s16le":
        y /= 32768.0
    return y.reshape(-1, channels).T
