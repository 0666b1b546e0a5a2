"""RIFF/WAVE codec in numpy: PCM 8/16/24/32-bit and IEEE float 32/64 in,
PCM_16, PCM_24 or FLOAT out.

The port's own copy of the numpy path of ml_audio_restoration_tpu/audio/
wav.py (same header parsing, scaling and rounding), so a file written by
either package decodes to the same samples in the other.
"""
from __future__ import annotations

import io
import struct
from pathlib import Path

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


class WavInfo:
    __slots__ = ("sample_rate", "channels", "frames", "bits", "fmt",
                 "data_offset", "data_size")

    def __init__(self, sample_rate, channels, frames, bits, fmt,
                 data_offset, data_size):
        self.sample_rate = sample_rate
        self.channels = channels
        self.frames = frames
        self.bits = bits
        self.fmt = fmt
        self.data_offset = data_offset
        self.data_size = data_size

    @property
    def duration(self):
        """Seconds of audio: frames / sample_rate."""
        return self.frames / self.sample_rate


def _parse_header(f) -> WavInfo:
    riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    info = {}
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, csize = struct.unpack("<4sI", hdr)
        if cid == b"fmt ":
            data = f.read(csize)
            if csize & 1:  # RIFF chunks are word-aligned
                f.seek(1, 1)
            (audio_fmt, channels, sample_rate, _brate, _align,
             bits) = struct.unpack("<HHIIHH", data[:16])
            if audio_fmt == _EXTENSIBLE and csize >= 40:
                audio_fmt = struct.unpack("<H", data[24:26])[0]
            info.update(fmt=audio_fmt, channels=channels,
                        sample_rate=sample_rate, bits=bits)
        elif cid == b"data":
            info["data_offset"] = f.tell()
            info["data_size"] = csize
            f.seek(csize + (csize & 1), 1)
        else:
            f.seek(csize + (csize & 1), 1)
    if "fmt" not in info or "data_offset" not in info:
        raise ValueError("missing fmt/data chunk")
    bytes_per_frame = info["channels"] * info["bits"] // 8
    if bytes_per_frame <= 0:
        raise ValueError(f"invalid WAV fmt chunk: channels={info['channels']} "
                         f"bits={info['bits']}")
    frames = info["data_size"] // bytes_per_frame
    return WavInfo(info["sample_rate"], info["channels"], frames,
                   info["bits"], info["fmt"], info["data_offset"],
                   info["data_size"])


def wav_info(path) -> WavInfo:
    with open(path, "rb") as f:
        return _parse_header(f)


def _decode(raw: bytes, info: WavInfo) -> np.ndarray:
    bits, fmt, ch = info.bits, info.fmt, info.channels
    if fmt == _IEEE_FLOAT and bits in (32, 64):
        x = np.frombuffer(raw, dtype=f"<f{bits // 8}").astype(np.float32)
    elif fmt == _PCM and bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif fmt == _PCM and bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif fmt == _PCM and bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32)
             | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
        x = x / float(1 << 23)
    elif fmt == _PCM and bits == 8:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV format: fmt={fmt} bits={bits}")
    return x.reshape(-1, ch)


def read_wav(path, start: int = 0, frames: int = -1,
             always_2d: bool = True):
    """Read a WAV file, or `frames` frames of it from `start` (a seek, no
    decode of the rest) -> (float32 [T, C], sample_rate), or [T] for a
    mono file when not always_2d."""
    with open(path, "rb") as f:
        info = _parse_header(f)
        bpf = info.channels * info.bits // 8
        start = max(0, min(start, info.frames))
        n = info.frames - start if frames < 0 else min(frames,
                                                       info.frames - start)
        f.seek(info.data_offset + start * bpf)
        raw = f.read(n * bpf)
    # a truncated data chunk leaves a partial last frame: decode whole frames
    raw = raw[:len(raw) // bpf * bpf]
    data = _decode(raw, info)
    if not always_2d and info.channels == 1:
        data = data[:, 0]
    return data, info.sample_rate


def decode_wav(buf: bytes, always_2d: bool = True):
    """Decode an in-memory WAV -> (float32 [T, C], sample_rate), or [T]
    for a mono file when not always_2d. A data chunk shorter than its
    declared size raises: a body cut off in transit is not decoded."""
    f = io.BytesIO(buf)
    info = _parse_header(f)
    f.seek(info.data_offset)
    want = min(info.data_size, info.frames * info.channels * info.bits // 8)
    raw = f.read(want)
    if len(raw) < want:
        raise ValueError(f"truncated WAV: data chunk declares {want} "
                         f"bytes, {len(raw)} present")
    data = _decode(raw, info)
    if not always_2d and info.channels == 1:
        data = data[:, 0]
    return data, info.sample_rate


def encode_wav(data: np.ndarray, sample_rate: int,
               subtype: str = "PCM_16") -> bytes:
    """Encode [T, C] or [T] float data to WAV bytes."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    t, ch = data.shape
    if subtype == "FLOAT":
        payload = data.astype("<f4").tobytes()
        bits, fmt = 32, _IEEE_FLOAT
    elif subtype == "PCM_24":
        x = np.clip(np.round(data * (1 << 23)), -(1 << 23), (1 << 23) - 1)
        flat = x.astype(np.int32).reshape(-1)
        b = np.empty((t * ch, 3), np.uint8)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        payload = b.tobytes()
        bits, fmt = 24, _PCM
    elif subtype == "PCM_16":
        x = np.clip(np.round(data * 32768.0), -32768, 32767).astype("<i2")
        payload = x.tobytes()
        bits, fmt = 16, _PCM
    else:
        raise ValueError(f"unsupported WAV subtype {subtype!r}")
    bpf = ch * bits // 8
    pad = len(payload) & 1  # RIFF size counts the pad byte, data size does not
    parts = [struct.pack("<4sI4s", b"RIFF", 36 + len(payload) + pad, b"WAVE"),
             struct.pack("<4sIHHIIHH", b"fmt ", 16, fmt, ch, sample_rate,
                         sample_rate * bpf, bpf, bits),
             struct.pack("<4sI", b"data", len(payload)),
             payload]
    if pad:
        parts.append(b"\x00")
    return b"".join(parts)


def write_wav(path, data: np.ndarray, sample_rate: int,
              subtype: str = "PCM_16"):
    """Write [T, C] or [T] float data. subtype: PCM_16 | PCM_24 | FLOAT."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_wav(data, sample_rate, subtype=subtype))
