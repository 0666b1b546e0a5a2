"""ctypes bindings of the port's C++ codec (csrc/wavio.cpp, csrc/flacio.cpp):
WAV and FLAC decode, the parallel batch chunk reader and a PCM-16 WAV
writer. Counterpart of ml_audio_restoration_tpu/audio/native.py with the
same entry points, over a library of its own: ops/_build.py compiles it
with g++ at first use into the git-ignored build/ under a content-hashed
name. A failed build raises with the compiler's output; nothing falls back
to the numpy codec (audio/wav.py, audio/flac.py), which is the plain
version the tests hold this one against.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..ops import _build

LIBRARY = "wavio"


@functools.cache
def load_library() -> ctypes.CDLL:
    """The codec library, built if needed, with its argument types set.
    Raises RuntimeError when it cannot be built."""
    lib = _build.load(LIBRARY)
    lib.wavio_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.wavio_info.restype = ctypes.c_int
    lib.wavio_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    lib.wavio_read.restype = ctypes.c_int64
    lib.wavio_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int, ctypes.c_int]
    lib.wavio_read_batch.restype = ctypes.c_int
    lib.wavio_write_pcm16.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.wavio_write_pcm16.restype = ctypes.c_int
    return lib


def available() -> bool:
    """True once the library is built and loaded; raises when it cannot
    be built."""
    return load_library() is not None


def info(path) -> Optional[dict]:
    """{sample_rate, channels, frames, bits, fmt} of a WAV or FLAC file
    (fmt 0xF1AC for FLAC), or None when the codec cannot parse it."""
    lib = load_library()
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    frames = ctypes.c_int64()
    bits = ctypes.c_int32()
    fmt = ctypes.c_int32()
    rc = lib.wavio_info(str(path).encode(), ctypes.byref(sr),
                        ctypes.byref(ch), ctypes.byref(frames),
                        ctypes.byref(bits), ctypes.byref(fmt))
    if rc != 0:
        return None
    return {"sample_rate": sr.value, "channels": ch.value,
            "frames": frames.value, "bits": bits.value, "fmt": fmt.value}


def read(path, start: int = 0, frames: int = -1, mono: bool = False):
    """-> (float32 [T, C] or [T] if mono, sample_rate), or None when the
    codec cannot decode the file."""
    lib = load_library()
    meta = info(path)
    if meta is None:
        return None
    total = meta["frames"]
    start = max(0, min(start, total))
    n = total - start if frames < 0 else min(frames, total - start)
    ch = 1 if mono else meta["channels"]
    # zeros, not empty: a decoder returning fewer samples than counted
    # must surface silence, never uninitialized memory as audio
    out = np.zeros(n * ch, np.float32)
    got = lib.wavio_read(str(path).encode(), start, n, int(mono),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        return None
    out = out[:got * ch]
    data = out if mono else out.reshape(-1, meta["channels"])
    return data, meta["sample_rate"]


def read_batch_mono(paths: Sequence, starts: Sequence[int], frames: int,
                    threads: int = 8):
    """Mono chunks of `frames` frames from `starts`, decoded over `threads`
    C++ threads in one call (no GIL) -> float32 [N, frames], each row
    zero-padded past its file's end; None when a file cannot be read."""
    lib = load_library()
    n = len(paths)
    out = np.zeros((n, frames), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_starts = (ctypes.c_int64 * n)(*[int(s) for s in starts])
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)(*[
        out[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        for i in range(n)])
    rc = lib.wavio_read_batch(c_paths, c_starts, frames, 1, ptrs, n, threads)
    if rc != 0:
        return None
    return out


def write_pcm16(path, data: np.ndarray, sample_rate: int) -> bool:
    """Write [T, C] or [T] float data as a PCM-16 WAV; False when the
    write fails."""
    lib = load_library()
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    frames, ch = data.shape
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    rc = lib.wavio_write_pcm16(
        str(path).encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, ch, sample_rate)
    return rc == 0
