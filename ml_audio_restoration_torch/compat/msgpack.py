"""Flax's msgpack checkpoint format, read and written in pure Python.

The JAX package saves checkpoints with `flax.serialization.
msgpack_serialize` (ml_audio_restoration_tpu/train/checkpoints.py). Neither
flax nor the `msgpack` package is on the card's machine, so the port reads
and writes the subset flax uses itself:

- msgpack formats: nil, bool, every int width, float32/64, str, bin,
  array, map and ext;
- flax's ext codes: 1 an ndarray, whose payload is itself msgpack
  `[shape, dtype name, C-order bytes]` (flax unpacks it with raw=True, so
  the dtype name may arrive as bytes), 2 a complex `[real, imag]`, 3 a
  numpy scalar (an ndarray payload of shape ());
- flax's `__msgpack_chunked_array__` maps, which it writes for arrays over
  2**30 bytes, joined back into one array as `msgpack_restore` does (in
  maps only, as there).

`loads` equals `flax.serialization.msgpack_restore` and `dumps` writes the
bytes `msgpack_serialize` writes for a tree of dicts (keys in sorted
order, as flax's copy of the tree leaves them), lists, Python scalars and
numpy arrays under its chunk size (tuples are written as arrays, where
flax refuses them). A dtype name that is not a numpy bool,
integer, float or complex type (such as bfloat16) raises.
"""
from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """An ext object of a code flax does not define, as msgpack returns it."""
    code: int
    data: bytes


def _dtype(name) -> np.dtype:
    if isinstance(name, bytes):
        name = name.decode("ascii", "replace")
    try:
        dtype = np.dtype(name)
    except TypeError:
        dtype = None
    if dtype is None or dtype.kind not in "biufc":
        raise ValueError(f"msgpack ndarray of dtype {name!r}: not a numpy "
                         f"bool, integer, float or complex type")
    return dtype


# format byte -> struct code of a fixed-width int or float
_SCALARS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        # format byte -> (struct code of the length, reader of that length)
        self.sized = {0xC4: ("B", self.take), 0xC5: ("H", self.take),
                      0xC6: ("I", self.take),
                      0xC7: ("B", self.ext), 0xC8: ("H", self.ext),
                      0xC9: ("I", self.ext),
                      0xD9: ("B", self.str_), 0xDA: ("H", self.str_),
                      0xDB: ("I", self.str_),
                      0xDC: ("H", self.array), 0xDD: ("I", self.array),
                      0xDE: ("H", self.map_), 0xDF: ("I", self.map_)}

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack map key of type "
                                 f"{type(key).__name__}: only str or bytes")
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_COMPLEX:
            real, imag = loads(payload, unchunk=False)
            return complex(real, imag)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        return ExtType(code, payload)

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in self.sized:
            fmt, read = self.sized[b]
            return read(self.unpack(fmt))
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        raise ValueError(f"msgpack: unknown format byte 0x{b:02x}")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = loads(payload, raw=True, unchunk=False)
    return np.frombuffer(buf, dtype=_dtype(name)).reshape(shape, order="C")


def _unchunk(d):
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_maps(d):
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            d[k] = _unchunk_maps(v)
    return d


def loads(data: bytes, raw: bool = False, unchunk: bool = True):
    """Decode one msgpack object (str as str, or as bytes when `raw`),
    flax's ext types and chunked arrays included."""
    reader = _Reader(data, raw)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         f"after the object")
    return _unchunk_maps(out) if unchunk else out


def _head(out: list, n: int, fix: int | None, fix_max: int, codes):
    """Append the smallest header of a sized object of length n."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(bytes([code]) + struct.pack(">" + fmt, n))
            return
    raise ValueError(f"msgpack: object of length {n} is too long")


_W8, _W16, _W32 = 1 << 8, 1 << 16, 1 << 32


def _ext(out: list, code: int, payload: bytes):
    n = len(payload)
    if n in (1, 2, 4, 8, 16):
        out.append(bytes([0xD4 + n.bit_length() - 1, code]))
    else:
        _head(out, n, None, 0, ((0xC7, "B", _W8), (0xC8, "H", _W16),
                                 (0xC9, "I", _W32)))
        out.append(struct.pack(">b", code))
    out.append(payload)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.kind not in "biufc":
        raise ValueError(f"cannot write an ndarray of dtype {arr.dtype}")
    return dumps([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: list, x):
    # numpy scalars first: np.float64 subclasses float, and flax packs
    # with strict_types, so every numpy scalar is an ext 3
    if isinstance(x, np.ndarray):
        _ext(out, EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        if 0 <= x < 0x80 or -32 <= x < 0:
            out.append(struct.pack(">b" if x < 0 else ">B", x))
        elif x >= 0:
            for code, fmt, top in ((0xCC, "B", _W8), (0xCD, "H", _W16),
                                   (0xCE, "I", _W32), (0xCF, "Q", 1 << 64)):
                if x < top:
                    out.append(bytes([code]) + struct.pack(">" + fmt, x))
                    break
            else:
                raise ValueError(f"msgpack: integer {x} out of range")
        else:
            for code, fmt, low in ((0xD0, "b", -(1 << 7)),
                                   (0xD1, "h", -(1 << 15)),
                                   (0xD2, "i", -(1 << 31)),
                                   (0xD3, "q", -(1 << 63))):
                if x >= low:
                    out.append(bytes([code]) + struct.pack(">" + fmt, x))
                    break
            else:
                raise ValueError(f"msgpack: integer {x} out of range")
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _head(out, len(b), 0xA0, 31, ((0xD9, "B", _W8), (0xDA, "H", _W16),
                                       (0xDB, "I", _W32)))
        out.append(b)
    elif isinstance(x, bytes):
        _head(out, len(x), None, 0, ((0xC4, "B", _W8), (0xC5, "H", _W16),
                                      (0xC6, "I", _W32)))
        out.append(x)
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 15, ((0xDC, "H", _W16), (0xDD, "I", _W32)))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 15, ((0xDE, "H", _W16), (0xDF, "I", _W32)))
        for k in sorted(x):  # flax's tree_map copy sorts the keys
            _pack(out, k)
            _pack(out, x[k])
    elif isinstance(x, complex):
        _ext(out, EXT_COMPLEX, dumps([x.real, x.imag]))
    else:
        raise TypeError(f"cannot write {type(x).__name__} as msgpack")


def dumps(tree) -> bytes:
    """Encode a tree of dicts, lists, Python scalars and numpy arrays as
    flax's msgpack_serialize does (arrays are written whole, unchunked)."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)
