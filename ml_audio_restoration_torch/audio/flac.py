"""Self-contained FLAC codec (numpy, no external audio libraries), the
port's copy of ml_audio_restoration_tpu/audio/flac.py: the same arithmetic,
so both packages write the same bytes for the same input.

- ``read_flac`` — full decoder: all subframe types (CONSTANT, VERBATIM,
  FIXED 0-4, LPC 1-32), RICE/RICE2 residual with partitions + escape codes,
  wasted bits, all stereo decorrelation modes (independent, left/side,
  right/side, mid/side), 8-32 bit, frame CRC-8/CRC-16 verification, and
  seek-based partial reads (via SEEKTABLE when present, else sequential
  skip-decode) for the random-chunk dataset loading path.
- ``write_flac`` — encoder producing spec-compliant streams: fixed or LPC
  prediction (Levinson-Durbin), rice partitioning, stereo decorrelation,
  wasted-bit detection, STREAMINFO MD5, optional SEEKTABLE. Used by
  ``save_audio`` and to generate test fixtures.

Decoding for ``load_audio`` runs in the C++ codec (csrc/flacio.cpp through
audio/native.py); this module is the plain version it is held against, and
the writer.
"""
from __future__ import annotations

import hashlib
import struct
from pathlib import Path

import numpy as np

__all__ = ["FlacInfo", "flac_info", "read_flac", "write_flac"]

# ---------------------------------------------------------------------- CRC

def _make_crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        table[i] = c & mask
    return table


_CRC8_TABLE = _make_crc_table(0x07, 8)
_CRC16_TABLE = _make_crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = (int(_CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]) ^ (crc << 8)) & 0xFFFF
    return crc


# ------------------------------------------------------------------ bit I/O

class _BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def read(self, n: int) -> int:
        """n-bit big-endian unsigned."""
        pos = self.pos
        byte0 = pos >> 3
        bitoff = pos & 7
        need = (bitoff + n + 7) >> 3
        chunk = self.data[byte0:byte0 + need]
        if len(chunk) < need:
            raise ValueError("FLAC: truncated stream")
        val = int.from_bytes(chunk, "big")
        val >>= (need << 3) - bitoff - n
        self.pos = pos + n
        return val & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count 0 bits until the terminating 1 bit."""
        data = self.data
        pos = self.pos
        q = 0
        while True:
            byte0 = pos >> 3
            if byte0 >= len(data):
                raise ValueError("FLAC: truncated stream in unary code")
            rem = 8 - (pos & 7)
            chunk = data[byte0] & ((1 << rem) - 1)
            if chunk == 0:
                q += rem
                pos += rem
            else:
                zeros = rem - chunk.bit_length()
                q += zeros
                pos += zeros + 1
                self.pos = pos
                return q

    def align(self):
        self.pos = (self.pos + 7) & ~7

    @property
    def byte_pos(self) -> int:
        return self.pos >> 3


class _BitWriter:
    __slots__ = ("buf", "acc", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, n: int):
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def write_bytes(self, data: bytes):
        assert self.nbits == 0
        self.buf.extend(data)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


# ------------------------------------------------------------------ headers

class FlacInfo:
    __slots__ = ("sample_rate", "channels", "frames", "bits",
                 "block_size", "md5", "first_frame_offset", "seektable")

    def __init__(self, sample_rate, channels, frames, bits, block_size,
                 md5, first_frame_offset, seektable):
        self.sample_rate = sample_rate
        self.channels = channels
        self.frames = frames          # total samples per channel
        self.bits = bits
        self.block_size = block_size  # nominal (max) block size
        self.md5 = md5
        self.first_frame_offset = first_frame_offset
        self.seektable = seektable    # [(sample, byte_offset, nsamples)]

    @property
    def duration(self):
        return self.frames / self.sample_rate


def _parse_metadata(data: bytes) -> FlacInfo:
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC file")
    pos = 4
    streaminfo = None
    seektable = []
    while True:
        if pos + 4 > len(data):
            raise ValueError("FLAC: truncated metadata")
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + length]
        if len(body) < length:
            raise ValueError("FLAC: truncated metadata block")
        if btype == 0:  # STREAMINFO
            if length < 34:
                raise ValueError("FLAC: short STREAMINFO")
            br = _BitReader(body)
            br.read(16)  # min blocksize
            max_bs = br.read(16)
            br.read(24)  # min framesize
            br.read(24)  # max framesize
            sr = br.read(20)
            ch = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            md5 = body[18:34]
            streaminfo = (sr, ch, bps, total, max_bs, md5)
        elif btype == 3:  # SEEKTABLE
            for i in range(length // 18):
                sample, off, n = struct.unpack_from(">QQH", body, i * 18)
                if sample != 0xFFFFFFFFFFFFFFFF:  # placeholder points
                    seektable.append((sample, off, n))
        pos += 4 + length
        if last:
            break
    if streaminfo is None:
        raise ValueError("FLAC: missing STREAMINFO")
    sr, ch, bps, total, max_bs, md5 = streaminfo
    return FlacInfo(sr, ch, total, bps, max_bs, md5, pos, seektable)


def flac_info(path) -> FlacInfo:
    with open(path, "rb") as f:
        head = f.read(4)
        if head != b"fLaC":
            raise ValueError("not a FLAC file")
        # metadata blocks sit at the front; read incrementally
        blocks = bytearray(head)
        while True:
            bh = f.read(4)
            blocks.extend(bh)
            if len(bh) < 4:
                break
            length = int.from_bytes(bh[1:4], "big")
            blocks.extend(f.read(length))
            if bh[0] & 0x80:
                break
    return _parse_metadata(bytes(blocks))


# ----------------------------------------------------------------- decoding

_BLOCK_SIZE_CODES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                     8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                     13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATE_CODES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                      6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                      11: 96000}
_SAMPLE_SIZE_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

# fixed-predictor coefficients, order 1..4 (c[j] multiplies s[i-1-j])
_FIXED_COEFS = {1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _read_utf8_number(br: _BitReader) -> int:
    first = br.read(8)
    if first < 0x80:
        return first
    n_cont = 0
    mask = 0x40
    while first & mask:
        n_cont += 1
        mask >>= 1
    if n_cont < 1 or n_cont > 6:
        raise ValueError("FLAC: bad UTF-8 coded number")
    val = first & (mask - 1)
    for _ in range(n_cont):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("FLAC: bad UTF-8 continuation")
        val = (val << 6) | (b & 0x3F)
    return val


def _decode_residual(br: _BitReader, block_size: int, order: int):
    """-> int64 [block_size - order] prediction residual."""
    method = br.read(2)
    if method > 1:
        raise ValueError("FLAC: reserved residual coding method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read(4)
    nparts = 1 << po
    if block_size % nparts or (block_size >> po) <= order:
        raise ValueError("FLAC: invalid partition order")
    out = np.empty(block_size - order, np.int64)
    idx = 0
    for p in range(nparts):
        count = (block_size >> po) - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            raw_bits = br.read(5)
            if raw_bits == 0:
                out[idx:idx + count] = 0
            else:
                for i in range(count):
                    out[idx + i] = br.read_signed(raw_bits)
        else:
            read_unary = br.read_unary
            read = br.read
            if param == 0:
                for i in range(count):
                    q = read_unary()
                    out[idx + i] = (q >> 1) ^ -(q & 1)
            else:
                for i in range(count):
                    v = (read_unary() << param) | read(param)
                    out[idx + i] = (v >> 1) ^ -(v & 1)
        idx += count
    return out


def _restore_fixed(warmup, residual, order: int) -> np.ndarray:
    """Inverse of the order-k difference operator, vectorized (cumsums)."""
    if order == 0:
        return residual.copy()
    w = np.asarray(warmup, np.int64)
    sig = np.empty(order + residual.size, np.int64)
    sig[:order] = w
    cur = residual
    # reconstruct Δ^(j-1) from Δ^j, seeding each level from the warmup diffs
    for j in range(order, 0, -1):
        init = np.diff(w, j - 1)[-1] if j > 1 else w[-1]
        cur = init + np.cumsum(cur)
    sig[order:] = cur
    return sig


def _restore_lpc(warmup, residual, coefs, shift: int) -> np.ndarray:
    order = len(coefs)
    n = order + residual.size
    sig = [0] * n
    sig[:order] = [int(v) for v in warmup]
    res = residual.tolist()
    cf = [int(c) for c in coefs]
    rng = range(order)
    for i in range(order, n):
        acc = 0
        for j in rng:
            acc += cf[j] * sig[i - 1 - j]
        sig[i] = res[i - order] + (acc >> shift)
    return np.asarray(sig, np.int64)


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("FLAC: subframe padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    ebps = bps - wasted
    if ebps <= 0 or ebps > 33:  # mirror flacio.cpp's validation: a corrupt
        # wasted-bits count would otherwise die as a bare 'negative shift
        # count' deep inside read_signed
        raise ValueError(f"FLAC: invalid effective bps {ebps}")
    if stype == 0:  # CONSTANT
        val = br.read_signed(ebps)
        out = np.full(block_size, val, np.int64)
    elif stype == 1:  # VERBATIM
        out = np.empty(block_size, np.int64)
        for i in range(block_size):
            out[i] = br.read_signed(ebps)
    elif 8 <= stype <= 12:  # FIXED order 0-4
        order = stype - 8
        warmup = [br.read_signed(ebps) for _ in range(order)]
        residual = _decode_residual(br, block_size, order)
        out = _restore_fixed(warmup, residual, order)
    elif stype >= 32:  # LPC, order 1-32
        order = (stype & 0x1F) + 1
        warmup = [br.read_signed(ebps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("FLAC: invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("FLAC: negative LPC shift")
        coefs = [br.read_signed(precision) for _ in range(order)]
        residual = _decode_residual(br, block_size, order)
        out = _restore_lpc(warmup, residual, coefs, shift)
    else:
        raise ValueError(f"FLAC: reserved subframe type {stype}")
    if wasted:
        out <<= wasted
    return out


def _decode_frame(data: bytes, offset: int, info: FlacInfo, verify: bool):
    """Decode the frame at byte `offset`.
    -> (samples int64 [block_size, channels], first_sample_index, next_offset)
    """
    br = _BitReader(data, offset << 3)
    sync = br.read(14)
    if sync != 0x3FFE:
        raise ValueError(f"FLAC: lost frame sync at byte {offset}")
    if br.read(1):
        raise ValueError("FLAC: reserved frame header bit")
    variable = br.read(1)
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1):
        raise ValueError("FLAC: reserved frame header bit")
    coded = _read_utf8_number(br)
    if bs_code == 0:
        raise ValueError("FLAC: reserved block size code")
    elif bs_code == 6:
        block_size = br.read(8) + 1
    elif bs_code == 7:
        block_size = br.read(16) + 1
    else:
        block_size = _BLOCK_SIZE_CODES[bs_code]
    if sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    elif sr_code == 15:
        raise ValueError("FLAC: invalid sample rate code")
    header_end = br.byte_pos
    crc8 = br.read(8)
    if verify and _crc8(data[offset:header_end]) != crc8:
        raise ValueError("FLAC: frame header CRC-8 mismatch")

    if ss_code and ss_code not in _SAMPLE_SIZE_CODES:
        raise ValueError(f"FLAC: reserved sample-size code {ss_code}")
    bps = _SAMPLE_SIZE_CODES[ss_code] if ss_code else info.bits
    first_sample = coded if variable else coded * info.block_size

    if ch_code <= 7:
        channels = ch_code + 1
        subs = [_decode_subframe(br, block_size, bps)
                for _ in range(channels)]
        frame = np.stack(subs, axis=1)
    elif ch_code in (8, 9, 10):
        side_ch = 1 if ch_code in (8, 10) else 0
        subs = [_decode_subframe(br, block_size,
                                 bps + (1 if c == side_ch else 0))
                for c in range(2)]
        if ch_code == 8:    # left/side: right = left - side
            left, side = subs
            frame = np.stack([left, left - side], axis=1)
        elif ch_code == 9:  # right/side: left = right + side
            side, right = subs
            frame = np.stack([right + side, right], axis=1)
        else:               # mid/side
            mid, side = subs
            mid2 = (mid << 1) | (side & 1)
            frame = np.stack([(mid2 + side) >> 1, (mid2 - side) >> 1], axis=1)
    else:
        raise ValueError("FLAC: reserved channel assignment")

    br.align()
    crc_pos = br.byte_pos
    crc16 = br.read(16)
    if verify and _crc16(data[offset:crc_pos]) != crc16:
        raise ValueError("FLAC: frame CRC-16 mismatch")
    return frame, first_sample, br.byte_pos


def read_flac(path, start: int = 0, frames: int = -1, always_2d: bool = True,
              verify: bool = True, dtype=np.float32):
    """Read a FLAC file (optionally a frame range) -> (float32 [T, C], sr).

    `start`/`frames` allow partial reads: the SEEKTABLE (when present) jumps
    near `start`; otherwise frames before the range are skip-decoded.
    `dtype=None` returns raw int32 samples instead of normalized float.
    """
    data = Path(path).read_bytes()
    info = _parse_metadata(data)
    total = info.frames
    if total == 0:
        # STREAMINFO total_samples == 0 means UNKNOWN length (streamed
        # encode), not an empty file — silently returning zero samples
        # would feed empty chunks into the data loader with no error
        raise ValueError(
            f"{path}: FLAC STREAMINFO declares unknown length "
            f"(total_samples=0, a streamed encode); re-encode with a "
            f"known length")
    start = max(0, min(start, total))
    n = total - start if frames < 0 else min(frames, total - start)

    offset = info.first_frame_offset
    if start > 0 and info.seektable:
        best = max((pt for pt in info.seektable if pt[0] <= start),
                   key=lambda pt: pt[0], default=None)
        if best is not None:
            offset = info.first_frame_offset + best[1]

    out = np.zeros((n, info.channels), np.int64)
    end = start + n
    while offset < len(data):
        frame, first, next_offset = _decode_frame(data, offset, info, verify)
        offset = next_offset
        lo = max(first, start)
        hi = min(first + frame.shape[0], end)
        if hi > lo:
            out[lo - start:hi - start] = frame[lo - first:hi - first]
        if first + frame.shape[0] >= end:
            break
    if dtype is None:
        result = out.astype(np.int32)
    else:
        result = (out.astype(np.float64)
                  / float(1 << (info.bits - 1))).astype(dtype)
    if not always_2d and info.channels == 1:
        result = result[:, 0]
    return result, info.sample_rate


# ----------------------------------------------------------------- encoding

def _zigzag(v: np.ndarray) -> np.ndarray:
    return np.bitwise_xor(v << 1, v >> 63)


def _best_rice_param(z: np.ndarray, plen: int):
    """-> (param, total_bits) minimizing the rice-coded size."""
    n = z.size
    best_p, best_bits = 0, None
    for p in range(min(30, (1 << plen) - 1)):
        bits = n * (p + 1) + int(np.sum(z >> p))
        if best_bits is None or bits < best_bits:
            best_p, best_bits = p, bits
        elif bits > best_bits * 2:
            break
    return best_p, best_bits


def _write_residual(bw: _BitWriter, residual: np.ndarray, block_size: int,
                    order: int, partition_order: int, use_escape: bool):
    bw.write(0, 2)  # RICE method (4-bit params)
    po = partition_order
    while po > 0 and (block_size % (1 << po) or (block_size >> po) <= order):
        po -= 1
    bw.write(po, 4)
    nparts = 1 << po
    idx = 0
    for p in range(nparts):
        count = (block_size >> po) - (order if p == 0 else 0)
        part = residual[idx:idx + count]
        idx += count
        z = _zigzag(part)
        if use_escape and not np.any(part):
            bw.write(0xF, 4)  # escape, 0 raw bits: all-zero partition
            bw.write(0, 5)
            continue
        param, _ = _best_rice_param(z, 4)  # always <= 14 (15 is the escape)
        bw.write(param, 4)
        for v in z:
            v = int(v)
            bw.write_unary(v >> param)
            if param:
                bw.write(v & ((1 << param) - 1), param)


def _fixed_residuals(sig: np.ndarray, max_order: int = 4):
    """-> list of residual arrays for fixed orders 0..max_order."""
    out = [sig.copy()]
    cur = sig
    for _ in range(max_order):
        cur = np.diff(cur)
        out.append(cur)
    return out


def _quantize_lpc(coefs: np.ndarray, precision: int = 12):
    cmax = float(np.max(np.abs(coefs)))
    if cmax <= 0:
        return None
    qmax = (1 << (precision - 1)) - 1
    shift = int(np.floor(np.log2(qmax / cmax))) if cmax else 0
    shift = max(0, min(15, shift))
    q = np.clip(np.round(coefs * (1 << shift)),
                -(1 << (precision - 1)), qmax).astype(np.int64)
    if not np.any(q):
        return None
    return q, shift, precision


def _lpc_coefficients(sig: np.ndarray, order: int):
    """Levinson-Durbin on the autocorrelation; -> float coefficients
    (c[j] multiplies s[i-1-j]) or None if degenerate."""
    x = sig.astype(np.float64)
    n = x.size
    if n <= order:
        return None
    autoc = np.array([np.dot(x[:n - k], x[k:]) for k in range(order + 1)])
    if autoc[0] <= 0:
        return None
    err = autoc[0]
    coefs = np.zeros(order)
    for i in range(order):
        acc = autoc[i + 1] - np.dot(coefs[:i], autoc[i:0:-1][:i])
        k = acc / err
        if i:
            coefs[:i] -= k * coefs[:i][::-1].copy()
        coefs[i] = k
        err *= 1 - k * k
        if err <= 0:
            return None
    return coefs


def _lpc_residual(sig: np.ndarray, q: np.ndarray, shift: int):
    order = q.size
    acc = np.zeros(sig.size - order, np.int64)
    for j in range(order):
        acc += q[j] * sig[order - 1 - j:sig.size - 1 - j]
    return sig[order:] - (acc >> shift)


def _encode_subframe(bw: _BitWriter, sig: np.ndarray, bps: int,
                     block_size: int, opts: dict):
    if opts.get("force_verbatim"):
        bw.write(0, 1)
        bw.write(1, 6)
        bw.write(0, 1)
        for v in sig:
            bw.write_signed(int(v), bps)
        return
    if np.all(sig == sig[0]):
        bw.write(0, 1)
        bw.write(0, 6)  # CONSTANT
        bw.write(0, 1)
        bw.write_signed(int(sig[0]), bps)
        return

    # wasted bits: trailing zero bits common to every sample
    wasted = 0
    if opts.get("detect_wasted", True):
        ored = int(np.bitwise_or.reduce(sig))
        if ored:
            wasted = (ored & -ored).bit_length() - 1
            wasted = min(wasted, bps - 1)
    ebps = bps - wasted
    s = sig >> wasted if wasted else sig

    max_fixed = min(4, s.size - 1)
    residuals = _fixed_residuals(s, max_fixed)
    costs = [int(np.sum(_zigzag(r))) + (o + 1) * ebps
             for o, r in enumerate(residuals)]
    order = int(np.argmin(costs))
    best = ("fixed", order, residuals[order])

    lpc_order = opts.get("lpc_order")
    if lpc_order and s.size > 2 * lpc_order:
        coefs = _lpc_coefficients(s, lpc_order)
        quant = _quantize_lpc(coefs) if coefs is not None else None
        if quant is not None:
            q, shift, precision = quant
            res = _lpc_residual(s, q, shift)
            if int(np.sum(_zigzag(res))) < int(np.sum(_zigzag(best[2]))):
                best = ("lpc", (q, shift, precision), res)

    bw.write(0, 1)
    if best[0] == "fixed":
        order = best[1]
        bw.write(8 | order, 6)
        _write_wasted(bw, wasted)
        for v in s[:order]:
            bw.write_signed(int(v), ebps)
    else:
        q, shift, precision = best[1]
        order = q.size
        bw.write(32 | (order - 1), 6)
        _write_wasted(bw, wasted)
        for v in s[:order]:
            bw.write_signed(int(v), ebps)
        bw.write(precision - 1, 4)
        bw.write(shift, 5)
        for c in q:
            bw.write_signed(int(c), precision)
    _write_residual(bw, best[2], block_size, order,
                    opts.get("partition_order", 4),
                    opts.get("use_escape", False))


def _write_wasted(bw: _BitWriter, wasted: int):
    if wasted:
        bw.write(1, 1)
        bw.write_unary(wasted - 1)
    else:
        bw.write(0, 1)


def _utf8_encode(val: int) -> bytes:
    if val < 0x80:
        return bytes([val])
    out = []
    nbits = val.bit_length()
    n_cont = 1
    while nbits > 6 * n_cont + (6 - n_cont):
        n_cont += 1
    lead = (0xFF << (7 - n_cont)) & 0xFF
    out.append(lead | (val >> (6 * n_cont)))
    for i in range(n_cont - 1, -1, -1):
        out.append(0x80 | ((val >> (6 * i)) & 0x3F))
    return bytes(out)


_BS_CODE_INV = {v: k for k, v in _BLOCK_SIZE_CODES.items()}
_SR_CODE_INV = {v: k for k, v in _SAMPLE_RATE_CODES.items()}
_SS_CODE_INV = {v: k for k, v in _SAMPLE_SIZE_CODES.items()}


def _encode_frame(samples: np.ndarray, frame_no: int, sample_rate: int,
                  bps: int, stereo_mode: str, opts: dict) -> bytes:
    block_size, channels = samples.shape
    mode = "independent" if channels != 2 else stereo_mode
    if mode == "auto":
        left, right = samples[:, 0], samples[:, 1]
        side = left - right
        mid = (left + right) >> 1
        c_ind = int(np.sum(_zigzag(np.diff(left)))
                    + np.sum(_zigzag(np.diff(right))))
        c_ls = int(np.sum(_zigzag(np.diff(left)))
                   + np.sum(_zigzag(np.diff(side))))
        c_ms = int(np.sum(_zigzag(np.diff(mid)))
                   + np.sum(_zigzag(np.diff(side))))
        mode = min((("independent", c_ind), ("left_side", c_ls),
                    ("mid_side", c_ms)), key=lambda kv: kv[1])[0]

    if mode == "independent":
        ch_code = channels - 1
        subs = [(samples[:, c], bps) for c in range(channels)]
    elif mode == "left_side":
        ch_code = 8
        subs = [(samples[:, 0], bps),
                (samples[:, 0] - samples[:, 1], bps + 1)]
    elif mode == "right_side":
        ch_code = 9
        subs = [(samples[:, 0] - samples[:, 1], bps + 1),
                (samples[:, 1], bps)]
    elif mode == "mid_side":
        ch_code = 10
        side = samples[:, 0] - samples[:, 1]
        mid = (samples[:, 0] + samples[:, 1]) >> 1
        subs = [(mid, bps), (side, bps + 1)]
    else:
        raise ValueError(f"unknown stereo mode {mode!r}")

    header = bytearray()
    header += b"\xFF\xF8"  # sync + fixed blocking
    bs_code = _BS_CODE_INV.get(block_size, 7)
    sr_code = _SR_CODE_INV.get(sample_rate, 0)
    header.append((bs_code << 4) | sr_code)
    ss_code = _SS_CODE_INV[bps]
    header.append((ch_code << 4) | (ss_code << 1))
    header += _utf8_encode(frame_no)
    if bs_code == 7:
        header += struct.pack(">H", block_size - 1)
    header.append(_crc8(bytes(header)))

    bw = _BitWriter()
    bw.write_bytes(bytes(header))
    for sig, sub_bps in subs:
        _encode_subframe(bw, np.asarray(sig, np.int64), sub_bps,
                         block_size, opts)
    bw.align()
    body = bw.getvalue()
    return body + struct.pack(">H", _crc16(body))


def write_flac(path, data: np.ndarray, sample_rate: int, *, bits: int = 16,
               block_size: int = 4096, stereo_mode: str = "auto",
               lpc_order: int | None = None, seektable_every: int = 10,
               partition_order: int = 4, force_verbatim: bool = False,
               use_escape: bool = False, detect_wasted: bool = True):
    """Write [T, C] or [T] float (or already-int) data as FLAC.

    Float input is quantized to `bits`; int input is taken as raw samples.
    Keyword knobs exist so tests can force every bitstream feature the
    decoder must handle (verbatim subframes, escape partitions, each stereo
    decorrelation mode, LPC, wasted bits).
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    t, ch = data.shape
    if np.issubdtype(data.dtype, np.floating):
        lim = 1 << (bits - 1)
        samples = np.clip(np.round(data * lim), -lim, lim - 1).astype(np.int64)
    else:
        samples = data.astype(np.int64)
        lim = 1 << (bits - 1)
        if samples.size and (samples.max() >= lim or samples.min() < -lim):
            # integer input wider than `bits` would wrap modulo 2^bits in
            # both the bitstream and the MD5 — a spec-valid file of garbage
            raise ValueError(
                f"write_flac: integer samples exceed {bits}-bit range "
                f"[{-lim}, {lim - 1}] (got min {samples.min()}, max "
                f"{samples.max()}); scale or pass a wider bits=")

    # STREAMINFO MD5: interleaved little-endian samples, bits/8 bytes each
    md5 = hashlib.md5()
    flat = samples.reshape(-1)
    if bits == 16:
        md5.update(flat.astype("<i2").tobytes())
    elif bits == 8:
        md5.update(flat.astype("<i1").tobytes())
    elif bits == 24:
        b = np.empty((flat.size, 3), np.uint8)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        md5.update(b.tobytes())
    elif bits == 32:
        md5.update(flat.astype("<i4").tobytes())
    else:
        raise ValueError(f"unsupported bit depth {bits}")

    opts = dict(lpc_order=lpc_order, partition_order=partition_order,
                force_verbatim=force_verbatim, use_escape=use_escape,
                detect_wasted=detect_wasted)

    frames = []
    seekpoints = []
    offset = 0
    n_frames = (t + block_size - 1) // block_size
    for fi in range(n_frames):
        lo = fi * block_size
        hi = min(lo + block_size, t)
        if seektable_every and fi % seektable_every == 0:
            seekpoints.append((lo, offset, hi - lo))
        enc = _encode_frame(samples[lo:hi], fi, sample_rate, bits,
                            stereo_mode, opts)
        frames.append(enc)
        offset += len(enc)

    framesizes = [len(f) for f in frames] or [0]
    si = _BitWriter()
    si.write(block_size, 16)                     # min block size
    si.write(block_size, 16)                     # max block size
    si.write(min(framesizes), 24)
    si.write(max(framesizes), 24)
    si.write(sample_rate, 20)
    si.write(ch - 1, 3)
    si.write(bits - 1, 5)
    si.write(t, 36)
    streaminfo = si.getvalue() + md5.digest()

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"fLaC")
        last_meta = 0x80 if not seekpoints else 0
        f.write(bytes([last_meta | 0]) + len(streaminfo).to_bytes(3, "big"))
        f.write(streaminfo)
        if seekpoints:
            body = b"".join(struct.pack(">QQH", s, off, n)
                            for s, off, n in seekpoints)
            f.write(bytes([0x80 | 3]) + len(body).to_bytes(3, "big"))
            f.write(body)
        for enc in frames:
            f.write(enc)
