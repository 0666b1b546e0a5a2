"""mp3/ogg codec support via the system codec libraries (ctypes), the
port's copy of ml_audio_restoration_tpu/audio/codecs.py.

libmpg123 (mp3 decode) and libvorbisfile (ogg decode) are stable C ABIs
bound here with ctypes, no compilation needed. Encoders (libmp3lame /
libvorbis+libvorbisenc+libogg) are bound too. Every entry point returns
None (the writers False) when its library is missing; audio/io.py turns
that into an error.
"""
from __future__ import annotations

import ctypes
from ctypes import (POINTER, byref, c_char_p, c_float, c_int, c_long,
                    c_longlong, c_short, c_size_t, c_ubyte, c_void_p)
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["read", "read_mp3", "read_ogg", "mp3_available", "ogg_available",
           "write_mp3", "write_ogg"]


def _dlopen(*names):
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


# ----------------------------------------------------------------- libmpg123

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ADD_FLAGS = 2       # mpg123_parms enum
_MPG123_FORCE_FLOAT = 0x400  # MPG123_FORCE_FLOAT flag

_mpg123 = None
_mpg123_tried = False


def _load_mpg123():
    global _mpg123, _mpg123_tried
    if _mpg123_tried:
        return _mpg123
    _mpg123_tried = True
    lib = _dlopen("libmpg123.so.0", "libmpg123.so")
    if lib is None:
        return None
    try:
        lib.mpg123_init()
        lib.mpg123_new.restype = c_void_p
        lib.mpg123_new.argtypes = [c_char_p, POINTER(c_int)]
        lib.mpg123_open.argtypes = [c_void_p, c_char_p]
        lib.mpg123_getformat.argtypes = [c_void_p, POINTER(c_long),
                                         POINTER(c_int), POINTER(c_int)]
        lib.mpg123_param.argtypes = [c_void_p, c_int, c_long,
                                     ctypes.c_double]
        lib.mpg123_read.argtypes = [c_void_p, c_void_p, c_size_t,
                                    POINTER(c_size_t)]
        lib.mpg123_scan.argtypes = [c_void_p]
        lib.mpg123_length.restype = c_longlong
        lib.mpg123_length.argtypes = [c_void_p]
        lib.mpg123_seek.restype = c_longlong
        lib.mpg123_seek.argtypes = [c_void_p, c_longlong, c_int]
        lib.mpg123_close.argtypes = [c_void_p]
        lib.mpg123_delete.argtypes = [c_void_p]
    except AttributeError:
        return None
    _mpg123 = lib
    return lib


def mp3_available() -> bool:
    return _load_mpg123() is not None


def read_mp3(path, start: int = 0, frames: int = -1):
    """-> (float32 [T, C], sr) or None when libmpg123 is unavailable."""
    lib = _load_mpg123()
    if lib is None:
        return None
    err = c_int()
    h = lib.mpg123_new(None, byref(err))
    if not h:
        return None
    try:
        # force float32 output before open (a format change after open only
        # applies from the next stream, not the current one)
        lib.mpg123_param(h, _MPG123_ADD_FLAGS, _MPG123_FORCE_FLOAT, 0.0)
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            return None
        rate, ch, enc = c_long(), c_int(), c_int()
        if lib.mpg123_getformat(h, byref(rate), byref(ch),
                                byref(enc)) != _MPG123_OK:
            return None
        lib.mpg123_scan(h)
        total = int(lib.mpg123_length(h))
        channels = ch.value
        start = max(0, min(start, total))
        n = total - start if frames < 0 else min(frames, total - start)
        if start > 0 and lib.mpg123_seek(h, start, 0) < 0:
            return None
        out = np.empty(n * channels, np.float32)
        filled = 0  # floats
        want = n * channels
        buf = (ctypes.c_ubyte * (65536))()
        done = c_size_t()
        while filled < want:
            req = min(len(buf), (want - filled) * 4)
            rc = lib.mpg123_read(h, buf, req, byref(done))
            got = done.value // 4
            if got:
                out[filled:filled + got] = np.frombuffer(
                    buf, np.float32, count=got)
                filled += got
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                return None
        out = out[:filled - (filled % channels)]
        return out.reshape(-1, channels), int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


# -------------------------------------------------------------- libvorbisfile

class _VorbisInfo(ctypes.Structure):
    _fields_ = [("version", c_int), ("channels", c_int), ("rate", c_long),
                ("bitrate_upper", c_long), ("bitrate_nominal", c_long),
                ("bitrate_lower", c_long), ("bitrate_window", c_long),
                ("codec_setup", c_void_p)]


_vorbisfile = None
_vorbisfile_tried = False


def _load_vorbisfile():
    global _vorbisfile, _vorbisfile_tried
    if _vorbisfile_tried:
        return _vorbisfile
    _vorbisfile_tried = True
    lib = _dlopen("libvorbisfile.so.3", "libvorbisfile.so")
    if lib is None:
        return None
    try:
        lib.ov_fopen.argtypes = [c_char_p, c_void_p]
        lib.ov_info.restype = POINTER(_VorbisInfo)
        lib.ov_info.argtypes = [c_void_p, c_int]
        lib.ov_pcm_total.restype = c_longlong
        lib.ov_pcm_total.argtypes = [c_void_p, c_int]
        lib.ov_pcm_seek.argtypes = [c_void_p, c_longlong]
        lib.ov_read_float.restype = c_long
        lib.ov_read_float.argtypes = [
            c_void_p, POINTER(POINTER(POINTER(c_float))), c_int,
            POINTER(c_int)]
        lib.ov_clear.argtypes = [c_void_p]
    except AttributeError:
        return None
    _vorbisfile = lib
    return lib


def ogg_available() -> bool:
    return _load_vorbisfile() is not None


def read_ogg(path, start: int = 0, frames: int = -1):
    """-> (float32 [T, C], sr) or None when libvorbisfile is unavailable."""
    lib = _load_vorbisfile()
    if lib is None:
        return None
    vf = ctypes.create_string_buffer(2048)  # > sizeof(OggVorbis_File)
    if lib.ov_fopen(str(path).encode(), vf) != 0:
        return None
    try:
        info = lib.ov_info(vf, -1).contents
        channels, sr = info.channels, int(info.rate)
        total = int(lib.ov_pcm_total(vf, -1))
        start = max(0, min(start, total))
        n = total - start if frames < 0 else min(frames, total - start)
        if start > 0 and lib.ov_pcm_seek(vf, start) != 0:
            return None
        out = np.empty((n, channels), np.float32)
        filled = 0
        pcm = POINTER(POINTER(c_float))()
        bitstream = c_int()
        while filled < n:
            got = lib.ov_read_float(vf, byref(pcm), min(4096, n - filled),
                                    byref(bitstream))
            if got <= 0:
                break
            for c in range(channels):
                out[filled:filled + got, c] = np.ctypeslib.as_array(
                    pcm[c], shape=(got,))
            filled += got
        return out[:filled], sr
    finally:
        lib.ov_clear(vf)


# ----------------------------------------------------------------- dispatch

def read(path, start: int = 0, frames: int = -1):
    """Decode mp3/ogg by extension -> (float32 [T, C], sr) or None."""
    low = str(path).lower()
    if low.endswith(".mp3"):
        return read_mp3(path, start, frames)
    if low.endswith((".ogg", ".oga")):
        return read_ogg(path, start, frames)
    return None


# -------------------------------------------------------------- mp3 encoding

_lame = None
_lame_tried = False


def _load_lame():
    global _lame, _lame_tried
    if _lame_tried:
        return _lame
    _lame_tried = True
    lib = _dlopen("libmp3lame.so.0", "libmp3lame.so")
    if lib is None:
        return None
    try:
        lib.lame_init.restype = c_void_p
        for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
                   "lame_set_quality", "lame_set_brate"):
            getattr(lib, fn).argtypes = [c_void_p, c_int]
        lib.lame_init_params.argtypes = [c_void_p]
        lib.lame_encode_buffer.restype = c_int
        lib.lame_encode_buffer.argtypes = [
            c_void_p, POINTER(c_short), POINTER(c_short), c_int,
            POINTER(c_ubyte), c_int]
        lib.lame_encode_flush.restype = c_int
        lib.lame_encode_flush.argtypes = [c_void_p, POINTER(c_ubyte), c_int]
        lib.lame_close.argtypes = [c_void_p]
    except AttributeError:
        return None
    _lame = lib
    return lib


def write_mp3(path, data: np.ndarray, sample_rate: int,
              quality: int = 2) -> bool:
    """Encode [T, C] (C in {1,2}) float data; -> False if lame missing."""
    lib = _load_lame()
    if lib is None:
        return False
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    t, ch = data.shape
    pcm = np.clip(np.round(data * 32768.0), -32768, 32767).astype(np.int16)
    gfp = lib.lame_init()
    lib.lame_set_in_samplerate(gfp, sample_rate)
    lib.lame_set_num_channels(gfp, ch)
    lib.lame_set_quality(gfp, quality)
    lib.lame_init_params(gfp)
    left = np.ascontiguousarray(pcm[:, 0])
    right = np.ascontiguousarray(pcm[:, 1] if ch > 1 else pcm[:, 0])
    outsize = int(1.25 * t) + 7200
    out = (c_ubyte * outsize)()
    p16 = POINTER(c_short)
    n = lib.lame_encode_buffer(gfp, left.ctypes.data_as(p16),
                               right.ctypes.data_as(p16), t, out, outsize)
    if n < 0:
        lib.lame_close(gfp)
        return False
    tail = (c_ubyte * 7200)()
    m = lib.lame_encode_flush(gfp, tail, 7200)
    lib.lame_close(gfp)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(bytes(out[:n]))
        f.write(bytes(tail[:max(m, 0)]))
    return True


# -------------------------------------------------------------- ogg encoding

class _OggPacket(ctypes.Structure):
    _fields_ = [("packet", c_void_p), ("bytes", c_long), ("b_o_s", c_long),
                ("e_o_s", c_long), ("granulepos", c_longlong),
                ("packetno", c_longlong)]


class _OggPage(ctypes.Structure):
    _fields_ = [("header", POINTER(c_ubyte)), ("header_len", c_long),
                ("body", POINTER(c_ubyte)), ("body_len", c_long)]


_vorbisenc_libs = None
_vorbisenc_tried = False


def _load_vorbisenc():
    global _vorbisenc_libs, _vorbisenc_tried
    if _vorbisenc_tried:
        return _vorbisenc_libs
    _vorbisenc_tried = True
    ogg = _dlopen("libogg.so.0", "libogg.so")
    vorbis = _dlopen("libvorbis.so.0", "libvorbis.so")
    venc = _dlopen("libvorbisenc.so.2", "libvorbisenc.so")
    if not (ogg and vorbis and venc):
        return None
    try:
        venc.vorbis_encode_init_vbr.argtypes = [c_void_p, c_long, c_long,
                                                c_float]
        vorbis.vorbis_analysis_buffer.restype = POINTER(POINTER(c_float))
        vorbis.vorbis_analysis_buffer.argtypes = [c_void_p, c_int]
    except AttributeError:
        return None
    _vorbisenc_libs = (ogg, vorbis, venc)
    return _vorbisenc_libs


def write_ogg(path, data: np.ndarray, sample_rate: int,
              quality: float = 0.4) -> bool:
    """Encode [T, C] float data as Ogg Vorbis (the reference glob accepts
    .ogg); -> False when the vorbis encoder libs are missing."""
    libs = _load_vorbisenc()
    if libs is None:
        return False
    ogg, vorbis, venc = libs
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    t, ch = data.shape

    vi = ctypes.create_string_buffer(512)
    vc = ctypes.create_string_buffer(512)
    vd = ctypes.create_string_buffer(2048)
    vb = ctypes.create_string_buffer(1024)
    os_ = ctypes.create_string_buffer(1024)
    vorbis.vorbis_info_init(vi)
    if venc.vorbis_encode_init_vbr(vi, ch, sample_rate,
                                   c_float(quality)) != 0:
        return False
    vorbis.vorbis_comment_init(vc)
    vorbis.vorbis_analysis_init(vd, vi)
    vorbis.vorbis_block_init(vd, vb)
    ogg.ogg_stream_init(os_, 1)

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    hdr, hdr_comm, hdr_code = _OggPacket(), _OggPacket(), _OggPacket()
    page = _OggPage()
    packet = _OggPacket()
    with open(path, "wb") as f:

        def write_pages(flush: bool):
            fn = ogg.ogg_stream_flush if flush else ogg.ogg_stream_pageout
            while fn(os_, byref(page)) != 0:
                f.write(ctypes.string_at(page.header, page.header_len))
                f.write(ctypes.string_at(page.body, page.body_len))

        vorbis.vorbis_analysis_headerout(vd, vc, byref(hdr), byref(hdr_comm),
                                         byref(hdr_code))
        for h in (hdr, hdr_comm, hdr_code):
            ogg.ogg_stream_packetin(os_, byref(h))
        write_pages(flush=True)

        def drain():
            while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                vorbis.vorbis_analysis(vb, None)
                vorbis.vorbis_bitrate_addblock(vb)
                while vorbis.vorbis_bitrate_flushpacket(
                        vd, byref(packet)) == 1:
                    ogg.ogg_stream_packetin(os_, byref(packet))
                    write_pages(flush=False)

        block = 4096
        for lo in range(0, t, block):
            n = min(block, t - lo)
            buf = vorbis.vorbis_analysis_buffer(vd, n)
            for c in range(ch):
                np.ctypeslib.as_array(buf[c], shape=(n,))[:] = data[lo:lo + n,
                                                                    c]
            vorbis.vorbis_analysis_wrote(vd, n)
            drain()
        vorbis.vorbis_analysis_wrote(vd, 0)
        drain()
        write_pages(flush=True)

    ogg.ogg_stream_clear(os_)
    vorbis.vorbis_block_clear(vb)
    vorbis.vorbis_dsp_clear(vd)
    vorbis.vorbis_comment_clear(vc)
    vorbis.vorbis_info_clear(vi)
    return True
