// Native FLAC decoder, the port's copy of native/flacio.cpp (no libFLAC is
// needed). It is reached through the wavio_* entry points of wavio.cpp,
// which sniff the file magic. The semantics reference is the numpy codec
// in ml_audio_restoration_torch/audio/flac.py, which the tests hold this
// implementation bit-identical to.
//
// Supported: all subframe types (CONSTANT, VERBATIM, FIXED 0-4, LPC 1-32),
// RICE/RICE2 partitioned residuals incl. escape codes, wasted bits, all
// stereo decorrelation modes, 8-32 bit depth, frame CRC-8/CRC-16
// verification, SEEKTABLE-assisted (else skip-decode) partial reads.

#include "flacio.h"

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace flacio {
namespace {

// ------------------------------------------------------------------- CRC

struct CrcTables {
  uint8_t crc8[256];
  uint16_t crc16[256];
  CrcTables() {
    for (int i = 0; i < 256; ++i) {
      uint32_t c8 = static_cast<uint32_t>(i);
      for (int b = 0; b < 8; ++b) c8 = (c8 & 0x80u) ? ((c8 << 1) ^ 0x07u) : (c8 << 1);
      crc8[i] = static_cast<uint8_t>(c8);
      uint32_t c16 = static_cast<uint32_t>(i) << 8;
      for (int b = 0; b < 8; ++b)
        c16 = (c16 & 0x8000u) ? ((c16 << 1) ^ 0x8005u) : (c16 << 1);
      crc16[i] = static_cast<uint16_t>(c16);
    }
  }
};
const CrcTables kCrc;

uint8_t Crc8(const uint8_t* p, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) c = kCrc.crc8[c ^ p[i]];
  return c;
}

uint16_t Crc16(const uint8_t* p, size_t n) {
  uint16_t c = 0;
  for (size_t i = 0; i < n; ++i)
    c = static_cast<uint16_t>((c << 8) ^ kCrc.crc16[((c >> 8) ^ p[i]) & 0xFF]);
  return c;
}

// --------------------------------------------------------------- BitReader

struct BitReader {
  const uint8_t* data;
  size_t size;      // bytes
  size_t pos = 0;   // bits
  bool ok = true;

  BitReader(const uint8_t* d, size_t s, size_t pos_bits = 0)
      : data(d), size(s), pos(pos_bits) {}

  // n in [0, 57]
  uint64_t ReadBits(int n) {
    if (n == 0) return 0;
    const size_t byte = pos >> 3;
    const int off = static_cast<int>(pos & 7);
    if (pos + static_cast<size_t>(n) > size * 8) {
      ok = false;
      pos += n;
      return 0;
    }
    uint64_t x;
    if (byte + 8 <= size) {
      memcpy(&x, data + byte, 8);
      x = __builtin_bswap64(x);
    } else {
      x = 0;
      for (int i = 0; i < 8; ++i)
        x = (x << 8) | (byte + i < size ? data[byte + i] : 0);
    }
    pos += n;
    return (x << off) >> (64 - n);
  }

  int64_t ReadSigned(int n) {
    const uint64_t v = ReadBits(n);
    const uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? static_cast<int64_t>(v) - (1ll << n)
                      : static_cast<int64_t>(v);
  }

  uint32_t ReadUnary() {
    uint32_t q = 0;
    while (true) {
      const size_t byte = pos >> 3;
      if (byte >= size) {
        ok = false;
        return 0;
      }
      const int off = static_cast<int>(pos & 7);
      const uint8_t cur = data[byte] & static_cast<uint8_t>(0xFF >> off);
      if (cur == 0) {
        q += 8 - off;
        pos += 8 - off;
      } else {
        const int hb = 31 - __builtin_clz(cur);  // highest set bit (from LSB)
        const int zeros = (7 - off) - hb;
        pos += zeros + 1;
        return q + zeros;
      }
    }
  }

  void Align() { pos = (pos + 7) & ~static_cast<size_t>(7); }
  size_t BytePos() const { return pos >> 3; }
};

// ---------------------------------------------------------------- metadata

struct SeekPoint {
  uint64_t sample;
  uint64_t offset;  // from first frame
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bits = 0;
  int64_t total = 0;
  uint32_t block_size = 0;  // nominal (max)
  size_t first_frame_offset = 0;
  std::vector<SeekPoint> seektable;
};

int ParseMetadata(const std::vector<uint8_t>& d, StreamInfo* si) {
  if (d.size() < 8 || memcmp(d.data(), "fLaC", 4) != 0) return -20;
  size_t pos = 4;
  bool have_streaminfo = false;
  while (true) {
    if (pos + 4 > d.size()) return -21;
    const uint8_t hdr = d[pos];
    const bool last = hdr & 0x80;
    const int btype = hdr & 0x7F;
    const size_t len = (static_cast<size_t>(d[pos + 1]) << 16) |
                       (static_cast<size_t>(d[pos + 2]) << 8) | d[pos + 3];
    if (pos + 4 + len > d.size()) return -21;
    const uint8_t* body = d.data() + pos + 4;
    if (btype == 0) {
      if (len < 34) return -21;
      BitReader br(body, len);
      br.ReadBits(16);  // min blocksize
      si->block_size = static_cast<uint32_t>(br.ReadBits(16));
      br.ReadBits(24);
      br.ReadBits(24);
      si->sample_rate = static_cast<uint32_t>(br.ReadBits(20));
      si->channels = static_cast<int>(br.ReadBits(3)) + 1;
      si->bits = static_cast<int>(br.ReadBits(5)) + 1;
      si->total = static_cast<int64_t>(br.ReadBits(36));
      have_streaminfo = true;
    } else if (btype == 3) {
      for (size_t i = 0; i + 18 <= len; i += 18) {
        SeekPoint pt;
        uint64_t sample = 0, off = 0;
        for (int b = 0; b < 8; ++b) sample = (sample << 8) | body[i + b];
        for (int b = 0; b < 8; ++b) off = (off << 8) | body[i + 8 + b];
        if (sample == ~0ull) continue;  // placeholder
        pt.sample = sample;
        pt.offset = off;
        si->seektable.push_back(pt);
      }
    }
    pos += 4 + len;
    if (last) break;
  }
  if (!have_streaminfo) return -22;
  si->first_frame_offset = pos;
  return 0;
}

// ------------------------------------------------------------------ frames

const uint32_t kBlockSizes[16] = {0,   192,  576,  1152, 2304, 4608, 0,    0,
                                  256, 512,  1024, 2048, 4096, 8192, 16384, 32768};
const int kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};

bool ReadUtf8(BitReader* br, uint64_t* out) {
  const uint32_t first = static_cast<uint32_t>(br->ReadBits(8));
  if (first < 0x80) {
    *out = first;
    return true;
  }
  int n_cont = 0;
  uint32_t mask = 0x40;
  while (first & mask) {
    ++n_cont;
    mask >>= 1;
  }
  if (n_cont < 1 || n_cont > 6) return false;
  uint64_t val = first & (mask - 1);
  for (int i = 0; i < n_cont; ++i) {
    const uint32_t b = static_cast<uint32_t>(br->ReadBits(8));
    if ((b & 0xC0) != 0x80) return false;
    val = (val << 6) | (b & 0x3F);
  }
  *out = val;
  return true;
}

bool DecodeResidual(BitReader* br, uint32_t block_size, int order,
                    int64_t* out) {
  const uint32_t method = static_cast<uint32_t>(br->ReadBits(2));
  if (method > 1) return false;
  const int plen = method == 0 ? 4 : 5;
  const uint32_t escape = (1u << plen) - 1;
  const uint32_t po = static_cast<uint32_t>(br->ReadBits(4));
  const uint32_t nparts = 1u << po;
  if (block_size % nparts != 0 ||
      (block_size >> po) <= static_cast<uint32_t>(order))
    return false;
  size_t idx = 0;
  for (uint32_t p = 0; p < nparts; ++p) {
    const uint32_t count = (block_size >> po) - (p == 0 ? order : 0);
    const uint32_t param = static_cast<uint32_t>(br->ReadBits(plen));
    if (param == escape) {
      const int raw = static_cast<int>(br->ReadBits(5));
      if (raw == 0) {
        memset(out + idx, 0, count * sizeof(int64_t));
        idx += count;
      } else {
        for (uint32_t i = 0; i < count; ++i) out[idx++] = br->ReadSigned(raw);
      }
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        const uint64_t q = br->ReadUnary();
        const uint64_t v = (q << param) | br->ReadBits(param);
        out[idx++] = static_cast<int64_t>(v >> 1) ^
                     -static_cast<int64_t>(v & 1);
      }
    }
    if (!br->ok) return false;
  }
  return true;
}

// buf holds block_size int64s; residual decoded into buf[order:].
bool DecodeSubframe(BitReader* br, uint32_t block_size, int bps,
                    int64_t* buf) {
  if (br->ReadBits(1)) return false;  // padding bit
  const uint32_t stype = static_cast<uint32_t>(br->ReadBits(6));
  int wasted = 0;
  if (br->ReadBits(1)) wasted = static_cast<int>(br->ReadUnary()) + 1;
  const int ebps = bps - wasted;
  if (ebps <= 0 || ebps > 33) return false;

  if (stype == 0) {  // CONSTANT
    const int64_t v = br->ReadSigned(ebps);
    for (uint32_t i = 0; i < block_size; ++i) buf[i] = v;
  } else if (stype == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) buf[i] = br->ReadSigned(ebps);
  } else if (stype >= 8 && stype <= 12) {  // FIXED
    const int order = static_cast<int>(stype - 8);
    // same guard the LPC path has: without it a crafted 1-sample block
    // with order 4 writes warmup samples past the block buffer (heap
    // overflow) before DecodeResidual's partition check can reject it
    if (static_cast<uint32_t>(order) > block_size) return false;
    for (int i = 0; i < order; ++i) buf[i] = br->ReadSigned(ebps);
    if (!DecodeResidual(br, block_size, order, buf + order)) return false;
    switch (order) {
      case 0:
        break;
      case 1:
        for (uint32_t i = 1; i < block_size; ++i) buf[i] += buf[i - 1];
        break;
      case 2:
        for (uint32_t i = 2; i < block_size; ++i)
          buf[i] += 2 * buf[i - 1] - buf[i - 2];
        break;
      case 3:
        for (uint32_t i = 3; i < block_size; ++i)
          buf[i] += 3 * buf[i - 1] - 3 * buf[i - 2] + buf[i - 3];
        break;
      case 4:
        for (uint32_t i = 4; i < block_size; ++i)
          buf[i] += 4 * buf[i - 1] - 6 * buf[i - 2] + 4 * buf[i - 3] -
                    buf[i - 4];
        break;
      default:
        return false;
    }
  } else if (stype >= 32) {  // LPC
    const int order = static_cast<int>(stype & 0x1F) + 1;
    if (static_cast<uint32_t>(order) > block_size) return false;
    for (int i = 0; i < order; ++i) buf[i] = br->ReadSigned(ebps);
    const int precision = static_cast<int>(br->ReadBits(4)) + 1;
    if (precision == 16) return false;
    const int shift = static_cast<int>(br->ReadSigned(5));
    if (shift < 0) return false;
    int64_t coefs[32];
    for (int i = 0; i < order; ++i) coefs[i] = br->ReadSigned(precision);
    if (!DecodeResidual(br, block_size, order, buf + order)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coefs[j] * buf[i - 1 - j];
      buf[i] += acc >> shift;
    }
  } else {
    return false;  // reserved
  }
  if (!br->ok) return false;
  if (wasted)
    for (uint32_t i = 0; i < block_size; ++i) buf[i] <<= wasted;
  return true;
}

struct Frame {
  uint32_t block_size = 0;
  int64_t first_sample = 0;
  size_t next_offset = 0;
  // channel-major samples: ch[c][i]
  std::vector<std::vector<int64_t>> ch;
};

// Decode one frame starting at byte `offset`. -> 0 ok, negative error.
int DecodeFrame(const std::vector<uint8_t>& d, size_t offset,
                const StreamInfo& si, Frame* fr) {
  BitReader br(d.data(), d.size(), offset << 3);
  if (br.ReadBits(14) != 0x3FFE) return -23;
  if (br.ReadBits(1)) return -23;
  const bool variable = br.ReadBits(1);
  const uint32_t bs_code = static_cast<uint32_t>(br.ReadBits(4));
  const uint32_t sr_code = static_cast<uint32_t>(br.ReadBits(4));
  const uint32_t ch_code = static_cast<uint32_t>(br.ReadBits(4));
  const uint32_t ss_code = static_cast<uint32_t>(br.ReadBits(3));
  if (br.ReadBits(1)) return -23;
  uint64_t coded = 0;
  if (!ReadUtf8(&br, &coded)) return -23;
  uint32_t block_size;
  if (bs_code == 0 || bs_code == 6 || bs_code == 7) {
    if (bs_code == 0) return -23;
    block_size = static_cast<uint32_t>(
                     br.ReadBits(bs_code == 6 ? 8 : 16)) + 1;
  } else {
    block_size = kBlockSizes[bs_code];
  }
  if (sr_code == 12) br.ReadBits(8);
  else if (sr_code == 13 || sr_code == 14) br.ReadBits(16);
  else if (sr_code == 15) return -23;
  const size_t header_end = br.BytePos();
  const uint32_t crc8 = static_cast<uint32_t>(br.ReadBits(8));
  if (!br.ok) return -23;
  if (Crc8(d.data() + offset, header_end - offset) != crc8) return -24;

  const int bps = ss_code ? kSampleSizes[ss_code] : si.bits;
  if (bps == 0) return -23;
  fr->block_size = block_size;
  fr->first_sample = variable
                         ? static_cast<int64_t>(coded)
                         : static_cast<int64_t>(coded) * si.block_size;

  int channels;
  if (ch_code <= 7) channels = static_cast<int>(ch_code) + 1;
  else if (ch_code <= 10) channels = 2;
  else return -23;
  fr->ch.assign(channels, std::vector<int64_t>(block_size));

  if (ch_code <= 7) {
    for (int c = 0; c < channels; ++c)
      if (!DecodeSubframe(&br, block_size, bps, fr->ch[c].data()))
        return -25;
  } else {
    const int side_ch = (ch_code == 9) ? 0 : 1;
    for (int c = 0; c < 2; ++c)
      if (!DecodeSubframe(&br, block_size, bps + (c == side_ch ? 1 : 0),
                          fr->ch[c].data()))
        return -25;
    int64_t* a = fr->ch[0].data();
    int64_t* b = fr->ch[1].data();
    if (ch_code == 8) {  // left/side -> right = left - side
      for (uint32_t i = 0; i < block_size; ++i) b[i] = a[i] - b[i];
    } else if (ch_code == 9) {  // side/right -> left = right + side
      for (uint32_t i = 0; i < block_size; ++i) a[i] = b[i] + a[i];
    } else {  // mid/side
      for (uint32_t i = 0; i < block_size; ++i) {
        const int64_t side = b[i];
        const int64_t mid2 = (a[i] << 1) | (side & 1);
        a[i] = (mid2 + side) >> 1;
        b[i] = (mid2 - side) >> 1;
      }
    }
  }

  br.Align();
  const size_t crc_pos = br.BytePos();
  const uint32_t crc16 = static_cast<uint32_t>(br.ReadBits(16));
  if (!br.ok) return -23;
  if (Crc16(d.data() + offset, crc_pos - offset) != crc16) return -24;
  fr->next_offset = br.BytePos();
  return 0;
}

int ReadWholeFile(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  fseek(f, 0, SEEK_END);
  const long sz = ftell(f);
  if (sz < 0) {
    fclose(f);
    return -10;
  }
  fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(sz));
  const size_t got = fread(out->data(), 1, out->size(), f);
  fclose(f);
  if (got != out->size()) return -10;
  return 0;
}

}  // namespace

int InfoFile(const char* path, int32_t* sample_rate, int32_t* channels,
             int64_t* frames, int32_t* bits) {
  std::vector<uint8_t> d;
  int rc = ReadWholeFile(path, &d);
  if (rc != 0) return rc;
  StreamInfo si;
  rc = ParseMetadata(d, &si);
  if (rc != 0) return rc;
  if (si.total == 0) return -26;  // unknown length: Python handles it
  *sample_rate = static_cast<int32_t>(si.sample_rate);
  *channels = si.channels;
  *frames = si.total;
  *bits = si.bits;
  return 0;
}

int64_t ReadFile(const char* path, int64_t start, int64_t frames, int mono,
                 float* out) {
  std::vector<uint8_t> d;
  int rc = ReadWholeFile(path, &d);
  if (rc != 0) return rc;
  StreamInfo si;
  rc = ParseMetadata(d, &si);
  if (rc != 0) return rc;
  // STREAMINFO total_samples == 0 means UNKNOWN length (streamed encode),
  // not an empty file: bail to the Python decoder rather than silently
  // returning zero samples
  if (si.total == 0) return -26;

  if (start < 0) start = 0;
  if (start > si.total) start = si.total;
  const int64_t n =
      frames < 0 ? si.total - start
                 : (frames < si.total - start ? frames : si.total - start);
  const int64_t end = start + n;
  const int out_ch = mono ? 1 : si.channels;
  const double scale = 1.0 / static_cast<double>(1ll << (si.bits - 1));

  size_t offset = si.first_frame_offset;
  if (start > 0 && !si.seektable.empty()) {
    uint64_t best_off = 0;
    uint64_t best_sample = 0;
    bool found = false;
    for (const SeekPoint& pt : si.seektable) {
      if (pt.sample <= static_cast<uint64_t>(start) &&
          (!found || pt.sample >= best_sample)) {
        best_sample = pt.sample;
        best_off = pt.offset;
        found = true;
      }
    }
    if (found) offset = si.first_frame_offset + best_off;
  }

  Frame fr;
  int64_t written_hi = start;  // absolute sample index written so far
  while (offset < d.size() && written_hi < end) {
    rc = DecodeFrame(d, offset, si, &fr);
    if (rc != 0) return rc;
    offset = fr.next_offset;
    const int64_t f_lo = fr.first_sample;
    const int64_t f_hi = f_lo + fr.block_size;
    const int64_t lo = f_lo > start ? f_lo : start;
    const int64_t hi = f_hi < end ? f_hi : end;
    if (hi > lo) {
      if (lo > written_hi) {
        // gap before this frame (stale/crafted seekpoint, non-contiguous
        // frame numbering): zero-fill so the caller never reads
        // uninitialized buffer memory counted as "written"
        for (int64_t i = written_hi; i < lo; ++i)
          for (int c = 0; c < out_ch; ++c) out[(i - start) * out_ch + c] = 0.f;
      }
      const int nch = static_cast<int>(fr.ch.size());
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t src = i - f_lo;
        const int64_t dst = i - start;
        if (mono) {
          double acc = 0;
          for (int c = 0; c < nch; ++c)
            acc += static_cast<double>(fr.ch[c][src]) * scale;
          out[dst] = static_cast<float>(acc / nch);
        } else {
          for (int c = 0; c < nch; ++c)
            out[dst * out_ch + c] =
                static_cast<float>(static_cast<double>(fr.ch[c][src]) * scale);
        }
      }
      written_hi = hi;
    }
    if (f_hi >= end) break;
  }
  return written_hi - start;
}

}  // namespace flacio
