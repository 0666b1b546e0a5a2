// Native WAV decode/encode + parallel batch chunk reader, the port's copy of
// native/wavio.cpp.
//
// The host-side hot path of the training data loader: it decodes WAV chunks
// (PCM 16/24/32, float32) straight into caller-provided float32 buffers and
// fans a batch of chunk reads across a thread pool with no GIL involvement
// (called via ctypes).
//
// Exposed C ABI (see ml_audio_restoration_torch/audio/native.py):
//   wavio_info(path, *sr, *channels, *frames, *bits, *fmt)       -> 0/err
//   wavio_read(path, start, frames, mono, out)                   -> read frames/err
//   wavio_read_batch(paths, starts, frames, mono, outs, n, threads) -> 0/err
//   wavio_write_pcm16(path, data, frames, channels, sr)          -> 0/err

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "flacio.h"

namespace {

// FLAC files flow through the same entry points: the magic sniff below
// routes them to the native FLAC decoder (flacio.cpp). fmt is reported as
// this marker value so callers can tell the container apart.
constexpr int32_t kFmtFlac = 0xF1AC;

bool IsFlac(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  char magic[4] = {0};
  const size_t got = fread(magic, 1, 4, f);
  fclose(f);
  return got == 4 && memcmp(magic, "fLaC", 4) == 0;
}

constexpr uint16_t kPcm = 1;
constexpr uint16_t kFloat = 3;
constexpr uint16_t kExtensible = 0xFFFE;

struct WavHeader {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t fmt = 0;
  int64_t data_offset = 0;
  int64_t data_size = 0;
  int64_t frames = 0;
};

int ParseHeader(FILE* f, WavHeader* h) {
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || fread(&riff_size, 4, 1, f) != 1 ||
      fread(wave, 1, 4, f) != 4)
    return -1;
  if (memcmp(riff, "RIFF", 4) != 0 || memcmp(wave, "WAVE", 4) != 0) return -2;

  bool have_fmt = false, have_data = false;
  while (!have_fmt || !have_data) {
    char cid[4];
    uint32_t csize;
    if (fread(cid, 1, 4, f) != 4 || fread(&csize, 4, 1, f) != 1) break;
    if (memcmp(cid, "fmt ", 4) == 0) {
      // A valid fmt chunk is >= 16 bytes; the scrapers feed this parser
      // untrusted downloads, so reject truncated chunks before the memcpys.
      if (csize < 16) return -3;
      std::vector<uint8_t> buf(csize);
      if (fread(buf.data(), 1, csize, f) != csize) return -3;
      uint16_t fmt, channels, bits;
      uint32_t rate;
      memcpy(&fmt, buf.data(), 2);
      memcpy(&channels, buf.data() + 2, 2);
      memcpy(&rate, buf.data() + 4, 4);
      memcpy(&bits, buf.data() + 14, 2);
      if (fmt == kExtensible && csize >= 40) memcpy(&fmt, buf.data() + 24, 2);
      h->fmt = fmt;
      h->channels = channels;
      h->sample_rate = rate;
      h->bits = bits;
      have_fmt = true;
      if (csize & 1) fseek(f, 1, SEEK_CUR);
    } else if (memcmp(cid, "data", 4) == 0) {
      h->data_offset = ftell(f);
      h->data_size = csize;
      have_data = true;
      fseek(f, static_cast<long>(csize + (csize & 1)), SEEK_CUR);
    } else {
      fseek(f, static_cast<long>(csize + (csize & 1)), SEEK_CUR);
    }
  }
  if (!have_fmt || !have_data) return -4;
  const int bpf = h->channels * h->bits / 8;
  if (bpf <= 0) return -5;
  h->frames = h->data_size / bpf;
  return 0;
}

// Decode `frames` frames of raw bytes into float32. Returns false on
// unsupported format.
bool DecodeTo(const uint8_t* raw, int64_t frames, const WavHeader& h,
              bool mono, float* out) {
  const int ch = h.channels;
  const double inv16 = 1.0 / 32768.0;
  const double inv24 = 1.0 / 8388608.0;
  const double inv32 = 1.0 / 2147483648.0;
  for (int64_t i = 0; i < frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < ch; ++c) {
      float v;
      const int64_t idx = i * ch + c;
      if (h.fmt == kFloat && h.bits == 32) {
        float tmp;
        memcpy(&tmp, raw + idx * 4, 4);
        v = tmp;
      } else if (h.fmt == kFloat && h.bits == 64) {
        double tmp;
        memcpy(&tmp, raw + idx * 8, 8);
        v = static_cast<float>(tmp);
      } else if (h.fmt == kPcm && h.bits == 16) {
        int16_t tmp;
        memcpy(&tmp, raw + idx * 2, 2);
        v = static_cast<float>(tmp * inv16);
      } else if (h.fmt == kPcm && h.bits == 24) {
        const uint8_t* p = raw + idx * 3;
        int32_t tmp = p[0] | (p[1] << 8) | (p[2] << 16);
        if (tmp >= (1 << 23)) tmp -= (1 << 24);
        v = static_cast<float>(tmp * inv24);
      } else if (h.fmt == kPcm && h.bits == 32) {
        int32_t tmp;
        memcpy(&tmp, raw + idx * 4, 4);
        v = static_cast<float>(tmp * inv32);
      } else if (h.fmt == kPcm && h.bits == 8) {
        v = (static_cast<float>(raw[idx]) - 128.0f) / 128.0f;
      } else {
        return false;
      }
      if (mono)
        acc += v;
      else
        out[i * ch + c] = v;
    }
    if (mono) out[i] = acc / static_cast<float>(ch);
  }
  return true;
}

int ReadChunk(const char* path, int64_t start, int64_t frames, int mono,
              float* out, int64_t* frames_read) {
  if (IsFlac(path)) {
    const int64_t got = flacio::ReadFile(path, start, frames, mono, out);
    if (got < 0) return static_cast<int>(got);
    *frames_read = got;
    return 0;
  }
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  WavHeader h;
  int rc = ParseHeader(f, &h);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  if (start < 0) start = 0;
  if (start > h.frames) start = h.frames;
  int64_t n = (frames < 0) ? h.frames - start
                           : std::min<int64_t>(frames, h.frames - start);
  const int bpf = h.channels * h.bits / 8;
  if (fseek(f, static_cast<long>(h.data_offset + start * bpf), SEEK_SET) != 0) {
    fclose(f);
    return -11;
  }
  std::vector<uint8_t> raw(static_cast<size_t>(n) * bpf);
  const size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  n = static_cast<int64_t>(got) / bpf;
  if (!DecodeTo(raw.data(), n, h, mono != 0, out)) return -12;
  *frames_read = n;
  return 0;
}

}  // namespace

extern "C" {

// Capability probe for the Python bindings: a library exporting this symbol
// decodes FLAC through the wavio_* entry points.
int wavio_has_flac(void) { return 1; }

int wavio_info(const char* path, int32_t* sample_rate, int32_t* channels,
               int64_t* frames, int32_t* bits, int32_t* fmt) {
  if (IsFlac(path)) {
    const int rc = flacio::InfoFile(path, sample_rate, channels, frames,
                                    bits);
    if (rc == 0) *fmt = kFmtFlac;
    return rc;
  }
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  WavHeader h;
  const int rc = ParseHeader(f, &h);
  fclose(f);
  if (rc != 0) return rc;
  *sample_rate = static_cast<int32_t>(h.sample_rate);
  *channels = h.channels;
  *frames = h.frames;
  *bits = h.bits;
  *fmt = h.fmt;
  return 0;
}

// out must hold frames * (mono ? 1 : channels) floats.
int64_t wavio_read(const char* path, int64_t start, int64_t frames, int mono,
                   float* out) {
  int64_t read = 0;
  const int rc = ReadChunk(path, start, frames, mono, out, &read);
  return rc == 0 ? read : rc;
}

// Batch chunk reader: n jobs over a thread pool. Each out[i] must hold
// frames * (mono ? 1 : channels_i) floats; short reads are zero-padded to
// `frames` (mono only).
int wavio_read_batch(const char** paths, const int64_t* starts, int64_t frames,
                     int mono, float** outs, int n, int threads) {
  if (threads < 1) threads = 1;
  std::vector<int> rcs(n, 0);
  std::vector<std::thread> pool;
  std::atomic_int next{0};
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int64_t read = 0;
      rcs[i] = ReadChunk(paths[i], starts[i], frames, mono, outs[i], &read);
      if (rcs[i] == 0 && mono && read < frames)
        memset(outs[i] + read, 0, sizeof(float) * (frames - read));
    }
  };
  const int nt = std::min<int>(threads, n);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  for (int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

int wavio_write_pcm16(const char* path, const float* data, int64_t frames,
                      int channels, int sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -10;
  const int64_t samples = frames * channels;
  const uint32_t payload = static_cast<uint32_t>(samples * 2);
  const int bpf = channels * 2;
  uint32_t riff_size = 36 + payload;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_size, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  uint32_t fmt_size = 16;
  uint16_t fmt = kPcm, ch = static_cast<uint16_t>(channels), bits = 16;
  uint32_t rate = static_cast<uint32_t>(sample_rate);
  uint32_t brate = rate * bpf;
  uint16_t align = static_cast<uint16_t>(bpf);
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt, 2, 1, f);
  fwrite(&ch, 2, 1, f);
  fwrite(&rate, 4, 1, f);
  fwrite(&brate, 4, 1, f);
  fwrite(&align, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&payload, 4, 1, f);
  std::vector<int16_t> buf(static_cast<size_t>(samples));
  for (int64_t i = 0; i < samples; ++i) {
    float v = data[i] * 32768.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    buf[i] = static_cast<int16_t>(lrintf(v));
  }
  // short write (ENOSPC/EIO) or a failed flush at close must NOT report
  // success: the caller would record a truncated WAV as a good restore
  const size_t wrote = fwrite(buf.data(), 2, buf.size(), f);
  int pad_ok = 1;
  if (payload & 1) pad_ok = (fputc(0, f) != EOF);
  const int close_ok = (fclose(f) == 0);
  if (wrote != buf.size() || !pad_ok || !close_ok) return -11;
  return 0;
}

}  // extern "C"
