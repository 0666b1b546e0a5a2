// Native FLAC decoder — see flacio.cpp. Reached through the wavio_* entry
// points (wavio.cpp sniffs the file magic and dispatches), so the Python
// bindings and the batch thread pool work unchanged for .flac inputs.
#ifndef FLACIO_H_
#define FLACIO_H_

#include <cstdint>

namespace flacio {

// -> 0 on success, negative error code otherwise.
int InfoFile(const char* path, int32_t* sample_rate, int32_t* channels,
             int64_t* frames, int32_t* bits);

// Decode frames [start, start+frames) into float32 `out`
// (frames * (mono ? 1 : channels) floats). frames < 0 => to EOF.
// -> frames actually read, or negative error code.
int64_t ReadFile(const char* path, int64_t start, int64_t frames, int mono,
                 float* out);

}  // namespace flacio

#endif  // FLACIO_H_
