// IIR scans over time, one thread a row: the hand kernel behind
// ops/iir.py, in place of the lax.scan of the JAX package's
// ops/filters.py::sosfilt (the biquad cascade) and ::lfilter (direct form II
// transposed).
//
// x and y are [rows, len] row-major; every row carries its own
// coefficients and initial state, so one launch filters a batch whose items
// have different filters (the simulator's per-item roll-off cutoff):
//   biquads: sos [rows, S, 6] (b0 b1 b2 a0 a1 a2, a0 taken as 1),
//            zi [rows, S, 2], S <= 4;
//   DF2T:    ba [rows, 2 (N + 1)] (b0..bN then a0..aN, normalised so that
//            a0 = 1), zi [rows, N], order N <= 8.
// Each step is the JAX step function's operations in its order, each
// rounded on its own (the library is built with -fmad=false), so a walk
// equals ops/iir.py's plain loop bit for bit.
//
// The adjoint kernels walk the same rows in reverse time: given the
// cotangent gy of y they return gx and the cotangent of the initial state
// (the state after the last step is discarded, so its cotangent is 0). The
// filters are linear, so nothing of the forward walk is saved. The adjoint
// is the transposed recursion, an all-pole one whose state for a pole near
// the unit circle (the 100 Hz rumble low-pass) grows far above its output
// and cancels; it runs in double whatever the data's type, and rounds
// once on the way out.
//
// The coefficients and the state live in registers; the input is read
// AHEAD steps in front of the walk so that the loads are in flight while
// the dependent chain runs.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;
constexpr int kAhead = 8;

template <typename T>
__device__ __forceinline__ void load_block(const T* __restrict__ src, int t0,
                                           int len, int dir, T (&buf)[kAhead]) {
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int t = t0 + dir * j;
    buf[j] = (t >= 0 && t < len) ? src[t] : T(0);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kBlock)
    sos_forward(const T* __restrict__ x, const T* __restrict__ sos,
                const T* __restrict__ zi, T* __restrict__ y, int rows,
                int len) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  T c[S][6], z0[S], z1[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < 6; ++i) c[s][i] = sos[(size_t(r) * S + s) * 6 + i];
    z0[s] = zi[(size_t(r) * S + s) * 2];
    z1[s] = zi[(size_t(r) * S + s) * 2 + 1];
  }
  const T* xr = x + size_t(r) * len;
  T* yr = y + size_t(r) * len;
  T cur[kAhead], nxt[kAhead];
  load_block(xr, 0, len, 1, cur);
  for (int t0 = 0; t0 < len; t0 += kAhead) {
    load_block(xr, t0 + kAhead, len, 1, nxt);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      T u = cur[j];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        // out = b0*y + z0;  z0' = b1*y - a1*out + z1;  z1' = b2*y - a2*out
        const T out = c[s][0] * u + z0[s];
        const T n0 = c[s][1] * u - c[s][4] * out + z1[s];
        const T n1 = c[s][2] * u - c[s][5] * out;
        z0[s] = n0;
        z1[s] = n1;
        u = out;
      }
      if (t0 + j < len) yr[t0 + j] = u;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) cur[j] = nxt[j];
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kBlock)
    sos_adjoint(const T* __restrict__ gy, const T* __restrict__ sos,
                T* __restrict__ gx, T* __restrict__ gzi, int rows, int len) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  double c[S][6], l0[S], l1[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < 6; ++i) c[s][i] = sos[(size_t(r) * S + s) * 6 + i];
    l0[s] = 0.0;
    l1[s] = 0.0;
  }
  const T* gr = gy + size_t(r) * len;
  T* xr = gx + size_t(r) * len;
  T cur[kAhead], nxt[kAhead];
  load_block(gr, len - 1, len, -1, cur);
  for (int t0 = len - 1; t0 >= 0; t0 -= kAhead) {
    load_block(gr, t0 - kAhead, len, -1, nxt);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      // past t = 0 no step runs: the state's cotangent is the answer
      if (t0 - j < 0) break;
      double g = cur[j];
#pragma unroll
      for (int s = S - 1; s >= 0; --s) {
        // the cotangent of out, then of the section's input; the state's
        // cotangent becomes (d out, d z0')
        const double go = g - c[s][4] * l0[s] - c[s][5] * l1[s];
        const double gu = c[s][0] * go + c[s][1] * l0[s] + c[s][2] * l1[s];
        l1[s] = l0[s];
        l0[s] = go;
        g = gu;
      }
      xr[t0 - j] = static_cast<T>(g);
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) cur[j] = nxt[j];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    gzi[(size_t(r) * S + s) * 2] = static_cast<T>(l0[s]);
    gzi[(size_t(r) * S + s) * 2 + 1] = static_cast<T>(l1[s]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kBlock)
    df2t_forward(const T* __restrict__ x, const T* __restrict__ ba,
                 const T* __restrict__ zi, T* __restrict__ y, int rows,
                 int len) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  T b[N + 1], a[N + 1], z[N];
#pragma unroll
  for (int i = 0; i <= N; ++i) {
    b[i] = ba[size_t(r) * 2 * (N + 1) + i];
    a[i] = ba[size_t(r) * 2 * (N + 1) + N + 1 + i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) z[i] = zi[size_t(r) * N + i];
  const T* xr = x + size_t(r) * len;
  T* yr = y + size_t(r) * len;
  T cur[kAhead], nxt[kAhead];
  load_block(xr, 0, len, 1, cur);
  for (int t0 = 0; t0 < len; t0 += kAhead) {
    load_block(xr, t0 + kAhead, len, 1, nxt);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const T u = cur[j];
      // y = b0*x + z0;  z'_i = z_{i+1} + b_{i+1}*x - a_{i+1}*y (z_N = 0)
      const T out = b[0] * u + z[0];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const T shifted = i + 1 < N ? z[i + 1] : T(0);
        z[i] = shifted + b[i + 1] * u - a[i + 1] * out;
      }
      if (t0 + j < len) yr[t0 + j] = out;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) cur[j] = nxt[j];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kBlock)
    df2t_adjoint(const T* __restrict__ gy, const T* __restrict__ ba,
                 T* __restrict__ gx, T* __restrict__ gzi, int rows, int len) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  double b[N + 1], a[N + 1], l[N];
#pragma unroll
  for (int i = 0; i <= N; ++i) {
    b[i] = ba[size_t(r) * 2 * (N + 1) + i];
    a[i] = ba[size_t(r) * 2 * (N + 1) + N + 1 + i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) l[i] = 0.0;
  const T* gr = gy + size_t(r) * len;
  T* xr = gx + size_t(r) * len;
  T cur[kAhead], nxt[kAhead];
  load_block(gr, len - 1, len, -1, cur);
  for (int t0 = len - 1; t0 >= 0; t0 -= kAhead) {
    load_block(gr, t0 - kAhead, len, -1, nxt);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      // the cotangent of y, then of x; the state's cotangent shifts up by
      // one with d y in front (past t = 0 no step runs)
      if (t0 - j < 0) break;
      double g = cur[j];
#pragma unroll
      for (int i = 0; i < N; ++i) g = g - a[i + 1] * l[i];
      double gu = b[0] * g;
#pragma unroll
      for (int i = 0; i < N; ++i) gu = gu + b[i + 1] * l[i];
#pragma unroll
      for (int i = N - 1; i > 0; --i) l[i] = l[i - 1];
      l[0] = g;
      xr[t0 - j] = static_cast<T>(gu);
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) cur[j] = nxt[j];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) gzi[size_t(r) * N + i] = static_cast<T>(l[i]);
}

inline dim3 grid(int rows) { return dim3((rows + kBlock - 1) / kBlock); }

// one case of the dispatch on S (or N); a size without a case returns -1
#define SOS_CASE(T, S, KERNEL, ...)                                        \
  case S:                                                                  \
    KERNEL<T, S><<<grid(rows), kBlock, 0, st>>>(__VA_ARGS__);              \
    break;

template <typename T>
int sos_fwd(const void* x, const void* sos, const void* zi, void* y,
            int rows, int len, int sections, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* cp = static_cast<const T*>(sos);
  const T* zp = static_cast<const T*>(zi);
  T* yp = static_cast<T*>(y);
  switch (sections) {
    SOS_CASE(T, 1, sos_forward, xp, cp, zp, yp, rows, len)
    SOS_CASE(T, 2, sos_forward, xp, cp, zp, yp, rows, len)
    SOS_CASE(T, 3, sos_forward, xp, cp, zp, yp, rows, len)
    SOS_CASE(T, 4, sos_forward, xp, cp, zp, yp, rows, len)
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sos_adj(const void* gy, const void* sos, void* gx, void* gzi, int rows,
            int len, int sections, cudaStream_t st) {
  const T* gp = static_cast<const T*>(gy);
  const T* cp = static_cast<const T*>(sos);
  T* xp = static_cast<T*>(gx);
  T* zp = static_cast<T*>(gzi);
  switch (sections) {
    SOS_CASE(T, 1, sos_adjoint, gp, cp, xp, zp, rows, len)
    SOS_CASE(T, 2, sos_adjoint, gp, cp, xp, zp, rows, len)
    SOS_CASE(T, 3, sos_adjoint, gp, cp, xp, zp, rows, len)
    SOS_CASE(T, 4, sos_adjoint, gp, cp, xp, zp, rows, len)
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

#define DF2T_CASES(T, KERNEL, ...)                                          \
  SOS_CASE(T, 1, KERNEL, __VA_ARGS__)                                       \
  SOS_CASE(T, 2, KERNEL, __VA_ARGS__)                                       \
  SOS_CASE(T, 3, KERNEL, __VA_ARGS__)                                       \
  SOS_CASE(T, 4, KERNEL, __VA_ARGS__)                                       \
  SOS_CASE(T, 5, KERNEL, __VA_ARGS__)                                       \
  SOS_CASE(T, 6, KERNEL, __VA_ARGS__)                                       \
  SOS_CASE(T, 7, KERNEL, __VA_ARGS__)                                       \
  SOS_CASE(T, 8, KERNEL, __VA_ARGS__)

template <typename T>
int df2t_fwd(const void* x, const void* ba, const void* zi, void* y, int rows,
             int len, int order, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* cp = static_cast<const T*>(ba);
  const T* zp = static_cast<const T*>(zi);
  T* yp = static_cast<T*>(y);
  switch (order) {
    DF2T_CASES(T, df2t_forward, xp, cp, zp, yp, rows, len)
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int df2t_adj(const void* gy, const void* ba, void* gx, void* gzi, int rows,
             int len, int order, cudaStream_t st) {
  const T* gp = static_cast<const T*>(gy);
  const T* cp = static_cast<const T*>(ba);
  T* xp = static_cast<T*>(gx);
  T* zp = static_cast<T*>(gzi);
  switch (order) {
    DF2T_CASES(T, df2t_adjoint, gp, cp, xp, zp, rows, len)
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: pointers, then ints (rows, len, sections or order, dtype
// 0 = f32 / 1 = f64), then the stream. Return a cudaError_t, or -1 for a
// size or dtype the kernels do not take.
extern "C" int iir_sos_forward(const void* x, const void* sos, const void* zi,
                               void* y, int rows, int len, int sections,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return sos_fwd<float>(x, sos, zi, y, rows, len, sections, st);
  if (dtype == 1)
    return sos_fwd<double>(x, sos, zi, y, rows, len, sections, st);
  return -1;
}

extern "C" int iir_sos_adjoint(const void* gy, const void* sos, void* gx,
                               void* gzi, int rows, int len, int sections,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return sos_adj<float>(gy, sos, gx, gzi, rows, len, sections, st);
  if (dtype == 1)
    return sos_adj<double>(gy, sos, gx, gzi, rows, len, sections, st);
  return -1;
}

extern "C" int iir_df2t_forward(const void* x, const void* ba, const void* zi,
                                void* y, int rows, int len, int order,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return df2t_fwd<float>(x, ba, zi, y, rows, len, order, st);
  if (dtype == 1) return df2t_fwd<double>(x, ba, zi, y, rows, len, order, st);
  return -1;
}

extern "C" int iir_df2t_adjoint(const void* gy, const void* ba, void* gx,
                                void* gzi, int rows, int len, int order,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return df2t_adj<float>(gy, ba, gx, gzi, rows, len, order, st);
  if (dtype == 1)
    return df2t_adj<double>(gy, ba, gx, gzi, rows, len, order, st);
  return -1;
}
