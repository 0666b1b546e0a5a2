// IIR scans over time as a blocked parallel-in-time scan: the hand kernel
// behind ops/iir.py, in place of the lax.scan of the JAX package's
// ops/filters.py::sosfilt (the biquad cascade, :94-122) and ::lfilter
// (direct form II transposed, :152-184).
//
// x and y are [rows, len] row-major; every row carries its own
// coefficients and initial state, so one launch filters a batch whose items
// have different filters (the simulator's per-item roll-off cutoff):
//   biquads: sos [rows, S, 6] (b0 b1 b2 a0 a1 a2, a0 taken as 1),
//            zi [rows, S, 2], S <= 4;
//   DF2T:    ba [rows, 2 (N + 1)] (b0..bN then a0..aN, normalised so that
//            a0 = 1), zi [rows, N], order N <= 8.
// The adjoint kernels walk the same rows in reverse time: given the
// cotangent gy of y they return gx and the cotangent of the initial state
// (the transposed recursion from the zero state; the filters are linear, so
// nothing of the forward walk is saved).
//
// What bounds it. A walk moves 8 bytes a step in f32 (x in, y out): 16 rows
// of 44,130 steps are 5.6 MB, 1.7 us at 3.35 TB/s. A serial walk, one
// thread a row, cannot come near that: each step is a chain of dependent
// multiplies and adds, so 44,130 steps take 0.4 ms however few bytes move.
// So the walk is cut into blocks (ops/iir.py::partition: P <= 512 blocks of
// L steps, L = 64 up to 32,768 steps), one CTA a row and one thread a
// block, in three passes:
//   1. local: each thread walks its block from the zero state (block 0 from
//      the initial state) and keeps its end state b_k;
//   2. combine: Phi, the state's L-step transition at zero input, comes
//      from the CTA's last n threads walking the unit states L steps; the
//      true end states E_k = Phi E_{k-1} + b_k come from an inclusive
//      Hillis-Steele scan over the blocks in shared memory, E_k += Phi^d
//      E_{k-d} at d = 1, 2, 4, ..., while n^2 threads square Phi^d into
//      Phi^(2d) beside it;
//   3. replay: each thread walks its block again from E_{k-1} and writes
//      its outputs.
// Then the chain is about two passes of L steps plus log2(P) combine levels,
// and the floor moves to the double-precision issue rate of the R SMs the
// R CTAs occupy (64 operations a cycle an SM). The state, Phi and the
// combine are double for any data type, and each output is rounded once:
// the 100 Hz rumble low-pass's poles lie within 0.03 of the unit circle and
// magnify every rounding of the state (JAX's f32 walk ends 3.3e-5 of the
// peak from the exact answer, this one within 1e-6: tests/test_torch_iir.py),
// and the adjoint's state grows far above its output and cancels in any
// design. P stops at 512 so that a thread may hold 128 registers (the f32
// biquad walk takes about 120; under the 64 of a 1,024-thread CTA it
// spilled).
//
// The padding: P L exceeds len by pad < L, and it leads in walk order
// (reverse time for the adjoints), so block 0 is the short one and starts
// from the initial state at its step pad, and one Phi serves every later
// block. The library is built with -fmad=false, and every operation comes
// in ops/iir.py's plain versions' order, so a launch equals them bit for
// bit.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;  // ops/iir.py MAX_BLOCKS

// ---------------------------------------------------------------- the steps
// Each recurrence: its state's size n, its direction, its coefficients in
// double, and one step of the state z with input u, returning the output.
// (Their names show in the kernels' names, which utils/profiling.py's
// buckets read.)

template <int S>
struct sos_forward {
  static constexpr int kState = 2 * S;
  static constexpr bool kReverse = false;
  double c[S][5];  // b0 b1 b2 a1 a2

  template <typename T>
  __device__ void load(const T* __restrict__ coef, int row) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const T* p = coef + (size_t(row) * S + s) * 6;
      c[s][0] = p[0];
      c[s][1] = p[1];
      c[s][2] = p[2];
      c[s][3] = p[4];
      c[s][4] = p[5];
    }
  }

  __device__ __forceinline__ double step(double (&z)[kState], double u) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // out = b0*y + z0;  z0' = b1*y - a1*out + z1;  z1' = b2*y - a2*out
      const double out = c[s][0] * u + z[2 * s];
      const double n0 = c[s][1] * u - c[s][3] * out + z[2 * s + 1];
      const double n1 = c[s][2] * u - c[s][4] * out;
      z[2 * s] = n0;
      z[2 * s + 1] = n1;
      u = out;
    }
    return u;
  }
};

template <int S>
struct sos_adjoint : sos_forward<S> {
  static constexpr bool kReverse = true;
  using sos_forward<S>::c;

  __device__ __forceinline__ double step(double (&z)[2 * S], double g) const {
#pragma unroll
    for (int s = S - 1; s >= 0; --s) {
      // the cotangent of out, then of the section's input; the state's
      // cotangent becomes (d out, d z0')
      const double go = g - c[s][3] * z[2 * s] - c[s][4] * z[2 * s + 1];
      const double gu = c[s][0] * go + c[s][1] * z[2 * s] + c[s][2] * z[2 * s + 1];
      z[2 * s + 1] = z[2 * s];
      z[2 * s] = go;
      g = gu;
    }
    return g;
  }
};

template <int N>
struct df2t_forward {
  static constexpr int kState = N;
  static constexpr bool kReverse = false;
  double b[N + 1], a[N + 1];

  template <typename T>
  __device__ void load(const T* __restrict__ coef, int row) {
    const T* p = coef + size_t(row) * 2 * (N + 1);
#pragma unroll
    for (int i = 0; i <= N; ++i) {
      b[i] = p[i];
      a[i] = p[N + 1 + i];
    }
  }

  __device__ __forceinline__ double step(double (&z)[N], double u) const {
    // y = b0*x + z0;  z'_i = z_{i+1} + b_{i+1}*x - a_{i+1}*y (z_N = 0)
    const double out = b[0] * u + z[0];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const double in = i + 1 < N ? z[i + 1] + b[i + 1] * u : b[i + 1] * u;
      z[i] = in - a[i + 1] * out;
    }
    return out;
  }
};

template <int N>
struct df2t_adjoint : df2t_forward<N> {
  static constexpr bool kReverse = true;
  using df2t_forward<N>::a;
  using df2t_forward<N>::b;

  __device__ __forceinline__ double step(double (&z)[N], double g) const {
    // the cotangent of y, then of x; the state's cotangent shifts up by one
    // with d y in front
#pragma unroll
    for (int i = 0; i < N; ++i) g = g - a[i + 1] * z[i];
    double gu = b[0] * g;
#pragma unroll
    for (int i = 0; i < N; ++i) gu = gu + b[i + 1] * z[i];
#pragma unroll
    for (int i = N - 1; i > 0; --i) z[i] = z[i - 1];
    z[0] = g;
    return gu;
  }
};

// ------------------------------------------------------------- the blocks
// Inputs and outputs pass through a shared-memory tile, kChunk steps of
// every block at a time (64 bytes of each block's row): neighbouring
// threads load and store neighbouring words, where each thread touching
// its own block's words would scatter every access over 32 cache lines. A
// row of the tile holds a block's kChunk steps, padded by one word against
// bank conflicts when each thread reads its own row. Each thread moves
// kChunk words of a chunk, and loads the next chunk's into registers while
// the blocks walk this one, so the loads' latency hides behind the walk.
template <typename T>
struct Tile {
  static constexpr int kChunk = 64 / sizeof(T);
  static constexpr int kStride = kChunk + 1;
};

// Walk every block's steps [0, block) through the tile, chunk by chunk: the
// thread of block k from its state z (block 0 from its step pad: the steps
// before it are padding), with Write its outputs rounded once into y. Step j
// of block k is data step k*block + j - pad in walk order. Each warp moves
// its own 32 blocks' words and syncs only itself, so one warp's loads wait
// while others walk: lane l moves word q = l % kChunk of the warp's blocks
// l / kChunk + r * kstep, r < kChunk. Every thread of the CTA calls it.
template <bool Write, typename T, class W>
__device__ void walk_blocks(const W& w, double (&z)[W::kState],
                            const T* __restrict__ x, T* __restrict__ y,
                            T* tile, int block, int blocks, int pad,
                            int len) {
  constexpr int kChunk = Tile<T>::kChunk, kStride = Tile<T>::kStride;
  constexpr int kstep = 32 / kChunk;
  const int tid = threadIdx.x;
  const int q = tid % kChunk, k0 = tid / 32 * 32 + tid % 32 / kChunk;
  // the data index of word r at the chunk from step c0, or -1 (padding, or
  // past the blocks or the block)
  auto index = [&](int r, int c0) {
    const int k = k0 + r * kstep, j = c0 + q;
    const int tau = k * block - pad + j;
    if (k >= blocks || j >= block || tau < 0) return -1;
    return W::kReverse ? len - 1 - tau : tau;
  };
  T v[kChunk];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const int t = index(r, c0);
      v[r] = t >= 0 ? x[t] : T(0);
    }
  };
  const int j0 = tid == 0 ? pad : 0;
  T* mine = tile + tid * kStride;
  fetch(0);
  for (int c0 = 0; c0 < block; c0 += kChunk) {
#pragma unroll
    for (int r = 0; r < kChunk; ++r)
      if (k0 + r * kstep < blocks) tile[(k0 + r * kstep) * kStride + q] = v[r];
    __syncwarp();
    if (c0 + kChunk < block) fetch(c0 + kChunk);
    if (tid < blocks) {
      const int steps = min(kChunk, block - c0);
      for (int i = 0; i < steps; ++i) {
        if (c0 + i < j0) continue;
        const double out = w.step(z, static_cast<double>(mine[i]));
        if (Write) mine[i] = static_cast<T>(out);
      }
    }
    __syncwarp();
    if (Write) {
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        const int t = index(r, c0);
        if (t >= 0) y[t] = tile[(k0 + r * kstep) * kStride + q];
      }
      __syncwarp();
    }
  }
}

// One CTA a row, one thread a block. Dynamic shared memory: the blocks' end
// states [n][blocks] (component-major, so neighbouring threads touch
// neighbouring words), two n x n powers of Phi, and the tile.
template <typename T, class W>
__global__ void __launch_bounds__(kMaxThreads)
    blocked_scan(const T* __restrict__ x, const T* __restrict__ coef,
                 const T* __restrict__ zi, T* __restrict__ y,
                 T* __restrict__ zout, int len, int block, int blocks) {
  constexpr int n = W::kState;
  extern __shared__ double smem[];
  double* ends = smem;
  double* powers = smem + n * blocks;
  T* tile = reinterpret_cast<T*>(powers + 2 * n * n);
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int pad = block * blocks - len;
  W w;
  w.load(coef, row);
  const T* xr = x + size_t(row) * len;
  T* yr = y + size_t(row) * len;

  // the initial state's component i (zero for the adjoints)
  auto init = [&](int i) {
    return zi != nullptr ? static_cast<double>(zi[size_t(row) * n + i]) : 0.0;
  };

  // 1. local pass
  double e[n];
#pragma unroll
  for (int i = 0; i < n; ++i) e[i] = tid == 0 ? init(i) : 0.0;
  walk_blocks<false>(w, e, xr, yr, tile, block, blocks, pad, len);
  if (tid < blocks) {
#pragma unroll
    for (int i = 0; i < n; ++i) ends[i * blocks + tid] = e[i];
  }
  // Phi's column c: the last n threads walk unit state c through block
  // zero-input steps
  const int col = int(blockDim.x) - 1 - tid;
  if (blocks > 1 && col < n) {
    double u[n];
#pragma unroll
    for (int i = 0; i < n; ++i) u[i] = i == col ? 1.0 : 0.0;
    for (int j = 0; j < block; ++j) w.step(u, 0.0);
#pragma unroll
    for (int i = 0; i < n; ++i) powers[i * n + col] = u[i];
  }
  __syncthreads();

  // 2. combine: E_k += Phi^d E_{k-d}; beside it, Phi^(2d) = Phi^d Phi^d
  int cur = 0;
  for (int d = 1; d < blocks; d *= 2) {
    const double* q = powers + cur * n * n;
    const bool take = tid < blocks && tid >= d;
    double acc[n];
    if (take) {
#pragma unroll
      for (int i = 0; i < n; ++i) {
        double s = q[i * n] * ends[tid - d];
#pragma unroll
        for (int m = 1; m < n; ++m)
          s = s + q[i * n + m] * ends[m * blocks + tid - d];
        acc[i] = s;
      }
    }
    if (2 * d < blocks && tid < n * n) {
      const int i = tid / n, c = tid % n;
      double s = q[i * n] * q[c];
      for (int m = 1; m < n; ++m) s = s + q[i * n + m] * q[m * n + c];
      powers[(1 - cur) * n * n + tid] = s;
    }
    __syncthreads();
    if (take) {
#pragma unroll
      for (int i = 0; i < n; ++i) {
        e[i] = e[i] + acc[i];
        ends[i * blocks + tid] = e[i];
      }
    }
    __syncthreads();
    cur = 1 - cur;
  }

  // the last block's end state is the walk's (the adjoints' cotangent of
  // the initial state)
  if (zout != nullptr && tid == blocks - 1) {
#pragma unroll
    for (int i = 0; i < n; ++i)
      zout[size_t(row) * n + i] = static_cast<T>(e[i]);
  }

  // 3. replay from each block's entry state
  if (tid < blocks) {
#pragma unroll
    for (int i = 0; i < n; ++i)
      e[i] = tid == 0 ? init(i) : ends[i * blocks + tid - 1];
  }
  walk_blocks<true>(w, e, xr, yr, tile, block, blocks, pad, len);
}

template <typename T, class W>
int launch(const void* x, const void* coef, const void* zi, void* y,
           void* zout, int rows, int len, int block, int blocks,
           cudaStream_t st) {
  constexpr int n = W::kState;
  if (rows < 1 || len < 1 || blocks < 1 || blocks > kMaxThreads ||
      block < 1 || blocks * block < len || (blocks - 1) * block >= len)
    return -1;
  const int most = blocks > n * n ? blocks : n * n;
  const int threads = (most + 31) / 32 * 32;
  const size_t smem = sizeof(double) * (size_t(n) * blocks + 2 * n * n) +
                      sizeof(T) * size_t(blocks) * Tile<T>::kStride;
  auto kernel = blocked_scan<T, W>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<rows, threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(coef),
      static_cast<const T*>(zi), static_cast<T*>(y), static_cast<T*>(zout),
      len, block, blocks);
  return static_cast<int>(cudaGetLastError());
}

// the dispatch on the dtype (0 = f32, 1 = f64) and on the size, S <= 4
// sections or order N <= 8
template <template <int> class W, int kMax>
struct Dispatch {
  template <typename T>
  static int sized(int size, const void* x, const void* coef, const void* zi,
                   void* y, void* zout, int rows, int len, int block,
                   int blocks, cudaStream_t st) {
    switch (size) {
#define IIR_CASE(K)                                                         \
  case K:                                                                   \
    if constexpr (K <= kMax)                                                \
      return launch<T, W<K>>(x, coef, zi, y, zout, rows, len, block, blocks, \
                             st);                                           \
    return -1;
      IIR_CASE(1)
      IIR_CASE(2)
      IIR_CASE(3)
      IIR_CASE(4)
      IIR_CASE(5)
      IIR_CASE(6)
      IIR_CASE(7)
      IIR_CASE(8)
#undef IIR_CASE
      default:
        return -1;
    }
  }

  static int run(const void* x, const void* coef, const void* zi, void* y,
                 void* zout, int rows, int len, int size, int dtype,
                 int block, int blocks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      return sized<float>(size, x, coef, zi, y, zout, rows, len, block,
                          blocks, st);
    if (dtype == 1)
      return sized<double>(size, x, coef, zi, y, zout, rows, len, block,
                           blocks, st);
    return -1;
  }
};

}  // namespace

// C entry points: pointers (x or gy, the coefficients, zi or null, y or gx,
// null or gzi: a forward walk takes zi and returns no state, an adjoint
// starts from zero and returns gzi), then ints (rows, len, sections or
// order, dtype 0 = f32 / 1 = f64, block, blocks: ops/iir.py::partition
// (len)), then the stream. Return a cudaError_t, or -1 for a size, dtype or
// partition the kernels do not take.
#define IIR_ENTRY(NAME, WALK, MAX)                                            \
  extern "C" int NAME(const void* x, const void* coef, const void* zi,        \
                      void* y, void* zout, int rows, int len, int size,       \
                      int dtype, int block, int blocks, void* stream) {       \
    return Dispatch<WALK, MAX>::run(x, coef, zi, y, zout, rows, len, size,    \
                                    dtype, block, blocks, stream);            \
  }

IIR_ENTRY(iir_sos_forward, sos_forward, 4)
IIR_ENTRY(iir_sos_adjoint, sos_adjoint, 4)
IIR_ENTRY(iir_df2t_forward, df2t_forward, 8)
IIR_ENTRY(iir_df2t_adjoint, df2t_adjoint, 8)
