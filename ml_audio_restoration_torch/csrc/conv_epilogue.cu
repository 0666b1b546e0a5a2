// The epilogue of every eval convolution (ops/conv.py::conv_epilogue): in
// place on a conv's output y, contiguous NCW [B, C, T] in f32 or bf16,
//
//   y <- act(y + b[c] (+ r))
//
// with b the conv's [C] bias, r an optional residual of y's shape and act
// the identity or LeakyReLU(0.2).
//
// Replaces no Pallas kernel: the JAX package leaves the bias, the residual
// adds and the LeakyReLU to XLA, which fuses them into its convolutions on
// the TPU. On the card ATen runs a cuDNN convolution without its bias, then
// `output.add_(bias.view(1, C, 1))` (a broadcast, so the legacy
// non-vectorised elementwise kernel), then F.leaky_relu out of place and a
// residual add, each a full pass over the conv's output: 3-4 reads and 2-3
// writes of y, and a new tensor, where one read and one write do.
//
// What bounds it: bytes. A pass reads y (and r) and writes y, 8 bytes an
// element in f32 (12 with r), against a handful of operations: the stereo
// model's 44-row slab writes 1,378 channels of 88,200 samples a forward,
// 5.3 G floats, 43 GB read and written, 12.8 ms at 3.35 TB/s. Design for
// that:
// - 16-byte loads and stores, neighbouring threads on neighbouring vectors;
// - one block over a span of one (b, c) row, so the bias is one register
//   and no thread divides an index by T; each row splits into the fewest
//   spans of at most kThreads vectors, balanced, one vector a thread:
//   short blocks, eight resident an SM, keep the loads in flight (on the
//   card at [44, 32-128, 88,200] f32, spans of 4 vectors a thread reached
//   76-86% of 3.35 TB/s, of 2 87-88%, of 1 88-89%; ATen's in-place
//   vectorised multiply 89-90%);
// - a row need not start on 16 bytes (T % 4 != 0 in f32, % 8 in bf16: a
//   stream window, an odd chunk): each span runs its vectors over the
//   aligned indices inside it and its ragged head and tail, < 1 vector
//   each, element by element;
// - a grid of rows * spans blocks: hundreds of thousands at the
//   restore's shapes, for 132 SMs.
//
// Rounding: each operation as ATen's separate ops round it, so the output
// is bit for bit the unfused one: the bias add in f32 rounded to the
// tensor's type, the residual add likewise, then x > 0 ? x : x * 0.2f,
// rounded. The library is built with -fmad=false (ops/_build.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // one 16-byte vector a thread a span
constexpr float kSlope = 0.2f;   // models/common.py::LRELU_SLOPE

struct F32 {
  using raw = float;
  static __device__ __forceinline__ float get(float x) { return x; }
  static __device__ __forceinline__ float put(float x) { return x; }
};

struct BF16 {
  using raw = unsigned short;
  static __device__ __forceinline__ float get(unsigned short x) {
    return __bfloat162float(__ushort_as_bfloat16(x));
  }
  static __device__ __forceinline__ unsigned short put(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <typename D>
union Pack {
  uint4 u;
  typename D::raw v[16 / sizeof(typename D::raw)];
};

// One element, rounded after each operation as ATen rounds it
template <typename D, bool kRes, bool kLrelu>
__device__ __forceinline__ typename D::raw apply(typename D::raw y, float b,
                                                 typename D::raw r) {
  typename D::raw s = D::put(D::get(y) + b);
  if (kRes) s = D::put(D::get(s) + D::get(r));
  if (kLrelu) {
    const float a = D::get(s);
    s = D::put(a > 0.f ? a : a * kSlope);
  }
  return s;
}

// y [rows, len] with rows = B * C; block i takes span i % spans of row
// i / spans, `span` elements (a multiple of the vector's) or the row's rest
template <typename D, bool kRes, bool kLrelu>
__global__ void __launch_bounds__(kThreads)
    epilogue_elementwise_kernel(typename D::raw* __restrict__ y,
                                const typename D::raw* __restrict__ bias,
                                const typename D::raw* __restrict__ res,
                                int len, int channels, int spans, int span) {
  using raw = typename D::raw;
  constexpr int V = 16 / sizeof(raw);
  const long long row = blockIdx.x / spans;
  const int s = blockIdx.x - int(row * spans);
  const float b = D::get(bias[row % channels]);
  const long long lo = row * len + (long long)s * span;
  const long long hi = row * len + min((long long)(s + 1) * span,
                                       (long long)len);
  const long long a0 = (lo + V - 1) / V * V;  // first aligned index
  const long long a1 = max(hi / V * V, a0);   // end of the aligned body

  // the ragged head [lo, min(a0, hi)) and tail [a1, hi), < V elements each
  const int t = threadIdx.x;
  const long long head = lo + t, tail = a1 + (t - V);
  if (t < V && head < min(a0, hi))
    y[head] = apply<D, kRes, kLrelu>(y[head], b, kRes ? res[head] : raw());
  else if (t >= V && t < 2 * V && tail >= a0 && tail < hi)
    y[tail] = apply<D, kRes, kLrelu>(y[tail], b, kRes ? res[tail] : raw());

  // the aligned body [a0, a1): one vector a thread (span <= kThreads * V)
  const int nvec = int((a1 - a0) / V);
  if (t < nvec) {
    uint4* yv = reinterpret_cast<uint4*>(y + a0) + t;
    Pack<D> v, r;
    v.u = *yv;
    if (kRes) r.u = __ldg(reinterpret_cast<const uint4*>(res + a0) + t);
#pragma unroll
    for (int j = 0; j < V; ++j)
      v.v[j] = apply<D, kRes, kLrelu>(v.v[j], b, kRes ? r.v[j] : raw());
    *yv = v.u;
  }
}

template <typename D, bool kRes, bool kLrelu>
cudaError_t launch(void* y, const void* bias, const void* res, int rows,
                   int len, int channels, cudaStream_t stream) {
  using raw = typename D::raw;
  constexpr int V = 16 / sizeof(raw);
  constexpr long long kSpan = (long long)kThreads * V;
  const long long spans = (len + kSpan - 1) / kSpan;
  const long long per = (len + spans - 1) / spans;
  const int span = int((per + V - 1) / V * V);
  const long long blocks = (long long)rows * spans;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  epilogue_elementwise_kernel<D, kRes, kLrelu>
      <<<unsigned(blocks), kThreads, 0, stream>>>(
          static_cast<raw*>(y), static_cast<const raw*>(bias),
          static_cast<const raw*>(res), len, channels, int(spans), span);
  return cudaGetLastError();
}

template <typename D>
cudaError_t dispatch(void* y, const void* bias, const void* res, int rows,
                     int len, int channels, int lrelu, cudaStream_t stream) {
  if (res != nullptr)
    return lrelu ? launch<D, true, true>(y, bias, res, rows, len, channels,
                                         stream)
                 : launch<D, true, false>(y, bias, res, rows, len, channels,
                                          stream);
  return lrelu ? launch<D, false, true>(y, bias, res, rows, len, channels,
                                        stream)
               : launch<D, false, false>(y, bias, res, rows, len, channels,
                                         stream);
}

}  // namespace

// y [rows = B * C, len = T] contiguous and 16-byte aligned, bias [C], res
// null or y's shape and alignment; dtype 0 f32, 1 bf16; lrelu 0 or 1.
// Returns the cudaError_t of the launch (none for an empty y).
extern "C" int conv_epilogue(void* y, const void* bias, const void* res,
                             int rows, int len, int channels, int lrelu,
                             int dtype, cudaStream_t stream) {
  if (rows <= 0 || len <= 0) return cudaSuccess;
  if (channels <= 0 || rows % channels != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return dispatch<F32>(y, bias, res, rows, len, channels, lrelu, stream);
    case 1:
      return dispatch<BF16>(y, bias, res, rows, len, channels, lrelu, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
