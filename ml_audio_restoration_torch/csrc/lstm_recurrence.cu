// LSTM recurrence over precomputed, time-major gates, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ml_audio_restoration_tpu/ops/pallas/lstm.py
// ::_lstm_kernel. Per step t and batch row b, with gate order i, f, g, o:
//   a = (h rounded to the gates' type) @ W_hh, accumulated in f32, + gx[t, b]
//   i, f, o = sigmoid(a_i, a_f, a_o); g = tanh(a_g)
//   c = f * c + i * g;  h = o * tanh(c);  out[b, t] = h (in the gates' type)
// h and c stay f32 the whole time; (hf, cf) is the state after step T-1.
//
// Shapes: gx [T, B, 4H] (f32 or bf16), W_hh [H, 4H] (the gates' type),
// h0/c0/hf/cf [B, H] f32, out [B, T, H] (the gates' type, batch-major like
// the JAX wrapper's output).
//
// What bounds it on an H100. Streaming the gates once and writing the output
// once is T*B*(4H + H)*itemsize bytes: at the 120 s restore shape (T=88200,
// B=64, H=64, f32) 5.78 GB + 1.45 GB, about 2.2 ms at 3.35 TB/s. The h @ W_hh
// products are 2*H*4H flops a row and step, 1.85e11 in all, about 2.8 ms at
// the 67 TFLOP/s f32 rate outside the tensor cores. The real floor is the
// chain of T dependent steps: each step needs the h of the step before, so
// the design shortens the step's critical path.
//
// Design. Batch rows are independent, so each row gets one CTA and the time
// loop runs inside it (nothing carries between CTAs on this card). Hidden
// unit u belongs to a group of LANES adjacent lanes of one warp: lane r keeps
// the unit's four gate columns of W_hh, restricted to its share of the rows,
// in registers, and sums those partial pre-activations against h from shared
// memory. Shuffles inside the group reduce the partials (each total summed in
// one lane, in a fixed order); each lane activates 4 / LANES gates, the group
// gathers i, f, g, o by shuffles and every lane of it updates (c, h). So the
// gate math never leaves the unit's own lanes, and h_s, double-buffered
// (step t reads buffer t & 1 and writes the other), needs one __syncthreads a
// step. Activations use the special-function unit (lstm_common.cuh). The
// gate rows come through shared memory, BLOCK steps at a time, copied by
// cp.async while the block before runs: a prefetch into registers would
// make each step's barrier wait for the load (PERF.md), and one copy and
// one wait a block of steps, not a step, keep the copy's own latency off
// most steps. No batch or time padding: the grid is B CTAs and the loop
// runs exactly T steps.
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

constexpr int BLOCK = 8;  // steps a gate copy covers (even)
constexpr int LANES = 2;  // lanes per hidden unit

// h as the product sees it: rounded to the gates' type, as the TPU kernel
// casts h to W_hh's dtype before the dot.
template <typename T>
__device__ __forceinline__ float as_operand(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int H>
__global__ void __launch_bounds__(H * LANES, 1)
lstm_recurrence_kernel(const T* __restrict__ gx, const T* __restrict__ whh,
                       const float* __restrict__ h0,
                       const float* __restrict__ c0, T* __restrict__ out,
                       float* __restrict__ hf, float* __restrict__ cf,
                       int steps, int batch) {
  constexpr int G = 4 * H;
  constexpr int ROWS = H / LANES;  // rows of W_hh a lane multiplies
  constexpr int NG = 4 / LANES;    // gates a lane activates
  constexpr int THREADS = H * LANES;
  constexpr int CHUNKS = G * sizeof(T) / 16;  // 16-byte pieces of a gate row
  static_assert(ROWS % 4 == 0, "a lane reads its share of h as float4s");
  const int b = blockIdx.x;
  const int u = threadIdx.x / LANES;  // hidden unit
  const int r = threadIdx.x % LANES;  // lane in the unit's group

  __shared__ __align__(16) float h_s[2][H];
  __shared__ __align__(16) T gx_s[2][BLOCK][G];

  // lane r multiplies rows 4 * (LANES * m + r) + e: its float4s of h
  // interleave with the other lanes', so a warp's loads hit distinct banks
  float w[4][ROWS];
#pragma unroll
  for (int m = 0; m < ROWS / 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        w[g][4 * m + e] =
            to_f32(whh[(4 * (LANES * m + r) + e) * G + g * H + u]);

  float h = h0[b * H + u], c = c0[b * H + u];
  if (r == 0) h_s[0][u] = as_operand<T>(h);

  // the gate rows of steps [t0, t0 + BLOCK) sit in gx_s[(t0 / BLOCK) & 1];
  // each block of rows is copied by all threads while the block before it
  // runs, one commit group a block
  const char* g_row =
      reinterpret_cast<const char*>(gx + static_cast<size_t>(b) * G);
  const size_t t_bytes = static_cast<size_t>(batch) * G * sizeof(T);
  auto fetch = [&](int t0) {
    char* dst = reinterpret_cast<char*>(gx_s[(t0 / BLOCK) & 1]);
    for (int i = threadIdx.x; i < BLOCK * CHUNKS; i += THREADS) {
      const int t = t0 + i / CHUNKS;
      if (t < steps)
        cp_async16(dst + 16 * i, g_row + t * t_bytes + 16 * (i % CHUNKS));
    }
    cp_async_commit();
  };
  fetch(0);
  cp_async_wait<0>();
  __syncthreads();

  T* o_ptr = out + static_cast<size_t>(b) * steps * H + u;
  // unrolled by the block, so step t = t0 + p finds its gate row (p) and
  // its h_s buffer (p & 1) at offsets known to the compiler
  for (int t0 = 0; t0 < steps; t0 += BLOCK) {
    const T(*g_blk)[G] = gx_s[(t0 / BLOCK) & 1];
#pragma unroll
    for (int p = 0; p < BLOCK; ++p) {
      const int t = t0 + p;
      if (t >= steps) break;
      if (p == 0) fetch(t0 + BLOCK);  // into the half the last block read

      // this lane's partial pre-activations of the unit's four gates, two
      // accumulators a gate to halve the FMA dependency chain
      const float4* h4 = reinterpret_cast<const float4*>(h_s[p & 1]);
      float acc[4][2] = {};
#pragma unroll
      for (int m = 0; m < ROWS / 4; ++m) {
        const float4 hv = h4[LANES * m + r];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g][0] = fmaf(hv.x, w[g][4 * m + 0], acc[g][0]);
          acc[g][1] = fmaf(hv.y, w[g][4 * m + 1], acc[g][1]);
          acc[g][0] = fmaf(hv.z, w[g][4 * m + 2], acc[g][0]);
          acc[g][1] = fmaf(hv.w, w[g][4 * m + 3], acc[g][1]);
        }
      }
      float part[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) part[g] = acc[g][0] + acc[g][1];
      float a[NG];
      reduce_gates<LANES>(part, r, a);

      // activate this lane's gates NG * r .. NG * r + NG - 1 (gate 2 is
      // the tanh one), then gather i, f, g, o from the group; every lane of
      // it updates (c, h)
      const T* g_in = g_blk[p] + NG * r * H + u;
      float act[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q)
        act[q] = gate_act(a[q] + to_f32(g_in[q * H]),
                          NG * r + q == 2 ? 2.0f : 1.0f);
      float ga[4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        ga[gi] = __shfl_sync(FULL_MASK, act[gi % NG], gi / NG, LANES);
      c = fmaf(ga[1], c, ga[0] * ga[2]);
      h = ga[3] * fast_tanh(c);
      if (r == 0) {
        h_s[(p + 1) & 1][u] = as_operand<T>(h);
        o_ptr[static_cast<size_t>(t) * H] = from_f32<T>(h);
      }
      if (p == BLOCK - 1) cp_async_wait<0>();  // the next block landed
      __syncthreads();
    }
  }
  if (r == 0) {
    hf[b * H + u] = h;
    cf[b * H + u] = c;
  }
}

template <typename T>
int launch(const void* gx, const void* whh, const float* h0, const float* c0,
           void* out, float* hf, float* cf, int steps, int batch, int hidden,
           cudaStream_t stream) {
  const T* g = static_cast<const T*>(gx);
  const T* w = static_cast<const T*>(whh);
  T* o = static_cast<T*>(out);
  switch (hidden) {
    case 16:
      lstm_recurrence_kernel<T, 16><<<batch, 16 * LANES, 0, stream>>>(
          g, w, h0, c0, o, hf, cf, steps, batch);
      break;
    case 32:
      lstm_recurrence_kernel<T, 32><<<batch, 32 * LANES, 0, stream>>>(
          g, w, h0, c0, o, hf, cf, steps, batch);
      break;
    case 64:
      lstm_recurrence_kernel<T, 64><<<batch, 64 * LANES, 0, stream>>>(
          g, w, h0, c0, o, hf, cf, steps, batch);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = f32, 1 = bf16. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lstm_recurrence(const void* gx, const void* whh,
                               const float* h0, const float* c0, void* out,
                               float* hf, float* cf, int steps, int batch,
                               int hidden, int dtype, void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(gx, whh, h0, c0, out, hf, cf, steps, batch, hidden,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(gx, whh, h0, c0, out, hf, cf, steps, batch,
                                 hidden, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
