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
// chain of T dependent steps: each step needs the h of the step before.
//
// Design. Batch rows are independent, so each row gets one CTA and the time
// loop runs inside it (nothing carries between CTAs on this card). The CTA has
// 4H threads; thread j owns gate column j: it keeps W_hh[:, j] in registers,
// so a step's matrix-vector product is H register FMAs a thread against h
// broadcast from shared memory. Two __syncthreads a step: one after the
// gates are activated, one after the first H threads updated (c, h). Each
// thread prefetches its gate value PREFETCH steps ahead, so the step chain
// does not wait on device memory. No batch or time padding: the grid is B
// CTAs and the loop runs exactly T steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PREFETCH = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// h as the product sees it: rounded to the gates' type, as the TPU kernel
// casts h to W_hh's dtype before the dot.
template <typename T>
__device__ __forceinline__ float as_operand(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T, int H>
__global__ void __launch_bounds__(4 * H, 1)
lstm_recurrence_kernel(const T* __restrict__ gx, const T* __restrict__ whh,
                       const float* __restrict__ h0,
                       const float* __restrict__ c0, T* __restrict__ out,
                       float* __restrict__ hf, float* __restrict__ cf,
                       int steps, int batch) {
  constexpr int G = 4 * H;
  const int b = blockIdx.x;
  const int j = threadIdx.x;

  __shared__ __align__(16) float h_s[H];
  __shared__ float act_s[G];

  float w[H];
#pragma unroll
  for (int k = 0; k < H; ++k) w[k] = to_f32(whh[k * G + j]);

  float h = 0.0f, c = 0.0f;
  if (j < H) {
    h = h0[b * H + j];
    c = c0[b * H + j];
    h_s[j] = as_operand<T>(h);
  }
  const bool is_tanh = (j >= 2 * H) && (j < 3 * H);
  const size_t t_stride = static_cast<size_t>(batch) * G;
  const T* g_ptr = gx + static_cast<size_t>(b) * G + j;
  T* o_ptr = out + static_cast<size_t>(b) * steps * H + j;

  float ring[PREFETCH];
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u)
    ring[u] = u < steps ? to_f32(g_ptr[u * t_stride]) : 0.0f;
  __syncthreads();

  for (int t0 = 0; t0 < steps; t0 += PREFETCH) {
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int t = t0 + u;
      if (t >= steps) break;
      const float g_in = ring[u];
      if (t + PREFETCH < steps)
        ring[u] = to_f32(g_ptr[(t + PREFETCH) * t_stride]);

      // four independent accumulators shorten the FMA dependency chain
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      const float4* h4 = reinterpret_cast<const float4*>(h_s);
#pragma unroll
      for (int k = 0; k < H / 4; ++k) {
        const float4 hv = h4[k];
        a0 = fmaf(hv.x, w[4 * k + 0], a0);
        a1 = fmaf(hv.y, w[4 * k + 1], a1);
        a2 = fmaf(hv.z, w[4 * k + 2], a2);
        a3 = fmaf(hv.w, w[4 * k + 3], a3);
      }
      const float a = ((a0 + a1) + (a2 + a3)) + g_in;
      act_s[j] = is_tanh ? tanhf(a) : sigmoid(a);
      __syncthreads();

      if (j < H) {
        const float ig = act_s[j], fg = act_s[H + j];
        const float gg = act_s[2 * H + j], og = act_s[3 * H + j];
        c = fg * c + ig * gg;
        h = og * tanhf(c);
        h_s[j] = as_operand<T>(h);
        o_ptr[static_cast<size_t>(t) * H] = from_f32<T>(h);
      }
      __syncthreads();
    }
  }
  if (j < H) {
    hf[b * H + j] = h;
    cf[b * H + j] = c;
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
      lstm_recurrence_kernel<T, 16><<<batch, 64, 0, stream>>>(
          g, w, h0, c0, o, hf, cf, steps, batch);
      break;
    case 32:
      lstm_recurrence_kernel<T, 32><<<batch, 128, 0, stream>>>(
          g, w, h0, c0, o, hf, cf, steps, batch);
      break;
    case 64:
      lstm_recurrence_kernel<T, 64><<<batch, 256, 0, stream>>>(
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
