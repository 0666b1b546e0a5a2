// LSTM training recurrence for Hopper (sm_90a): the forward that saves the
// backward's residuals (K2) and the reverse-time backward (K3), all in f32.
//
// K2 replaces the Pallas TPU kernel ml_audio_restoration_tpu/ops/pallas/
// lstm.py::_lstm_train_fwd_kernel. Per step t and batch row b, gate order
// i, f, g, o:
//   a = h @ W_hh + gx[t, b]        (h and W_hh in f32; h is NOT rounded to
//                                   the gates' type, unlike the inference
//                                   kernel, because training runs the
//                                   recurrence at parameter precision)
//   acts[t, b] = (sigmoid a_i, sigmoid a_f, tanh a_g, sigmoid a_o)
//   c = f * c + i * g;  h = o * tanh(c);  out[t, b] = h;  cseq[t, b] = c
// (hf, cf) is the state after step T-1. Shapes: gx [T, B, 4H] (f32 or bf16,
// upcast on load), W_hh [H, 4H] f32, h0/c0/hf/cf [B, H] f32, out and cseq
// [T, B, H] f32, acts [T, B, 4H] f32. All time-major, like the TPU kernel's
// outputs.
//
// K3 replaces ml_audio_restoration_tpu/ops/pallas/lstm.py::
// _lstm_train_bwd_kernel. Walking t from T-1 down to 0, with the carry
// cotangents (dh, dc) seeded by (dhf, dcf) at t = T-1:
//   dh_tot = dout[t] + dh;  tc = tanh(c_t);  do = dh_tot * tc
//   dct = dh_tot * o * (1 - tc^2) + dc
//   d_lin = (dct*g * i(1-i), dct*c_{t-1} * f(1-f), dct*i * (1-g^2),
//            do * o(1-o))                      -> dgx[t, b]
//   dh = d_lin @ W_hh^T;  dc = dct * f;  dW_hh += h_{t-1}^T d_lin
// h_{t-1} is read from out[t-1] (h0 at t = 0) and c_{t-1} from cseq[t-1]
// (c0 at t = 0): no shifted copies are made. Outputs dgx [T, B, 4H],
// dW_hh [H, 4H], dh0/dc0 [B, H], all f32.
//
// What bounds them on an H100. At the stereo training shape (T=44,100,
// B=16, H=64) K2 moves 1.81 GB (gates in, acts, out and cseq out), 0.54 ms
// at 3.35 TB/s, and does 2.3e10 f32 operations (0.35 ms at 67 TFLOP/s);
// K3 moves 1.99 GB (0.59 ms) and does 4.6e10 operations (d_lin @ W_hh^T and
// the dW_hh outer products, 0.69 ms). The real floor of both is the chain
// of T dependent steps, as for the inference kernel.
//
// Design. Batch rows are independent, so each row gets one CTA of 4H
// threads with the time loop inside (nothing carries between CTAs on this
// card). K2 is the inference kernel's layout: thread j keeps column j of
// W_hh in registers; two barriers a step. K3 needs two products a step.
// dW_hh[:, j] += h_{t-1} * d_lin[j] is thread j's: it keeps that column as
// an f32 partial in registers for the whole run. dh = d_lin @ W_hh^T would
// need a 4H-way reduction per output in the column layout, so the same
// threads also play a second role: thread (q, k) = (tid / H, tid % H) keeps
// W_hh[k, qH:(q+1)H] in registers and sums its quarter of the gate axis
// (d_lin is a warp-wide broadcast from shared memory, q being constant per
// warp for H >= 32); the four quarter sums meet in shared memory and the
// cell-state threads add them in a fixed order at the next step. Two
// barriers a step. The B per-CTA dW_hh partials are summed by a second
// kernel in a fixed order, so results repeat run to run (no float atomics).
// Residual and cotangent loads are prefetched PREFETCH steps ahead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PREFETCH = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ------------------------------------------------------------------ K2
template <typename T, int H>
__global__ void __launch_bounds__(4 * H, 1)
lstm_train_fwd_kernel(const T* __restrict__ gx, const float* __restrict__ whh,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0, float* __restrict__ out,
                      float* __restrict__ hf, float* __restrict__ cf,
                      float* __restrict__ acts, float* __restrict__ cseq,
                      int steps, int batch) {
  constexpr int G = 4 * H;
  const int b = blockIdx.x;
  const int j = threadIdx.x;

  __shared__ __align__(16) float h_s[H];
  __shared__ float act_s[G];

  float w[H];
#pragma unroll
  for (int k = 0; k < H; ++k) w[k] = whh[k * G + j];

  float h = 0.0f, c = 0.0f;
  if (j < H) {
    h = h0[b * H + j];
    c = c0[b * H + j];
    h_s[j] = h;
  }
  const bool is_tanh = (j >= 2 * H) && (j < 3 * H);
  const size_t g_stride = static_cast<size_t>(batch) * G;
  const size_t h_stride = static_cast<size_t>(batch) * H;
  const T* g_ptr = gx + static_cast<size_t>(b) * G + j;
  float* a_ptr = acts + static_cast<size_t>(b) * G + j;
  float* o_ptr = out + static_cast<size_t>(b) * H + j;
  float* c_ptr = cseq + static_cast<size_t>(b) * H + j;

  float ring[PREFETCH];
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u)
    ring[u] = u < steps ? to_f32(g_ptr[u * g_stride]) : 0.0f;
  __syncthreads();

  for (int t0 = 0; t0 < steps; t0 += PREFETCH) {
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int t = t0 + u;
      if (t >= steps) break;
      const float g_in = ring[u];
      if (t + PREFETCH < steps)
        ring[u] = to_f32(g_ptr[(t + PREFETCH) * g_stride]);

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
      const float act = is_tanh ? tanhf(a) : sigmoid(a);
      act_s[j] = act;
      a_ptr[t * g_stride] = act;
      __syncthreads();

      if (j < H) {
        const float ig = act_s[j], fg = act_s[H + j];
        const float gg = act_s[2 * H + j], og = act_s[3 * H + j];
        c = fg * c + ig * gg;
        h = og * tanhf(c);
        h_s[j] = h;
        o_ptr[t * h_stride] = h;
        c_ptr[t * h_stride] = c;
      }
      __syncthreads();
    }
  }
  if (j < H) {
    hf[b * H + j] = h;
    cf[b * H + j] = c;
  }
}

// ------------------------------------------------------------------ K3
template <int H>
__global__ void __launch_bounds__(4 * H, 1)
lstm_train_bwd_kernel(const float* __restrict__ acts,
                      const float* __restrict__ cseq,
                      const float* __restrict__ out,
                      const float* __restrict__ dout,
                      const float* __restrict__ whh,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const float* __restrict__ dhf,
                      const float* __restrict__ dcf, float* __restrict__ dgx,
                      float* __restrict__ dh0, float* __restrict__ dc0,
                      float* __restrict__ dw_part, int steps, int batch) {
  constexpr int G = 4 * H;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;  // gate column j for dgx and dW_hh[:, j]
  const int q = tid / H;        // quarter of the gate axis, for dh
  const int k = tid % H;        // hidden unit, for dh
  const bool cell = tid < H;    // owns (dh, dc) of hidden unit tid

  __shared__ __align__(16) float hprev_s[H];
  __shared__ __align__(16) float dlin_s[G];
  __shared__ float act_s[G];
  __shared__ float red_s[4][H];

  float w[H];  // W_hh[k, qH + m]
#pragma unroll
  for (int m = 0; m < H; ++m) w[m] = whh[k * G + q * H + m];
  float dw[H];  // this row's partial of dW_hh[:, tid]
#pragma unroll
  for (int m = 0; m < H; ++m) dw[m] = 0.0f;

  // the carry cotangents enter at the last step
  red_s[q][k] = q == 0 ? dhf[b * H + k] : 0.0f;
  float dc = cell ? dcf[b * H + tid] : 0.0f;

  const size_t g_stride = static_cast<size_t>(batch) * G;
  const size_t h_stride = static_cast<size_t>(batch) * H;
  const size_t g_row = static_cast<size_t>(b) * G + tid;
  const size_t h_row = static_cast<size_t>(b) * H + (cell ? tid : 0);

  // c_t of the current step; each step loads c_{t-1} and hands it down
  float c_t = (cell && steps > 0) ? cseq[(steps - 1) * h_stride + h_row]
                                  : 0.0f;

  // step s of the walk is time t = steps - 1 - s
  float r_act[PREFETCH], r_dout[PREFETCH], r_cp[PREFETCH], r_hp[PREFETCH];
  auto load = [&](int t, float& a, float& d, float& cp, float& hp) {
    a = acts[t * g_stride + g_row];
    if (cell) {
      d = dout[t * h_stride + h_row];
      cp = t > 0 ? cseq[(t - 1) * h_stride + h_row] : c0[h_row];
      hp = t > 0 ? out[(t - 1) * h_stride + h_row] : h0[h_row];
    }
  };
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u) {
    r_act[u] = r_dout[u] = r_cp[u] = r_hp[u] = 0.0f;
    if (u < steps) load(steps - 1 - u, r_act[u], r_dout[u], r_cp[u], r_hp[u]);
  }

  for (int s0 = 0; s0 < steps; s0 += PREFETCH) {
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int s = s0 + u;
      if (s >= steps) break;
      const int t = steps - 1 - s;
      const float a_j = r_act[u], d_out = r_dout[u];
      const float c_p = r_cp[u], h_p = r_hp[u];
      if (s + PREFETCH < steps)
        load(t - PREFETCH, r_act[u], r_dout[u], r_cp[u], r_hp[u]);

      act_s[tid] = a_j;
      __syncthreads();  // act_s and last step's dh quarters are visible

      if (cell) {
        const float dh = ((red_s[0][tid] + red_s[1][tid]) + red_s[2][tid])
                         + red_s[3][tid];
        const float ig = act_s[tid], fg = act_s[H + tid];
        const float gg = act_s[2 * H + tid], og = act_s[3 * H + tid];
        const float tc = tanhf(c_t);
        const float dh_tot = d_out + dh;
        const float d_o = dh_tot * tc;
        const float dct = dh_tot * og * (1.0f - tc * tc) + dc;
        dlin_s[tid] = dct * gg * ig * (1.0f - ig);
        dlin_s[H + tid] = dct * c_p * fg * (1.0f - fg);
        dlin_s[2 * H + tid] = dct * ig * (1.0f - gg * gg);
        dlin_s[3 * H + tid] = d_o * og * (1.0f - og);
        dc = dct * fg;
        hprev_s[tid] = h_p;
        c_t = c_p;
      }
      __syncthreads();  // d_lin and h_{t-1} are visible

      const float dl = dlin_s[tid];
      dgx[t * g_stride + g_row] = dl;
      const float4* hp4 = reinterpret_cast<const float4*>(hprev_s);
#pragma unroll
      for (int m = 0; m < H / 4; ++m) {
        const float4 hv = hp4[m];
        dw[4 * m + 0] = fmaf(hv.x, dl, dw[4 * m + 0]);
        dw[4 * m + 1] = fmaf(hv.y, dl, dw[4 * m + 1]);
        dw[4 * m + 2] = fmaf(hv.z, dl, dw[4 * m + 2]);
        dw[4 * m + 3] = fmaf(hv.w, dl, dw[4 * m + 3]);
      }
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
      const float4* dl4 = reinterpret_cast<const float4*>(dlin_s + q * H);
#pragma unroll
      for (int m = 0; m < H / 4; ++m) {
        const float4 dv = dl4[m];
        p0 = fmaf(dv.x, w[4 * m + 0], p0);
        p1 = fmaf(dv.y, w[4 * m + 1], p1);
        p2 = fmaf(dv.z, w[4 * m + 2], p2);
        p3 = fmaf(dv.w, w[4 * m + 3], p3);
      }
      // read by the cell threads after the next step's first barrier
      red_s[q][k] = (p0 + p1) + (p2 + p3);
    }
  }
  __syncthreads();
  if (cell) {
    dh0[b * H + tid] = ((red_s[0][tid] + red_s[1][tid]) + red_s[2][tid])
                       + red_s[3][tid];
    dc0[b * H + tid] = dc;
  }
  float* part = dw_part + static_cast<size_t>(b) * H * G + tid;
#pragma unroll
  for (int m = 0; m < H; ++m) part[m * G] = dw[m];
}

// dW_hh = sum over the B per-row partials, in row order.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ total, int n,
                                    int batch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int r = 0; r < batch; ++r) s += part[static_cast<size_t>(r) * n + i];
  total[i] = s;
}

template <typename T>
int launch_fwd(const void* gx, const float* whh, const float* h0,
               const float* c0, float* out, float* hf, float* cf, float* acts,
               float* cseq, int steps, int batch, int hidden,
               cudaStream_t stream) {
  const T* g = static_cast<const T*>(gx);
  switch (hidden) {
    case 16:
      lstm_train_fwd_kernel<T, 16><<<batch, 64, 0, stream>>>(
          g, whh, h0, c0, out, hf, cf, acts, cseq, steps, batch);
      break;
    case 32:
      lstm_train_fwd_kernel<T, 32><<<batch, 128, 0, stream>>>(
          g, whh, h0, c0, out, hf, cf, acts, cseq, steps, batch);
      break;
    case 64:
      lstm_train_fwd_kernel<T, 64><<<batch, 256, 0, stream>>>(
          g, whh, h0, c0, out, hf, cf, acts, cseq, steps, batch);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. dtype of gx: 0 = f32, 1 = bf16. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lstm_train_fwd(const void* gx, const float* whh,
                              const float* h0, const float* c0, float* out,
                              float* hf, float* cf, float* acts, float* cseq,
                              int steps, int batch, int hidden, int dtype,
                              void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(gx, whh, h0, c0, out, hf, cf, acts, cseq, steps,
                             batch, hidden, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(gx, whh, h0, c0, out, hf, cf, acts,
                                     cseq, steps, batch, hidden, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dw_part is scratch of B * H * 4H floats; dwhh receives its row sum.
extern "C" int lstm_train_bwd(const float* acts, const float* cseq,
                              const float* out, const float* dout,
                              const float* whh, const float* h0,
                              const float* c0, const float* dhf,
                              const float* dcf, float* dgx, float* dwhh,
                              float* dh0, float* dc0, float* dw_part,
                              int steps, int batch, int hidden,
                              void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16:
      lstm_train_bwd_kernel<16><<<batch, 64, 0, s>>>(
          acts, cseq, out, dout, whh, h0, c0, dhf, dcf, dgx, dh0, dc0,
          dw_part, steps, batch);
      break;
    case 32:
      lstm_train_bwd_kernel<32><<<batch, 128, 0, s>>>(
          acts, cseq, out, dout, whh, h0, c0, dhf, dcf, dgx, dh0, dc0,
          dw_part, steps, batch);
      break;
    case 64:
      lstm_train_bwd_kernel<64><<<batch, 256, 0, s>>>(
          acts, cseq, out, dout, whh, h0, c0, dhf, dcf, dgx, dh0, dc0,
          dw_part, steps, batch);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = hidden * 4 * hidden;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(dw_part, dwhh, n,
                                                      batch);
  return static_cast<int>(cudaGetLastError());
}
