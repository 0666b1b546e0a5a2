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
// h_{t-1} is out[t-1] (h0 at t = 0) and c_{t-1} is cseq[t-1] (c0 at t = 0):
// no shifted copies are made. Outputs dgx [T, B, 4H], dW_hh [H, 4H],
// dh0/dc0 [B, H], all f32.
//
// What bounds them on an H100. At the stereo training shape (T=44,100,
// B=16, H=64) K2 moves 1.81 GB (gates in, acts, out and cseq out), 0.54 ms
// at 3.35 TB/s, and does 2.3e10 f32 operations (0.35 ms at 67 TFLOP/s);
// K3 moves 1.99 GB (0.59 ms) and does 4.6e10 operations (d_lin @ W_hh^T and
// the dW_hh outer products, 0.69 ms). The real floor of both is the chain
// of T dependent steps, as for the inference kernel.
//
// Design. Batch rows are independent, so each row gets one CTA with the
// time loop inside (nothing carries between CTAs on this card). In K2
// thread j keeps column j of W_hh in registers; two barriers a step. K3 is
// two launches. The walk uses the inference kernel's layout: hidden unit k
// belongs to a group of
// BWD_LANES lanes of one warp, which hold row k of W_hh split between them
// in registers. Each lane computes the unit's four d_lin from the step's
// residual row, stores its share of them to a double-buffered dlin_s and to
// dgx, and after the step's one barrier sums its share of
// dh[k] = sum_j d_lin[j] W_hh[k, j], which a shuffle butterfly completes
// (the same sum in every lane). The residual rows come through shared
// memory BWD_BLOCK steps at a time, copied by cp.async while the block
// before runs (lstm_common.cuh, lstm_recurrence.cu). dW_hh reads only out,
// h0 and dgx, all in device memory once the walk is done, so it is a second
// pass over them (split-K, partials added in a fixed order), not a product
// on the walk's step chain. No float atomics: results repeat run to run.
#include <stdint.h>

#include "lstm_common.cuh"

namespace {

constexpr int PREFETCH = 4;  // K2's residual prefetch depth

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
constexpr int BWD_LANES = 2;  // lanes per hidden unit in the walk
constexpr int BWD_BLOCK = 8;  // steps a residual copy covers (even)

// d[gi] for a gate index known only at run time, by selects (an indexed
// local array would go to local memory)
__device__ __forceinline__ float pick(const float (&d)[4], int gi) {
  return gi == 0 ? d[0] : gi == 1 ? d[1] : gi == 2 ? d[2] : d[3];
}

template <int H>
__global__ void __launch_bounds__(H * BWD_LANES, 1)
lstm_train_bwd_kernel(const float* __restrict__ acts,
                      const float* __restrict__ cseq,
                      const float* __restrict__ dout,
                      const float* __restrict__ whh,
                      const float* __restrict__ c0,
                      const float* __restrict__ dhf,
                      const float* __restrict__ dcf, float* __restrict__ dgx,
                      float* __restrict__ dh0, float* __restrict__ dc0,
                      int steps, int batch) {
  constexpr int L = BWD_LANES;
  constexpr int G = 4 * H;
  constexpr int COLS = G / L;  // columns of W_hh's row k a lane multiplies
  constexpr int NG = 4 / L;    // gates of d_lin a lane stores
  constexpr int THREADS = H * L;
  constexpr int RES = G + 2 * H;  // a residual row: acts, dout, c_{t-1}
  static_assert(COLS % 4 == 0, "a lane reads its share of d_lin as float4s");
  const int b = blockIdx.x;
  const int k = threadIdx.x / L;  // hidden unit
  const int r = threadIdx.x % L;  // lane in the unit's group

  __shared__ __align__(16) float dlin_s[2][G];
  __shared__ __align__(16) float res_s[2][BWD_BLOCK][RES];

  // lane r holds W_hh[k, j] for j = 4 * (L * m + r) + e: its float4s of
  // d_lin interleave with the other lanes', so a warp's loads hit distinct
  // banks
  float w[COLS];
#pragma unroll
  for (int m = 0; m < COLS / 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) w[4 * m + e] = whh[k * G + 4 * (L * m + r) + e];

  // the carry cotangents enter at the last step
  float dh = dhf[b * H + k];
  float dc = dcf[b * H + k];

  const size_t g_stride = static_cast<size_t>(batch) * G;
  const size_t h_stride = static_cast<size_t>(batch) * H;
  const size_t g_row = static_cast<size_t>(b) * G + k;
  const size_t h_row = static_cast<size_t>(b) * H + k;

  // walk step s is time t = steps - 1 - s. The residual rows (acts[t, b],
  // dout[t, b], c_{t-1}: cseq[t-1, b] or c0[b]) of steps [s0, s0 +
  // BWD_BLOCK) sit in res_s[(s0 / BWD_BLOCK) & 1]; each block of rows is
  // copied by all threads while the block before it runs, one commit group
  // a block
  auto fetch = [&](int s0) {
    float* dst = res_s[(s0 / BWD_BLOCK) & 1][0];
    for (int i = threadIdx.x; i < BWD_BLOCK * G / 4; i += THREADS) {
      const int j = i / (G / 4), c4 = 4 * (i % (G / 4));
      if (s0 + j < steps)
        cp_async16(dst + j * RES + c4,
                   acts + (steps - 1 - s0 - j) * g_stride + b * G + c4);
    }
    for (int i = threadIdx.x; i < BWD_BLOCK * H / 4; i += THREADS) {
      const int j = i / (H / 4), c4 = 4 * (i % (H / 4));
      const int t = steps - 1 - s0 - j;
      if (s0 + j < steps) {
        cp_async16(dst + j * RES + G + c4, dout + t * h_stride + b * H + c4);
        cp_async16(dst + j * RES + G + H + c4,
                   (t > 0 ? cseq + (t - 1) * h_stride : c0) + b * H + c4);
      }
    }
    cp_async_commit();
  };
  fetch(0);
  cp_async_wait<0>();
  __syncthreads();

  // c_t of the current step; each step reads c_{t-1} and hands it down
  float c_t = steps > 0 ? cseq[(steps - 1) * h_stride + h_row] : 0.0f;

  // unrolled by the block, so step s = s0 + p finds its residual row (p)
  // and its dlin_s buffer (p & 1) at offsets known to the compiler
  for (int s0 = 0; s0 < steps; s0 += BWD_BLOCK) {
    const float(*res_blk)[RES] = res_s[(s0 / BWD_BLOCK) & 1];
#pragma unroll
    for (int p = 0; p < BWD_BLOCK; ++p) {
      const int s = s0 + p;
      if (s >= steps) break;
      const int t = steps - 1 - s;
      if (p == 0) fetch(s0 + BWD_BLOCK);  // into the half the last block read
      // every lane of the group reads the unit's four activations and
      // computes all four d_lin, so the group needs no shuffle before the
      // store
      const float* res = res_blk[p];
      const float ig = res[k], fg = res[H + k];
      const float gg = res[2 * H + k], og = res[3 * H + k];
      const float d_out = res[G + k], c_p = res[G + H + k];

      const float tc = fast_tanh(c_t);  // off the chain: c_t came earlier
      const float dh_tot = d_out + dh;
      const float d_o = dh_tot * tc;
      const float dct = dh_tot * og * (1.0f - tc * tc) + dc;
      float dl[4];
      dl[0] = dct * gg * ig * (1.0f - ig);
      dl[1] = dct * c_p * fg * (1.0f - fg);
      dl[2] = dct * ig * (1.0f - gg * gg);
      dl[3] = d_o * og * (1.0f - og);
      dc = dct * fg;
      c_t = c_p;
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const int gi = NG * r + q;
        const float v = pick(dl, gi);
        dlin_s[p & 1][gi * H + k] = v;
        dgx[t * g_stride + g_row + gi * H] = v;
      }
      if (p == BWD_BLOCK - 1) cp_async_wait<0>();  // the next block landed
      __syncthreads();  // d_lin of step t is visible

      // dh of step t - 1 = d_lin @ W_hh^T: this lane's columns, then a
      // butterfly across the group (every lane ends with the same sum)
      const float4* d4 = reinterpret_cast<const float4*>(dlin_s[p & 1]);
      float acc[2][4] = {};
#pragma unroll
      for (int m = 0; m < COLS / 4; ++m) {
        const float4 dv = d4[L * m + r];
        acc[m & 1][0] = fmaf(dv.x, w[4 * m + 0], acc[m & 1][0]);
        acc[m & 1][1] = fmaf(dv.y, w[4 * m + 1], acc[m & 1][1]);
        acc[m & 1][2] = fmaf(dv.z, w[4 * m + 2], acc[m & 1][2]);
        acc[m & 1][3] = fmaf(dv.w, w[4 * m + 3], acc[m & 1][3]);
      }
      float part = ((acc[0][0] + acc[1][0]) + (acc[0][1] + acc[1][1]))
                   + ((acc[0][2] + acc[1][2]) + (acc[0][3] + acc[1][3]));
#pragma unroll
      for (int sh = L / 2; sh >= 1; sh /= 2)
        part += __shfl_xor_sync(FULL_MASK, part, sh);
      dh = part;
    }
  }
  if (r == 0) {
    dh0[b * H + k] = dh;
    dc0[b * H + k] = dc;
  }
}

// ------------------------------------------------------------- dW_hh pass
// dW_hh = sum over (t, b) of h_{t-1, b}^T d_lin_{t, b}: a [H, 4H] product
// over K = T*B rows; row k = t*B + b pairs h0[b] (k < B) or out[k - B] with
// dgx[k]. It reads only what the walk wrote, so it runs after the walk,
// off its step chain. Split-K: CTA p sums rows [p*per, (p+1)*per) with the
// whole [H, 4H] tile in registers (an 8 x 8 block a thread), streaming rows
// through shared memory in DW_KC-row stages (cp.async, double-buffered);
// a second kernel adds the splits' partials in split order, so the result
// repeats run to run (no float atomics).
constexpr int DW_KC = 16;  // rows a stage
constexpr int DW_TM = 8;   // dW rows a thread
constexpr int DW_TN = 8;   // dW columns a thread: two float4s, 2H apart

template <int H>
__host__ __device__ constexpr int dw_threads() {
  return (H / DW_TM) * (4 * H / DW_TN);
}

template <int H>
__global__ void __launch_bounds__(dw_threads<H>())
dw_partial_kernel(const float* __restrict__ out, const float* __restrict__ h0,
                  const float* __restrict__ dgx, float* __restrict__ part,
                  int rows, int batch, int per) {
  constexpr int G = 4 * H;
  constexpr int NT = dw_threads<H>();
  constexpr int XN = G / DW_TN;          // threads across the columns
  constexpr int A4 = H / 4, B4 = G / 4;  // float4s in a row of h, of dgx
  __shared__ __align__(16) float a_s[2][DW_KC][H];
  __shared__ __align__(16) float b_s[2][DW_KC][G];
  const int tid = threadIdx.x;
  const int tx = tid % XN, ty = tid / XN;
  const int k_begin = blockIdx.x * per;
  const int k_end = min(k_begin + per, rows);

  auto stage = [&](int buf, int k0) {
    for (int i = tid; i < DW_KC * (A4 + B4); i += NT) {
      const int kk = i / (A4 + B4), c = i % (A4 + B4);
      const bool valid = k0 + kk < k_end;
      const int k = valid ? k0 + kk : k_begin;  // a readable row either way
      if (c < A4) {
        const float* src = k < batch ? h0 + static_cast<size_t>(k) * H
                                     : out + static_cast<size_t>(k - batch) * H;
        cp_async16(&a_s[buf][kk][4 * c], src + 4 * c, valid);
      } else {
        cp_async16(&b_s[buf][kk][4 * (c - A4)],
                   dgx + static_cast<size_t>(k) * G + 4 * (c - A4), valid);
      }
    }
    cp_async_commit();
  };

  float acc[DW_TM][DW_TN] = {};
  const int n_stages = (k_end - k_begin + DW_KC - 1) / DW_KC;
  if (n_stages > 0) stage(0, k_begin);
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      stage((st + 1) & 1, k_begin + (st + 1) * DW_KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = st & 1;
#pragma unroll
    for (int kk = 0; kk < DW_KC; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&a_s[buf][kk][ty * DW_TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][kk][ty * DW_TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[buf][kk][G / 2 + tx * 4]);
      const float av[DW_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[DW_TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < DW_TM; ++i)
#pragma unroll
        for (int j = 0; j < DW_TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the next stage may overwrite this buffer
  }

  float* dst = part + static_cast<size_t>(blockIdx.x) * H * G;
#pragma unroll
  for (int i = 0; i < DW_TM; ++i) {
    float* row = dst + (ty * DW_TM + i) * G;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + G / 2 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// dW_hh = the splits' partials added in split order.
__global__ void dw_sum_kernel(const float* __restrict__ part,
                              float* __restrict__ total, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < splits; ++p) s += part[static_cast<size_t>(p) * n + i];
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

// The walk: dgx, dh0 and dc0. Returns the cudaError_t of the launch.
extern "C" int lstm_train_bwd(const float* acts, const float* cseq,
                              const float* dout, const float* whh,
                              const float* c0, const float* dhf,
                              const float* dcf, float* dgx, float* dh0,
                              float* dc0, int steps, int batch, int hidden,
                              void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 16:
      lstm_train_bwd_kernel<16><<<batch, 16 * BWD_LANES, 0, s>>>(
          acts, cseq, dout, whh, c0, dhf, dcf, dgx, dh0, dc0, steps, batch);
      break;
    case 32:
      lstm_train_bwd_kernel<32><<<batch, 32 * BWD_LANES, 0, s>>>(
          acts, cseq, dout, whh, c0, dhf, dcf, dgx, dh0, dc0, steps, batch);
      break;
    case 64:
      lstm_train_bwd_kernel<64><<<batch, 64 * BWD_LANES, 0, s>>>(
          acts, cseq, dout, whh, c0, dhf, dcf, dgx, dh0, dc0, steps, batch);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dW_hh pass over the walk's dgx: part is scratch of splits * H * 4H
// floats, split p summing rows [p * per, min((p + 1) * per, steps * batch));
// dwhh receives their sum. Returns the cudaError_t of the launches.
extern "C" int lstm_train_dw(const float* out, const float* h0,
                             const float* dgx, float* dwhh, float* part,
                             int steps, int batch, int hidden, int splits,
                             int per, void* stream) {
  if (splits <= 0 || per <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = steps * batch;
  switch (hidden) {
    case 16:
      dw_partial_kernel<16><<<splits, dw_threads<16>(), 0, s>>>(
          out, h0, dgx, part, rows, batch, per);
      break;
    case 32:
      dw_partial_kernel<32><<<splits, dw_threads<32>(), 0, s>>>(
          out, h0, dgx, part, rows, batch, per);
      break;
    case 64:
      dw_partial_kernel<64><<<splits, dw_threads<64>(), 0, s>>>(
          out, h0, dgx, part, rows, batch, per);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = hidden * 4 * hidden;
  dw_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, dwhh, n, splits);
  return static_cast<int>(cudaGetLastError());
}
