// The int8 conv of the int8 serving path (ops/int8_conv.py): an s8 x s8 ->
// s32 implicit-GEMM convolution over an NWC input, then a fused epilogue in
// f32 that dequantizes, adds the bias and a residual, applies the
// activation and requantizes to s8 (or stores f32 / bf16).
//
//   acc[n,t,o] = sum_m sum_i xd[n, t*s + m - lo, i] * w[m, i, o]
//
// xd is the input lhs-dilated by `dil` (zeros inserted) and padded (lo, hi);
// a negative side crops. The GEMM has rows (n, t), columns o and K = kp*Cin
// (tap-major). One CTA computes a BM x BN tile; K advances 64 bytes at a
// time through shared memory (k-major 32-bit words). Layers with Cout >= 64
// (almost all the work) run on the tensor cores, mma.sync m16n8k32 s8 x s8
// -> s32 in 128 x 64 tiles; the narrow ones (Cout 1 at the exits, 32)
// accumulate TM x TN outputs a thread with __dp4a. Rows are gathered per
// tap: a tap that lands on an inserted zero, in the padding or past the K
// of the layer reads 0; under lhs dilation the rows go in phases that read
// only their own taps. A first design: no double buffering, no TMA or
// wgmma.
//
// The epilogue is the plain version's sequence of IEEE f32 operations, each
// rounded on its own (__fmul_rn / __fadd_rn, and the unit is built with
// -fmad=false), so the kernel equals the plain version bit for bit:
//   y = float(acc) * ws[o]; y += bias[o]; y += add (f32, or s8 * scale[o]);
//   y = y >= 0 ? y : 0.2 * y (leaky-ReLU);
//   s8 = clip(rint(y * inv[o]), -127, 127)   or   y as f32 / bf16.
//
// Weights come as [Cout_pad, K_pad] s8 rows (Cout padded to 64, K to 64,
// zeros), prepared once per layer by the wrapper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 64;            // bytes of K per step
constexpr int kWords = kTileK / 4;    // 32-bit words of K per step
constexpr int kInvalid = -(1 << 30);  // row offset of a row past the end

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* ws;
  const float* bias;
  const void* add;
  const float* add_scale;
  const float* inv;
  void* out;
  long long rows;  // output rows of one phase: n * tpc
  int t_in, cin, t_out, cout, kp, k, k_pad, stride, dil, lo, span;
  // Under lhs dilation (window stride 1) an output row at t reads only the
  // taps m = lo - t (mod dil): the rows are split into `phases` = dil
  // residues of t, one grid z each, and K runs over that phase's taps
  // alone (tpc rows of t a sequence). Otherwise one phase of every tap.
  int phases, tpc;
  int add_mode;  // 0 none, 1 f32, 2 s8 * add_scale
  int act;       // 0 none, 1 leaky-ReLU 0.2
  int out_mode;  // 0 s8 (inv), 1 f32, 2 bf16
};

// The taps of one phase (blockIdx.z): K index k reads tap m0 + step *
// (k / Cin), channel k % Cin, for k < kc.
struct Phase {
  int c, m0, step, kc;
};

__device__ __forceinline__ Phase phase_of(const Args& a) {
  Phase p;
  p.c = blockIdx.z;
  if (a.phases > 1) {
    p.m0 = ((a.lo - p.c) % a.dil + a.dil) % a.dil;
    p.step = a.dil;
    p.kc = p.m0 < a.kp ? (a.kp - p.m0 + a.dil - 1) / a.dil * a.cin : 0;
  } else {
    p.m0 = 0;
    p.step = 1;
    p.kc = a.k;
  }
  return p;
}

// Four consecutive K bytes (k a multiple of 4) of one row, zero where the
// tap is out of range. VEC bytes share a tap (Cin % VEC == 0).
template <int VEC>
__device__ __forceinline__ int load_word(const Args& a, const Phase& ph,
                                         long long base, int u0, int k) {
  if (VEC >= 4) {
    int q = k / a.cin;
    int i = k - q * a.cin;
    int u = u0 + ph.m0 + ph.step * q;
    if (k >= ph.kc || u < 0 || u >= a.span || u % a.dil) return 0;
    return *reinterpret_cast<const int*>(
        a.x + (base + u / a.dil) * a.cin + i);
  }
  int word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int kk = k + b;
    int q = kk / a.cin;
    int i = kk - q * a.cin;
    int u = u0 + ph.m0 + ph.step * q;
    int v = 0;
    if (kk < ph.kc && u >= 0 && u < a.span && u % a.dil == 0)
      v = static_cast<uint8_t>(a.x[(base + u / a.dil) * a.cin + i]);
    word |= v << (8 * b);
  }
  return word;
}

__device__ __forceinline__ float epilogue(const Args& a, int acc,
                                          long long idx, int col) {
  float y = __fmul_rn(__int2float_rn(acc), a.ws[col]);
  if (a.bias != nullptr) y = __fadd_rn(y, a.bias[col]);
  if (a.add_mode == 1) {
    y = __fadd_rn(y, static_cast<const float*>(a.add)[idx]);
  } else if (a.add_mode == 2) {
    float v = __int2float_rn(static_cast<const int8_t*>(a.add)[idx]);
    y = __fadd_rn(y, __fmul_rn(v, a.add_scale[col]));
  }
  if (a.act == 1) y = y >= 0.0f ? y : __fmul_rn(y, 0.2f);
  return y;
}

__device__ __forceinline__ void store(const Args& a, float y, long long idx,
                                      int col) {
  if (a.out_mode == 0) {
    float q = rintf(__fmul_rn(y, a.inv[col]));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    static_cast<int8_t*>(a.out)[idx] = static_cast<int8_t>(q);
  } else if (a.out_mode == 1) {
    static_cast<float*>(a.out)[idx] = y;
  } else {
    static_cast<__nv_bfloat16*>(a.out)[idx] = __float2bfloat16_rn(y);
  }
}

// The row tables of a tile: each row's input base (n * t_in), the dilated
// position of its tap 0 (t * stride - lo), and its output row (n * t_out +
// t, or -1 past the end). Row R of phase c is t = c + phases * (R % tpc).
template <int BM>
__device__ __forceinline__ void row_tables(const Args& a, const Phase& ph,
                                           long long row0,
                                           long long* row_base, int* row_u0,
                                           long long* row_out) {
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const long long row = row0 + r;
    const long long n = row / a.tpc;
    const int t = ph.c + a.phases * static_cast<int>(row - n * a.tpc);
    if (row < a.rows && t < a.t_out) {
      row_base[r] = n * a.t_in;
      row_u0[r] = t * a.stride - a.lo;
      row_out[r] = n * a.t_out + t;
    } else {
      row_base[r] = 0;
      row_u0[r] = kInvalid;
      row_out[r] = -1;
    }
  }
  __syncthreads();
}

// One K step into shared memory, k-major 32-bit words: xs[word][row] (the
// rows' taps gathered, zeros where a tap is out of range) and
// wsm[word][col].
template <int BM, int BN, int VEC>
__device__ __forceinline__ void load_step(const Args& a, const Phase& ph,
                                          int k0, int col0,
                                          const long long* row_base,
                                          const int* row_u0, int* xs,
                                          int* wsm) {
  constexpr int XPAD = BM + 4;  // row strides keep 16-byte alignment and
  constexpr int WPAD = BN + 4;  // spread a warp's fragment loads over banks
  constexpr int XCHUNK = VEC >= 16 ? 16 : 4;  // bytes a thread loads at once
  constexpr int XPER = kTileK / XCHUNK;       // chunks per row
  constexpr int WCHUNKS = BN * (kTileK / 16);
  const int tid = threadIdx.x;
  for (int c = tid; c < BM * XPER; c += kThreads) {
    const int r = c / XPER;
    const int kk = (c % XPER) * XCHUNK;
    const int u0 = row_u0[r];
    if constexpr (XCHUNK == 16) {
      int4 v = make_int4(0, 0, 0, 0);
      const int k = k0 + kk;
      const int q = k / a.cin;
      const int u = u0 + ph.m0 + ph.step * q;
      if (k < ph.kc && u >= 0 && u < a.span && u % a.dil == 0) {
        const int i = k - q * a.cin;
        v = *reinterpret_cast<const int4*>(
            a.x + (row_base[r] + u / a.dil) * a.cin + i);
      }
      const int w0 = kk / 4;
      xs[(w0 + 0) * XPAD + r] = v.x;
      xs[(w0 + 1) * XPAD + r] = v.y;
      xs[(w0 + 2) * XPAD + r] = v.z;
      xs[(w0 + 3) * XPAD + r] = v.w;
    } else {
      xs[(kk / 4) * XPAD + r] =
          load_word<VEC>(a, ph, row_base[r], u0, k0 + kk);
    }
  }
  for (int c = tid; c < WCHUNKS; c += kThreads) {
    const int col = c / (kTileK / 16);
    const int k = k0 + (c % (kTileK / 16)) * 16;
    const int kk = k - k0;
    // the phase's taps only: 16 bytes stay in one tap (Cin % 16 == 0 when
    // phases > 1; otherwise step 1 keeps K contiguous)
    const int q = k / a.cin;
    const int wk = (ph.m0 + ph.step * q) * a.cin + (k - q * a.cin);
    int4 v = make_int4(0, 0, 0, 0);
    if (ph.step == 1 || k < ph.kc)
      v = *reinterpret_cast<const int4*>(
          a.w + static_cast<long long>(col0 + col) * a.k_pad + wk);
    const int w0 = kk / 4;
    wsm[(w0 + 0) * WPAD + col] = v.x;
    wsm[(w0 + 1) * WPAD + col] = v.y;
    wsm[(w0 + 2) * WPAD + col] = v.z;
    wsm[(w0 + 3) * WPAD + col] = v.w;
  }
}

// The narrow layers (Cout < 64): TM x TN outputs a thread by __dp4a, TX
// threads across the columns of the tile.
template <int TM, int TN, int TX, int VEC>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(Args a) {
  constexpr int TY = kThreads / TX;
  constexpr int BM = TY * TM;
  constexpr int BN = TX * TN;
  constexpr int XPAD = BM + 4;
  constexpr int WPAD = BN + 4;
  __shared__ __align__(16) int xs[kWords * XPAD];
  __shared__ __align__(16) int wsm[kWords * WPAD];
  __shared__ long long row_base[BM];
  __shared__ long long row_out[BM];
  __shared__ int row_u0[BM];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;
  const Phase ph = phase_of(a);
  row_tables<BM>(a, ph, row0, row_base, row_u0, row_out);

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < ph.kc; k0 += kTileK) {
    __syncthreads();  // the last step's reads done
    load_step<BM, BN, VEC>(a, ph, k0, col0, row_base, row_u0, xs, wsm);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      int xa[TM], wb[TN];
      if constexpr (TM == 4) {
        const int4 v = *reinterpret_cast<const int4*>(
            &xs[kw * XPAD + ty * TM]);
        xa[0] = v.x; xa[1] = v.y; xa[2] = v.z; xa[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) xa[i] = xs[kw * XPAD + ty * TM + i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) wb[j] = wsm[kw * WPAD + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(xa[i], wb[j],
                                                         acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = row_out[ty * TM + i];
    if (row < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col >= a.cout) continue;
      const long long idx = row * a.cout + col;
      store(a, epilogue(a, acc[i][j], idx, col), idx, col);
    }
  }
}

// d = c + a * b on the tensor cores: one m16n8k32 s8 x s8 -> s32 tile of
// the warp (a: 16 rows x 32 K bytes, b: 32 K bytes x 8 columns).
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const int (&a)[4],
                                             const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The wide layers (Cout >= 64): a 128 x 64 tile a CTA, eight warps of
// 32 x 32, each warp 2 x 4 mma.sync m16n8k32 tiles a 32-byte K step. The
// fragments are read straight from the k-major words (lane g = lane / 4
// takes rows g and g + 8, lane t = lane % 4 the K bytes 4t..4t+3 and
// 16+4t..16+4t+3); the integer sums are exact, so the order of the
// products does not matter.
template <int VEC>
__global__ void __launch_bounds__(kThreads) int8_conv_mma_kernel(Args a) {
  constexpr int BM = 128;
  constexpr int BN = 64;
  constexpr int XPAD = BM + 4;
  constexpr int WPAD = BN + 4;
  __shared__ __align__(16) int xs[kWords * XPAD];
  __shared__ __align__(16) int wsm[kWords * WPAD];
  __shared__ long long row_base[BM];
  __shared__ long long row_out[BM];
  __shared__ int row_u0[BM];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / 2) * 32;  // the warp's rows in the tile
  const int wn = (warp % 2) * 32;  // and its columns
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;
  const Phase ph = phase_of(a);
  row_tables<BM>(a, ph, row0, row_base, row_u0, row_out);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < ph.kc; k0 += kTileK) {
    __syncthreads();
    load_step<BM, BN, VEC>(a, ph, k0, col0, row_base, row_u0, xs, wsm);
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < kWords; kb += 8) {  // 32 K bytes a step
      int fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        fa[i][0] = xs[(kb + t) * XPAD + r];
        fa[i][1] = xs[(kb + t) * XPAD + r + 8];
        fa[i][2] = xs[(kb + 4 + t) * XPAD + r];
        fa[i][3] = xs[(kb + 4 + t) * XPAD + r + 8];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn + j * 8 + g;
        fb[j][0] = wsm[(kb + t) * WPAD + col];
        fb[j][1] = wsm[(kb + 4 + t) * WPAD + col];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], fa[i], fb[j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row_out[wm + i * 16 + g + 8 * h];
      if (row < 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + wn + j * 8 + 2 * t + e;
          if (col >= a.cout) continue;
          const long long idx = row * a.cout + col;
          store(a, epilogue(a, acc[i][j][2 * h + e], idx, col), idx, col);
        }
    }
}

template <int TM, int TN, int TX>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int BM = (kThreads / TX) * TM;
  constexpr int BN = TX * TN;
  dim3 grid(static_cast<unsigned>((a.rows + BM - 1) / BM),
            static_cast<unsigned>((a.cout + BN - 1) / BN), a.phases);
  if (a.cin % 16 == 0)
    int8_conv_kernel<TM, TN, TX, 16><<<grid, kThreads, 0, stream>>>(a);
  else if (a.cin % 4 == 0)
    int8_conv_kernel<TM, TN, TX, 4><<<grid, kThreads, 0, stream>>>(a);
  else
    int8_conv_kernel<TM, TN, TX, 1><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>((a.rows + 127) / 128),
            static_cast<unsigned>((a.cout + 63) / 64), a.phases);
  if (a.cin % 16 == 0)
    int8_conv_mma_kernel<16><<<grid, kThreads, 0, stream>>>(a);
  else if (a.cin % 4 == 0)
    int8_conv_mma_kernel<4><<<grid, kThreads, 0, stream>>>(a);
  else
    int8_conv_mma_kernel<1><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x [n, t_in, cin] s8 (16-byte aligned), w [Cout_pad, k_pad] s8 rows, ws /
// bias / add_scale / inv [cout] f32 (bias, add, add_scale and inv may be
// null as the modes say), add and out [n, t_out, cout]. Returns the
// cudaError_t of the launch.
extern "C" int int8_conv(const int8_t* x, const int8_t* w, const float* ws,
                         const float* bias, const void* add,
                         const float* add_scale, const float* inv, void* out,
                         int n, int t_in, int cin, int t_out, int cout,
                         int kp, int k_pad, int stride, int dil, int lo,
                         int add_mode, int act, int out_mode,
                         cudaStream_t stream) {
  Args a;
  a.x = x;
  a.w = w;
  a.ws = ws;
  a.bias = bias;
  a.add = add;
  a.add_scale = add_scale;
  a.inv = inv;
  a.out = out;
  a.t_in = t_in;
  a.cin = cin;
  a.t_out = t_out;
  a.cout = cout;
  a.kp = kp;
  a.k = kp * cin;
  a.k_pad = k_pad;
  a.stride = stride;
  a.dil = dil;
  a.lo = lo;
  a.span = (t_in - 1) * dil + 1;
  a.add_mode = add_mode;
  a.act = act;
  a.out_mode = out_mode;
  a.phases = dil > 1 && stride == 1 && cin % 16 == 0 ? dil : 1;
  a.tpc = (t_out + a.phases - 1) / a.phases;
  a.rows = static_cast<long long>(n) * a.tpc;
  if (a.rows == 0 || cout == 0) return 0;
  if (cout == 1) return static_cast<int>(launch<2, 1, 1>(a, stream));
  if (cout < 64) return static_cast<int>(launch<4, 1, 16>(a, stream));
  return static_cast<int>(launch_mma(a, stream));
}
