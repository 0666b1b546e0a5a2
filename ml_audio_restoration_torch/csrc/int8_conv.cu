// The int8 conv of the int8 serving path (ops/int8_conv.py), for Hopper
// (sm_90a): an s8 x s8 -> s32 convolution over an NWC input, then a fused
// epilogue in f32 that dequantizes, adds the bias and a residual, applies
// the activation and requantizes to s8 (or stores f32 / bf16).
//
// Replaces what the JAX package leaves to XLA on the TPU:
// ml_audio_restoration_tpu/ops/quant.py:103-107 (int8_exec's
// conv_general_dilated(..., preferred_element_type=int32) and qconv's
// epilogue).
//
//   acc[n,t,o] = sum_m sum_i xd[n, t*s + m - lo, i] * w[m, i, o]
//
// xd is the input lhs-dilated by `dil` (zeros inserted) and padded (lo, hi);
// a negative side crops. The GEMM has rows (n, t), columns o and K = kp*Cin.
// ops/int8_conv.py::plan picks one of three paths from the shapes; this file
// trusts the plan (tile counts, channel block, ring depth) it is given.
//
// What bounds it on an H100. Every layer of the serving programs moves more
// bytes than the tensor cores need time for, apart from the widest (`hf`,
// `left.l1`, `left.l2`, near the line): at 64 chunks a layer reads 45-360 MB
// of s8 input and writes 90-360 MB, 0.03-0.5 ms at 3.35 TB/s, for at most
// 0.5 ms of int8 tensor work at 1,979 TOP/s. So each path reads its input
// from device memory once, keeps the tensor cores fed from shared memory,
// and writes its output in wide stores.
//
// 1. wgmma (Cin a multiple of 16: every program layer but the stems). One
//    CTA computes a tile of BM = 128 output rows of one sequence and one
//    phase (below) and the layer's whole Cout, padded to an N tile of 8, 32,
//    64, 128 or 256 columns, so the input tile is read once for every
//    column. K runs as chunks of one tap's `cw` channels (cw = 128, 64, 32
//    or 16 bytes, the widest that divides Cin): a chunk of A is one TMA box
//    of the input seen as a 3-D tensor [N, T_in, Cin], at (channel block,
//    t0*s + m - lo, n), so the padding, the cropping and the sequence edges
//    are the TMA unit's zero fill, and stride 2 is the box's element stride
//    along T (a box of 2*BM rows traversed every other row): the weight
//    rows and the K walk stay those of stride 1 (a pair view of x would
//    add zero weight halves, K 640 for 512, and need another treatment for
//    an odd T_in, which the zero fill covers here). A chunk of B
//    is one box of the weight rows [Cout_pad, K_pad]. One producer warp
//    keeps a ring of `stages` (>= 3) such stages in flight, each announced
//    to its full mbarrier by the bytes it brings; two consumer warpgroups
//    of 64 rows each run wgmma.mma_async m64nNk32 s8 x s8 -> s32 on both
//    operands in shared memory, K-major, the TMA swizzle (128 B, 64 B or
//    32 B rows; 16-byte chunks in pairs without swizzle for cw = 16) the
//    one in the matrix descriptors, and release the stage to its empty
//    mbarrier once their group has completed. Under lhs dilation (stride 1)
//    an output at t reads only the taps m = lo - t (mod dil): the rows
//    split into dil phases (t = c + dil*j), each reads only its own taps,
//    and for one phase each tap's rows are a contiguous run of input rows,
//    still one box. The phase moves fastest in the grid, so the dil reads
//    of one row block come from L2.
// 2. stem (Cin 1, no dilation, kp <= 32: the three raising convs, stride
//    4). Rows of 1 byte are below what TMA addresses. The row block's
//    input is one span of (BM-1)*s + kp bytes, read in 16-byte loads into
//    shared memory; the threads build the im2col tile (K <= 32: one k32
//    step) from it with multiplications only, and one wgmma a warpgroup
//    computes the tile. Its bound is the output it writes.
// 3. generic (what no path above takes: Cin % 16 != 0, Cin 1 under
//    dilation or with kp > 32, dilation with a window stride): the
//    kernel's first design, rows gathered per tap through shared memory,
//    mma.sync m16n8k32 for Cout >= 64 and __dp4a for the narrow ones. No
//    program layer takes it.
//
// The epilogue (every path) is the plain version's sequence of IEEE f32
// operations, each rounded on its own (__fmul_rn / __fadd_rn, and the unit
// is built with -fmad=false), so the kernel equals the plain version bit
// for bit:
//   y = float(acc) * ws[o]; y += bias[o]; y += add (f32, or s8 * scale[o]);
//   y = y >= 0 ? y : 0.2 * y (leaky-ReLU);
//   s8 = clip(rint(y * inv[o]), -127, 127)   or   y as f32 / bf16.
// The wgmma and stem paths stage the finished int32 tile in shared memory
// and run the epilogue over it in row order, four columns a thread, so a
// warp's loads of `add` and stores of the output are contiguous. That
// epilogue, not the loads or the wgmma, is most of the wgmma path's time
// (scripts/torch_int8_ablation.py): it runs after the tile's mainloop, so
// the N = 256 layers (one CTA an SM, by registers) overlap it with nothing.
//
// Weights come as [Cout_pad, K_pad] s8 rows (K = kp*Cin taps outer, zeros
// past Cout and K; K_pad >= K + 16, so columns K..K+15 are a zero chunk),
// prepared once per layer by the wrapper.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;               // output rows a tile (wgmma, stem)
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kWideThreads = kConsumers + 32;  // + the producer warp
constexpr int kThreads = 256;         // generic
constexpr int kTileK = 64;            // generic: bytes of K per step
constexpr int kWords = kTileK / 4;    // 32-bit words of K per step
constexpr int kInvalid = -(1 << 30);  // row offset of a row past the end
constexpr int kWindow = 1088;         // stem: input span bytes (stride <= 8)

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* ws;
  const float* bias;
  const void* add;
  const float* add_scale;
  const float* inv;
  void* out;
  long long rows;  // generic: n * t_out
  int n, t_in, cin, t_out, cout, kp, k, k_pad, stride, dil, lo, span;
  // wgmma / stem: the row tiling. A sequence's t_out rows go in `phases`
  // phases (t = c + phases * j) of `tiles` tiles of BM rows each; the
  // block index is (n * tiles + tile) * phases + c.
  int phases, tiles;
  // wgmma: channel block (bytes a box row), rows a box, ring depth, K
  // bytes a stage (max(cw, 32)), and the ring's byte layout
  int cw, rb, stages, ks;
  int a_stage, b_chunk, b_stage, bar_off, tx_bytes;
  int add_mode;  // 0 none, 1 f32, 2 s8 * add_scale
  int act;       // 0 none, 1 leaky-ReLU 0.2
  int out_mode;  // 0 s8 (inv), 1 f32, 2 bf16
};

// ---------------------------------------------------------------- epilogue

// clip(rint(y * inv), -127, 127) without a conversion instruction (they
// issue at an eighth of the f32 rate): clamping first gives the same code,
// and adding 1.5 * 2^23 to |q| <= 127 rounds it to an integer (to nearest,
// ties to even, as rint): the sum's bits are 0x4B400000 + code, whose low
// byte is the code.
__device__ __forceinline__ int8_t requant(float y, float inv) {
  const float q = fminf(fmaxf(__fmul_rn(y, inv), -127.0f), 127.0f);
  return static_cast<int8_t>(__float_as_int(__fadd_rn(q, 12582912.0f)));
}

// leaky-ReLU 0.2 as max(y, 0.2 y): the same value as y >= 0 ? y : 0.2 y
// for every y (0.2f < 1; -0 and NaN too), in two operations.
__device__ __forceinline__ float lrelu(float y) {
  return fmaxf(y, __fmul_rn(y, 0.2f));
}

// An s8 code as f32 (exact) by the same device: 1.5 * 2^23 + v, less 1.5 *
// 2^23.
__device__ __forceinline__ float s8_to_f32(int v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.0f);
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
  if (a.act == 1) y = lrelu(y);
  return y;
}

__device__ __forceinline__ void store(const Args& a, float y, long long idx,
                                      int col) {
  if (a.out_mode == 0) {
    static_cast<int8_t*>(a.out)[idx] = requant(y, a.inv[col]);
  } else if (a.out_mode == 1) {
    static_cast<float*>(a.out)[idx] = y;
  } else {
    static_cast<__nv_bfloat16*>(a.out)[idx] = __float2bfloat16_rn(y);
  }
}

// The per-column operands of four adjacent columns, loaded once.
struct Cols4 {
  float ws[4], bias[4], scale[4], inv[4];
};

__device__ __forceinline__ Cols4 load_cols4(const Args& a, int col) {
  Cols4 p;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    p.ws[e] = a.ws[col + e];
    p.bias[e] = a.bias != nullptr ? a.bias[col + e] : 0.0f;
    p.scale[e] = a.add_mode == 2 ? a.add_scale[col + e] : 0.0f;
    p.inv[e] = a.out_mode == 0 ? a.inv[col + e] : 0.0f;
  }
  return p;
}

// The residual of four adjacent columns at idx (a multiple of 4) as f32:
// the f32 values, or the s8 codes converted (exactly).
__device__ __forceinline__ float4 load_add4(const Args& a, long long idx) {
  if (a.add_mode == 1)
    return *reinterpret_cast<const float4*>(
        static_cast<const float*>(a.add) + idx);
  if (a.add_mode == 2) {
    const char4 r = *reinterpret_cast<const char4*>(
        static_cast<const int8_t*>(a.add) + idx);
    return make_float4(s8_to_f32(r.x), s8_to_f32(r.y), s8_to_f32(r.z),
                       s8_to_f32(r.w));
  }
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Four adjacent columns at idx: the same operations as epilogue() +
// store() on each, from the columns' operands and the loaded residual, and
// one store.
__device__ __forceinline__ void finish4(const Args& a, const Cols4& p,
                                        int4 acc, float4 add,
                                        long long idx) {
  const int v[4] = {acc.x, acc.y, acc.z, acc.w};
  const float r[4] = {add.x, add.y, add.z, add.w};
  float y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    y[e] = __fmul_rn(__int2float_rn(v[e]), p.ws[e]);
    if (a.bias != nullptr) y[e] = __fadd_rn(y[e], p.bias[e]);
    if (a.add_mode == 1) {
      y[e] = __fadd_rn(y[e], r[e]);
    } else if (a.add_mode == 2) {
      y[e] = __fadd_rn(y[e], __fmul_rn(r[e], p.scale[e]));
    }
    if (a.act == 1) y[e] = lrelu(y[e]);
  }
  if (a.out_mode == 0) {
    char4 q;
    q.x = requant(y[0], p.inv[0]);
    q.y = requant(y[1], p.inv[1]);
    q.z = requant(y[2], p.inv[2]);
    q.w = requant(y[3], p.inv[3]);
    *reinterpret_cast<char4*>(static_cast<int8_t*>(a.out) + idx) = q;
  } else if (a.out_mode == 1) {
    *reinterpret_cast<float4*>(static_cast<float*>(a.out) + idx) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else {
    __nv_bfloat162 lo2 = __floats2bfloat162_rn(y[0], y[1]);
    __nv_bfloat162 hi2 = __floats2bfloat162_rn(y[2], y[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo2);
    u.y = *reinterpret_cast<uint32_t*>(&hi2);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + idx) = u;
  }
}

// The wgmma accumulator of a warpgroup (m64nN s32: thread (warp w, lane l)
// holds rows 16w + l/4 and +8, column pairs 8j + 2(l%4)) into the int32
// staging tile [BM][N + 8] (the pad spreads the rows over the banks).
template <int N>
__device__ __forceinline__ void stage_acc(int* st, const int (&d)[N / 2],
                                          int row0, int tid) {
  constexpr int P = N + 8;
  const int r = row0 + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
  const int c = 2 * (tid & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    *reinterpret_cast<int2*>(&st[r * P + 8 * j + c]) =
        make_int2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<int2*>(&st[(r + 8) * P + 8 * j + c]) =
        make_int2(d[4 * j + 2], d[4 * j + 3]);
  }
}

// The epilogue over a staged tile: rows t = c + phases * (j0 + r) of
// sequence n, columns col0 .. col0 + N, in row order, so a warp's loads of
// `add` and stores of the output are contiguous. Where the tile's four-
// column groups divide the consumer threads (Cout 4-256, a power of two),
// each thread keeps one group, its columns' operands in registers, and
// loads the residuals of kBatch rows before it uses any (the loads'
// latency overlaps; one row for N <= 32, whose CTAs an SM the registers
// of a batch would cut); otherwise consecutive threads take consecutive
// groups (one column when Cout % 4 != 0).
template <int N>
__device__ void tile_epilogue(const Args& a, const int* st, int n, int c,
                              int j0, int col0, int tid) {
  constexpr int P = N + 8;
  constexpr int kBatch = N > 32 ? 8 : 1;
  const int cols = min(N, a.cout - col0);
  const long long row0 = static_cast<long long>(n) * a.t_out;
  const int groups = cols >> 2;
  if ((a.cout & 3) == 0 && kConsumers % groups == 0) {
    const int g = tid % groups;
    const int rstep = kConsumers / groups;
    const int col = col0 + 4 * g;
    const Cols4 p = load_cols4(a, col);
    for (int rb = tid / groups; rb < BM; rb += kBatch * rstep) {
      float4 add[kBatch];
      long long idx[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = rb + i * rstep;
        const int t = c + a.phases * (j0 + r);
        ok[i] = r < BM && t < a.t_out;
        idx[i] = (row0 + t) * a.cout + col;
        add[i] = ok[i] ? load_add4(a, idx[i])
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (!ok[i]) continue;
        const int r = rb + i * rstep;
        finish4(a, p, *reinterpret_cast<const int4*>(&st[r * P + 4 * g]),
                add[i], idx[i]);
      }
    }
  } else if ((a.cout & 3) == 0) {
    for (int e = tid; e < BM * groups; e += kConsumers) {
      const int r = e / groups;
      const int g = e - r * groups;
      const int t = c + a.phases * (j0 + r);
      if (t >= a.t_out) continue;
      const int col = col0 + 4 * g;
      const long long idx = (row0 + t) * a.cout + col;
      finish4(a, load_cols4(a, col),
              *reinterpret_cast<const int4*>(&st[r * P + 4 * g]),
              load_add4(a, idx), idx);
    }
  } else {
    for (int e = tid; e < BM * cols; e += kConsumers) {
      const int r = e / cols;
      const int cc = e - r * cols;
      const int t = c + a.phases * (j0 + r);
      if (t >= a.t_out) continue;
      const int col = col0 + cc;
      const long long idx = (row0 + t) * a.cout + col;
      store(a, epilogue(a, st[r * P + cc], idx, col), idx, col);
    }
  }
}

// ------------------------------------------- shared memory, TMA, mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
// A phase that has not completed after ~2^35 cycles (tens of seconds) can
// only be a fault (bytes announced that never arrive): trap, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 35)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Barrier 1 over the consumer threads (the producer warp takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor: start, leading and stride byte offsets
// (16-byte units) and the layout (0 no swizzle, 1 128 B, 2 64 B, 3 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fence and wait.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A[64 x 32] * B[N x 32]^T, s8 x s8 -> s32, both K-major in shared
// memory (the descriptors); scale-d is 1 (the accumulators start at 0).
__device__ __forceinline__ void wgmma_n8(int (&d)[4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 8) wgmma_n8(d, da, db);
  if constexpr (N == 32) wgmma_n32(d, da, db);
  if constexpr (N == 64) wgmma_n64(d, da, db);
  if constexpr (N == 128) wgmma_n128(d, da, db);
  if constexpr (N == 256) wgmma_n256(d, da, db);
}

// Path 1. Warps 0-7 are the consumer warpgroups (rows 0-63 and 64-127 of
// the tile), warp 8 the producer. Shared memory (1024-aligned): `stages` A
// stages [per][BM][cw], then `stages` B stages [per][N][cw] (per = ks / cw
// chunks a stage), then the full and empty mbarriers; the int32 staging
// tile of the epilogue overlaps the ring once every wgmma is done, so the
// ring stays wide (128-byte chunks) and two CTAs fit an SM up to N = 128:
// one CTA's epilogue runs beside the other's loads and wgmma.
template <int N>
__global__ void __launch_bounds__(kWideThreads, N > 128 ? 1 : 2)
    int8_conv_wgmma(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  int* st = reinterpret_cast<int*>(smem_raw + pad);
  const uint32_t sbase = raw + pad;
  const int S = a.stages;
  const uint32_t b_base = sbase + S * a.a_stage;
  const uint32_t full0 = sbase + a.bar_off;
  const uint32_t empty0 = full0 + 8 * S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  int blk = blockIdx.x;
  const int c = blk % a.phases;
  blk /= a.phases;
  const int j0 = (blk % a.tiles) * BM;
  const int n = blk / a.tiles;
  const int col0 = blockIdx.y * N;
  // the phase's taps: m0, m0 + step, ... below kp
  int m0 = 0, step = 1, ntaps = a.kp;
  if (a.phases > 1) {
    m0 = ((a.lo - c) % a.dil + a.dil) % a.dil;
    step = a.dil;
    ntaps = m0 < a.kp ? (a.kp - m0 + a.dil - 1) / a.dil : 0;
  }
  const int cpt = a.cin / a.cw;  // channel blocks a tap
  const int per = a.ks / a.cw;   // chunks a stage: 2 when cw = 16
  const int nchunks = ntaps * cpt;
  const int nsteps = (nchunks + per - 1) / per;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if ((tid & 31) == 0) {
      for (int it = 0; it < nsteps; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(empty0 + 8 * s, ((it / S) - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, a.tx_bytes);
        for (int h = 0; h < per; ++h) {
          // a chunk past the phase's last (cw = 16, an odd count) reads the
          // last real rows against B's zero columns K..K+15
          const int q = it * per + h;
          const int qq = q < nchunks ? q : nchunks - 1;
          const int qi = qq / cpt;
          const int cb = qq - qi * cpt;
          const int m = m0 + step * qi;
          const int row = a.phases > 1 ? j0 + (c + m - a.lo) / a.dil
                                       : j0 * a.stride + m - a.lo;
          const uint32_t adst = sbase + s * a.a_stage + h * BM * a.cw;
          for (int r = 0; r < BM; r += a.rb)
            tma_load_3d(adst + r * a.cw, &xmap, full0 + 8 * s, cb * a.cw,
                        row + r * a.stride, n);
          tma_load_2d(b_base + s * a.b_stage + h * a.b_chunk, &wmap,
                      full0 + 8 * s,
                      q < nchunks ? m * a.cin + cb * a.cw : a.k, col0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const uint32_t layout = a.cw == 128 ? 1 : a.cw == 64 ? 2 : a.cw == 32 ? 3
                                                                        : 0;
  // K-major: swizzled rows of cw bytes, 8-row groups 8*cw apart (LBO
  // unused); without swizzle 8x16-byte core matrices, 8-row groups 128
  // bytes apart and the two 16-byte K halves a chunk region apart
  const uint32_t sbo = layout ? 8 * a.cw : 128;
  const uint32_t lbo_a = layout ? 16 : BM * 16;
  const uint32_t lbo_b = layout ? 16 : a.b_chunk;
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  fence_acc(acc);
  for (int it = 0; it < nsteps; ++it) {
    const int s = it % S;
    mbar_wait(full0 + 8 * s, (it / S) & 1);
    const uint32_t as = sbase + s * a.a_stage + wg * 64 * a.cw;
    const uint32_t bs = b_base + s * a.b_stage;
    wgmma_fence();
    for (int kk = 0; kk < a.ks; kk += 32)
      wgmma<N>(acc, make_desc(as + kk, lbo_a, sbo, layout),
               make_desc(bs + kk, lbo_b, sbo, layout));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * s);
  }
  consumers_sync();  // every wgmma has read its stage: the ring is free
  stage_acc<N>(st, acc, 64 * wg, tid);
  consumers_sync();
  tile_epilogue<N>(a, st, n, c, j0, col0, tid);
}

// Path 2. Shared memory (1024-aligned): A as two 16-byte K halves of BM
// rows (no swizzle), B as two of N rows, then the input span; the staging
// tile overlaps them once the wgmma is done.
template <int N>
__global__ void __launch_bounds__(kConsumers) int8_conv_stem(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  constexpr int kB = 2 * BM * 16;
  constexpr int kWin = kB + 2 * N * 16;
  uint8_t* win = smem + kWin;

  const int tid = threadIdx.x;
  const int j0 = (blockIdx.x % a.tiles) * BM;
  const int n = blockIdx.x / a.tiles;
  const int col0 = blockIdx.y * N;
  const int s = a.stride;

  // 1. the span [w0, w0 + (BM-1)*s + kp) of sequence n, zero outside it,
  // from the 16-byte-aligned chunks that cover it
  const long long seq0 = static_cast<long long>(n) * a.t_in;
  const long long seq1 = seq0 + a.t_in;
  const long long g0 = seq0 + static_cast<long long>(j0) * s - a.lo;
  const long long a0 = g0 - (((g0 % 16) + 16) % 16);
  const int off = static_cast<int>(g0 - a0);
  const int chunks = (off + (BM - 1) * s + a.kp + 15) >> 4;
  for (int i = tid; i < chunks; i += kConsumers) {
    const long long g = a0 + 16LL * i;
    int4 v;
    if (g >= seq0 && g + 16 <= seq1) {
      v = *reinterpret_cast<const int4*>(a.x + g);
    } else {
      uint32_t word[4] = {0, 0, 0, 0};
      for (int b = 0; b < 16; ++b) {
        const long long p = g + b;
        if (p >= seq0 && p < seq1)
          word[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(a.x[p]))
                          << (8 * (b & 3));
      }
      v = make_int4(word[0], word[1], word[2], word[3]);
    }
    *reinterpret_cast<int4*>(win + 16 * i) = v;
  }
  // B: weight rows col0.., K bytes 0..31
  for (int p = tid; p < 2 * N; p += kConsumers) {
    const int o = p >> 1, h = p & 1;
    *reinterpret_cast<int4*>(smem + kB + h * N * 16 + o * 16) =
        *reinterpret_cast<const int4*>(
            a.w + static_cast<long long>(col0 + o) * a.k_pad + 16 * h);
  }
  __syncthreads();
  // 2. the im2col tile: row r, K byte k = x at w0 + r*s + k (k < kp)
  {
    const int r = tid >> 1, h = tid & 1;
    const uint8_t* src = win + off + r * s + 16 * h;
    uint32_t word[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = 16 * h + 4 * q + b;
        if (k < a.kp) v |= static_cast<uint32_t>(src[4 * q + b]) << (8 * b);
      }
      word[q] = v;
    }
    *reinterpret_cast<uint4*>(smem + h * BM * 16 + r * 16) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // 3. one k32 wgmma a warpgroup
  const int wg = tid >> 7;
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  fence_acc(acc);
  wgmma_fence();
  wgmma<N>(acc, make_desc(sbase + wg * 64 * 16, BM * 16, 128, 0),
           make_desc(sbase + kB, N * 16, 128, 0));
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(acc);
  __syncthreads();
  int* st = reinterpret_cast<int*>(smem);
  stage_acc<N>(st, acc, 64 * wg, tid);
  __syncthreads();
  tile_epilogue<N>(a, st, n, 0, j0, col0, tid);
}

// ---------------------------------------------------------- generic path

// Four consecutive K bytes (k a multiple of 4) of one row, zero where the
// tap is out of range. VEC bytes share a tap (Cin % VEC == 0).
template <int VEC>
__device__ __forceinline__ int load_word(const Args& a, long long base,
                                         int u0, int k) {
  if (VEC == 4) {
    const int q = k / a.cin;
    const int i = k - q * a.cin;
    const int u = u0 + q;
    if (k >= a.k || u < 0 || u >= a.span || u % a.dil) return 0;
    return *reinterpret_cast<const int*>(a.x + (base + u / a.dil) * a.cin +
                                         i);
  }
  int word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int kk = k + b;
    const int q = kk / a.cin;
    const int i = kk - q * a.cin;
    const int u = u0 + q;
    int v = 0;
    if (kk < a.k && u >= 0 && u < a.span && u % a.dil == 0)
      v = static_cast<uint8_t>(a.x[(base + u / a.dil) * a.cin + i]);
    word |= v << (8 * b);
  }
  return word;
}

// The row tables of a tile: each row's input base (n * t_in), the dilated
// position of its tap 0 (t * stride - lo), and its output row (n * t_out +
// t, or -1 past the end).
__device__ __forceinline__ void row_tables(const Args& a, long long row0,
                                           int rows, long long* row_base,
                                           int* row_u0, long long* row_out) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const long long row = row0 + r;
    const long long n = row / a.t_out;
    const int t = static_cast<int>(row - n * a.t_out);
    if (row < a.rows) {
      row_base[r] = n * a.t_in;
      row_u0[r] = t * a.stride - a.lo;
      row_out[r] = row;
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
template <int BMT, int BNT, int VEC>
__device__ __forceinline__ void load_step(const Args& a, int k0, int col0,
                                          const long long* row_base,
                                          const int* row_u0, int* xs,
                                          int* wsm) {
  constexpr int XPAD = BMT + 4;  // row strides keep 16-byte alignment and
  constexpr int WPAD = BNT + 4;  // spread a warp's fragment loads over banks
  const int tid = threadIdx.x;
  for (int c = tid; c < BMT * kWords; c += kThreads) {
    const int r = c / kWords;
    const int kw = c % kWords;
    xs[kw * XPAD + r] = load_word<VEC>(a, row_base[r], row_u0[r],
                                       k0 + 4 * kw);
  }
  for (int c = tid; c < BNT * (kTileK / 16); c += kThreads) {
    const int col = c / (kTileK / 16);
    const int kk = (c % (kTileK / 16)) * 16;
    const int4 v = *reinterpret_cast<const int4*>(
        a.w + static_cast<long long>(col0 + col) * a.k_pad + k0 + kk);
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
__global__ void __launch_bounds__(kThreads) int8_conv_dp4a(Args a) {
  constexpr int TY = kThreads / TX;
  constexpr int BMT = TY * TM;
  constexpr int BNT = TX * TN;
  constexpr int XPAD = BMT + 4;
  constexpr int WPAD = BNT + 4;
  __shared__ __align__(16) int xs[kWords * XPAD];
  __shared__ __align__(16) int wsm[kWords * WPAD];
  __shared__ long long row_base[BMT];
  __shared__ long long row_out[BMT];
  __shared__ int row_u0[BMT];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long row0 = static_cast<long long>(blockIdx.x) * BMT;
  const int col0 = blockIdx.y * BNT;
  row_tables(a, row0, BMT, row_base, row_u0, row_out);

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < a.k; k0 += kTileK) {
    __syncthreads();  // the last step's reads done
    load_step<BMT, BNT, VEC>(a, k0, col0, row_base, row_u0, xs, wsm);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      int xa[TM], wb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xa[i] = xs[kw * XPAD + ty * TM + i];
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
// 32 x 32, each warp 2 x 4 mma.sync m16n8k32 tiles a 32-byte K step, the
// fragments read straight from the k-major words.
template <int VEC>
__global__ void __launch_bounds__(kThreads) int8_conv_mma(Args a) {
  constexpr int BMT = 128;
  constexpr int BNT = 64;
  constexpr int XPAD = BMT + 4;
  constexpr int WPAD = BNT + 4;
  __shared__ __align__(16) int xs[kWords * XPAD];
  __shared__ __align__(16) int wsm[kWords * WPAD];
  __shared__ long long row_base[BMT];
  __shared__ long long row_out[BMT];
  __shared__ int row_u0[BMT];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / 2) * 32;  // the warp's rows in the tile
  const int wn = (warp % 2) * 32;  // and its columns
  const long long row0 = static_cast<long long>(blockIdx.x) * BMT;
  const int col0 = blockIdx.y * BNT;
  row_tables(a, row0, BMT, row_base, row_u0, row_out);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < a.k; k0 += kTileK) {
    __syncthreads();
    load_step<BMT, BNT, VEC>(a, k0, col0, row_base, row_u0, xs, wsm);
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

// ------------------------------------------------------------------ host

template <int TM, int TN, int TX>
cudaError_t launch_dp4a(const Args& a, cudaStream_t stream) {
  constexpr int BMT = (kThreads / TX) * TM;
  constexpr int BNT = TX * TN;
  dim3 grid(static_cast<unsigned>((a.rows + BMT - 1) / BMT),
            static_cast<unsigned>((a.cout + BNT - 1) / BNT));
  if (a.cin % 4 == 0)
    int8_conv_dp4a<TM, TN, TX, 4><<<grid, kThreads, 0, stream>>>(a);
  else
    int8_conv_dp4a<TM, TN, TX, 1><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_generic(const Args& a, cudaStream_t stream) {
  if (a.cout == 1) return launch_dp4a<2, 1, 1>(a, stream);
  if (a.cout < 64) return launch_dp4a<4, 1, 16>(a, stream);
  dim3 grid(static_cast<unsigned>((a.rows + 127) / 128),
            static_cast<unsigned>((a.cout + 63) / 64));
  if (a.cin % 4 == 0)
    int8_conv_mma<4><<<grid, kThreads, 0, stream>>>(a);
  else
    int8_conv_mma<1><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no -lcuda); null where libcuda has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled s8 tensor map: dims and byte strides innermost first, a box of
// `box` elements traversed `estride` apart, zeros out of bounds.
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, const cuuint32_t* estride, int cw) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const CUtensorMapSwizzle swizzle =
      cw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : cw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
            const_cast<void*>(base), dims, strides, box, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
cudaError_t launch_wgmma(Args a, int n_rows, int col_blocks,
                         cudaStream_t stream) {
  const int per = a.ks / a.cw;
  a.a_stage = per * BM * a.cw;
  a.b_chunk = (N * a.cw + 1023) / 1024 * 1024;
  a.b_stage = per * a.b_chunk;
  a.tx_bytes = per * (BM + N) * a.cw;  // what the boxes bring, unpadded
  const int ring = a.stages * (a.a_stage + a.b_stage);
  const int staged = BM * (N + 8) * 4;
  a.bar_off = ring > staged ? ring : staged;
  const int smem = 1024 + a.bar_off + 16 * a.stages;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(a.cin),
                               static_cast<cuuint64_t>(a.t_in),
                               static_cast<cuuint64_t>(a.n)};
  const cuuint64_t xstrides[2] = {
      static_cast<cuuint64_t>(a.cin),
      static_cast<cuuint64_t>(a.t_in) * static_cast<cuuint64_t>(a.cin)};
  const cuuint32_t xbox[3] = {static_cast<cuuint32_t>(a.cw),
                              static_cast<cuuint32_t>(a.rb * a.stride), 1};
  const cuuint32_t xstep[3] = {1, static_cast<cuuint32_t>(a.stride), 1};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(a.k_pad),
                               static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(a.k_pad)};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(a.cw), N};
  const cuuint32_t wstep[2] = {1, 1};
  if (!encode(&xmap, a.x, 3, xdims, xstrides, xbox, xstep, a.cw) ||
      !encode(&wmap, a.w, 2, wdims, wstrides, wbox, wstep, a.cw))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_conv_wgmma<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.n * a.tiles * a.phases),
                  static_cast<unsigned>(col_blocks));
  int8_conv_wgmma<N><<<grid, kWideThreads, smem, stream>>>(xmap, wmap, a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_stem(const Args& a, int col_blocks, cudaStream_t stream) {
  const int used = 2 * BM * 16 + 2 * N * 16 + kWindow;
  const int staged = BM * (N + 8) * 4;
  const int smem = 1024 + (used > staged ? used : staged);
  const cudaError_t err = cudaFuncSetAttribute(
      int8_conv_stem<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.n * a.tiles),
                  static_cast<unsigned>(col_blocks));
  int8_conv_stem<N><<<grid, kConsumers, smem, stream>>>(a);
  return cudaGetLastError();
}

template <template <int> class Launch, typename... T>
cudaError_t by_n_tile(int n_tile, T... args) {
  switch (n_tile) {
    case 8: return Launch<8>::run(args...);
    case 32: return Launch<32>::run(args...);
    case 64: return Launch<64>::run(args...);
    case 128: return Launch<128>::run(args...);
    case 256: return Launch<256>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <int N>
struct WgmmaLaunch {
  static cudaError_t run(const Args& a, int n_rows, int col_blocks,
                         cudaStream_t stream) {
    return launch_wgmma<N>(a, n_rows, col_blocks, stream);
  }
};

template <int N>
struct StemLaunch {
  static cudaError_t run(const Args& a, int col_blocks, cudaStream_t stream) {
    return launch_stem<N>(a, col_blocks, stream);
  }
};

}  // namespace

// x [n, t_in, cin] s8 (16-byte aligned), w [n_rows, k_pad] s8 rows, ws /
// bias / add_scale / inv [cout] f32 (bias, add, add_scale and inv may be
// null as the modes say), add and out [n, t_out, cout] (16-byte aligned).
// `path` 0 generic, 1 wgmma, 2 stem, and the tiling, as ops/int8_conv.py::
// plan gives them. Returns the cudaError_t of the launch.
extern "C" int int8_conv(const int8_t* x, const int8_t* w, const float* ws,
                         const float* bias, const void* add,
                         const float* add_scale, const float* inv, void* out,
                         int path, int n, int t_in, int cin, int t_out,
                         int cout, int kp, int k_pad, int n_rows, int stride,
                         int dil, int lo, int phases, int tiles,
                         int n_tile, int col_blocks, int cw, int rb,
                         int stages, int add_mode, int act, int out_mode,
                         cudaStream_t stream) {
  Args a = {};
  a.x = x;
  a.w = w;
  a.ws = ws;
  a.bias = bias;
  a.add = add;
  a.add_scale = add_scale;
  a.inv = inv;
  a.out = out;
  a.n = n;
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
  a.phases = phases;
  a.tiles = tiles;
  a.cw = cw;
  a.rb = rb;
  a.stages = stages;
  a.ks = cw > 32 ? cw : 32;
  a.add_mode = add_mode;
  a.act = act;
  a.out_mode = out_mode;
  a.rows = static_cast<long long>(n) * t_out;
  if (a.rows == 0 || cout == 0) return 0;
  if (static_cast<long long>(n) * tiles * phases > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err;
  if (path == 1)
    err = by_n_tile<WgmmaLaunch>(n_tile, a, n_rows, col_blocks, stream);
  else if (path == 2)
    err = by_n_tile<StemLaunch>(n_tile, a, col_blocks, stream);
  else
    err = launch_generic(a, stream);
  return static_cast<int>(err);
}
