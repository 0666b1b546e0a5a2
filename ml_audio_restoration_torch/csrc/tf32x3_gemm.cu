// The float32 linear layers of BS-RoFormer's transformers (ops/gemm.py),
// for Hopper (sm_90a): y = act(x w^T + bias) (+ residual), x [M, K] and w
// [N, K] row-major f32, every product held to float32 accuracy on the
// tensor cores as three TF32 products.
//
// Replaces no TPU kernel: the JAX package has no BS-RoFormer. Without it
// these products are cuBLAS's FFMA SGEMM (TF32 stays off: the reference
// models' output is float32's), followed by ATen's GELU and residual adds.
//
// What bounds it on an H100. The layers are large products (M = 1.0-1.8 M
// tokens a call, K 512 or 2,048, N 512-2,048): operations, not bytes. On
// FFMA the card's ceiling is 67 TFLOP/s. The tensor cores reach float32
// accuracy as three TF32 products a multiply-add,
//   x w = x_hi w_hi + x_hi w_lo + x_lo w_hi (+ x_lo w_lo, dropped),
// x_hi = rna_tf32(x), x_lo = rna_tf32(x - x_hi) (each part 11 significant
// bits, so the parts keep ~22 of float32's 24; the dropped term is ~2^-22
// of the product), so the ceiling is the TF32 peak over three, 494.5 / 3 =
// 164.8 TFLOP/s counted as float32 operations. The bytes (x read once, y
// written once: 0.03-0.1 of the time at 3.35 TB/s) do not bind.
//
// Design:
// - w's parts are made once per weight (ops/gemm.py keeps them beside the
//   module); x is split in registers here, never written out.
// - Tiles of BM = 128 rows x BN = 128 columns, K in blocks of 32 (128
//   bytes of f32, the TMA 128-byte swizzle). One producer thread keeps a
//   ring of kStages stages (x, w_hi and w_lo tiles, 48 KB) in flight by
//   TMA, each announced to its full mbarrier by the bytes it brings; rows
//   past M and columns past N are TMA's zero fill. Two consumer
//   warpgroups of 64 rows each load their x fragments from shared memory
//   (the wgmma m64k8 tf32 register layout: rows g, g + 8, columns t, t +
//   4 of each k8 step; the swizzle puts a warp's 32 reads on 32 banks),
//   split them, and issue wgmma m64n128k8 with x's parts in registers and
//   w's parts in shared memory: the two small products of the block's four
//   k8 steps first, then the four large ones. The producer warpgroup
//   gives its registers to the consumers (setmaxnreg). The split is two
//   integer operations a part, not cvt.rna.tf32.f32, which issues at a
//   quarter of their rate (the cvt form was ~10% slower on an H100).
// - Accumulation. The tensor cores add into their float32 accumulator with
//   truncation, not rounding; over K = 2,048 that bias outgrows FFMA's
//   rounding error (a whole-K accumulator read 4-6x cuBLAS's error against
//   float64 on the card). So each group of kPromote K blocks accumulates
//   from zero in one register tile, which is then added (rounded, FADD)
//   into a second register tile that carries the sum; the small products,
//   ~2^-11 of the large, go first so the truncation sees them at their own
//   scale. The error against float64 as a multiple of cuBLAS's FFMA
//   SGEMM's, on an H100 at the model's four shapes: a group of 1 K block
//   0.17-0.26x, 2 blocks 0.21-0.47x, 4 blocks 0.38-0.95x, 8 blocks
//   0.80-1.98x, the whole K 3.8-6.1x; kPromote is 2.
// - A persistent grid (one CTA an SM, 209 KB of shared memory) walks the
//   output tiles column-fastest, so the CTAs in flight share x's row
//   blocks and w in L2; the ring runs on across tiles, so the producer
//   loads the next tile while the consumers run this one's epilogue.
// - The epilogue: bias, GELU (exact erf, as nn.GELU()) and the residual
//   on the registers, the tile written to a staging tile in shared memory
//   and stored by TMA, asynchronously: the output's bytes (up to 14.6 GB
//   a call) go out while the next tile computes. Stored from the
//   registers, the epilogue took 12-39% of the kernel's time on an H100.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;              // rows a tile (two warpgroups of 64)
constexpr int BN = 128;              // columns a tile
constexpr int BK = 32;               // K a stage: 128 bytes of f32
constexpr int kStages = 3;
constexpr int kPromote = 2;          // K blocks a partial sum (Accumulation)
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40;    // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;   //   <= the SM's 65,536
constexpr int kTile = BM * BK * 4;   // bytes of one operand tile (BM == BN)
constexpr int kStageBytes = 3 * kTile;  // x, w_hi, w_lo
constexpr int kStaging = BM * BN * 4;  // the output tile, 64 KB
constexpr int kBarOff = kStages * kStageBytes + kStaging;
constexpr int kSmem = 1024 + kBarOff + 16 * kStages;

struct Args {
  const float* bias;      // [n] or null
  const float* residual;  // [m, n] or null
  int m, n, k_blocks, col_blocks, tiles;
  int act;  // 0 none, 1 GELU (erf)
};

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
// A phase that has not completed after ~2^35 cycles can only be a fault:
// trap, so the launch fails instead of hanging the card.
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared memory to the global tile at (c0, c1) of the map; clipped to the
// tensor's bounds. One bulk group per call site's commit.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, "
      "%2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Barrier 1 over the consumer threads (the producer takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ------------------------------------------------------------------ wgmma

// K-major operand in shared memory, 128-byte swizzle: rows of 128 bytes,
// 8-row groups 1,024 bytes apart (SBO); LBO unused.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups of the warpgroup are
// still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fence and wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for the A fragments, which the wgmma reads until the wait.
__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[j][e])::"memory");
}

// d (+)= A[64 x 8] * B[128 x 8]^T, tf32 x tf32 -> f32: A in registers (the
// m64k8 fragment), B K-major in shared memory; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// f32 bits rounded to TF32's 10 fraction bits, to nearest with ties away
// from zero: cvt.rna.tf32.f32's value, in two integer operations (the
// conversion issues at a quarter of their rate).
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + (what TF32 cannot hold of the remainder): hi rounded to
// TF32, lo the exact remainder rounded again.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(x));
  lo = rna_tf32(__float_as_uint(__fsub_rn(x, __uint_as_float(hi))));
}

// nn.GELU(): x * 0.5 * (1 + erf(x / sqrt(2))), ATen's expression.
__device__ __forceinline__ float gelu(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752440f));
}

// The epilogue of one warpgroup's 64 x 128 tile: thread (warp w, lane l)
// holds rows 16w + l/4 and + 8, columns 8j + 2(l%4) and + 1 (d[4j..4j+3]).
// Bias, GELU and residual in registers (each half of the columns loads
// its bias and residual pairs before it computes), the results into the
// staging tile: four column blocks of [128 rows][32] f32 in the TMA
// 128-byte swizzle, which the output's tensor map stores.
__device__ __forceinline__ void stage_tile(const Args& a, const float (&d)[64],
                                           uint8_t* staging, int r, int row0,
                                           int col0, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float2 b[8], res[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = col0 + 8 * (8 * half + jj) + 2 * t;
      const bool in = col < a.n;  // n % 4 == 0: col + 1 < n too
      b[jj] = in && a.bias != nullptr
                  ? *reinterpret_cast<const float2*>(a.bias + col)
                  : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r + 8 * h;
        res[jj][h] =
            in && a.residual != nullptr && row < a.m
                ? *reinterpret_cast<const float2*>(
                      a.residual + static_cast<long long>(row) * a.n + col)
                : make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * half + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = d[4 * j + 2 * h] + b[jj].x;
        float y1 = d[4 * j + 2 * h + 1] + b[jj].y;
        if (a.act == 1) {
          y0 = gelu(y0);
          y1 = gelu(y1);
        }
        // column 8j + 2t: block j / 4, 16-byte chunk 2(j % 4) + t / 2
        const int row = r + 8 * h;
        const int chunk = 2 * (j & 3) + (t >> 1);
        *reinterpret_cast<float2*>(staging + (j >> 2) * (BM * 128) +
                                   row * 128 + ((chunk ^ g) << 4) +
                                   8 * (t & 1)) =
            make_float2(y0 + res[jj][h].x, y1 + res[jj][h].y);
      }
    }
  }
}

// The consumer side of a CTA: the ring's stages in order, each stage's x
// fragments loaded and split, its 12 wgmma issued into `part` and
// retired, the stage released; at the end of a group of kPromote blocks
// `part` is added into `total`.
struct Consumer {
  const Args& a;
  const CUtensorMap* omap;
  uint8_t* smem;
  uint32_t sbase, full0, empty0;
  int r, g, t, lane, tid;
  int it = 0;  // stages consumed (over every tile)
  float total[64], part[64];
  uint32_t hi[4][4], lo[4][4];

  __device__ __forceinline__ void stage(int kb) {
    const int s = it % kStages;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const uint8_t* xs = smem + s * kStageBytes;
    // element (row, k) of the swizzled x tile: 16-byte chunk k/4 of the
    // row's 128 bytes at chunk (k/4) ^ (row % 8)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + 8 * (e & 1);
        const int chunk = 2 * j + (e >> 1);
        const float v = *reinterpret_cast<const float*>(
            xs + row * 128 + ((chunk ^ g) << 4) + 4 * t);
        split_tf32(v, hi[j][e], lo[j][e]);
      }
    const uint32_t whi = sbase + s * kStageBytes + kTile;
    const uint32_t wlo = whi + kTile;
    const int fresh = kb % kPromote == 0;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_n128(part, lo[j], desc_sw128(whi + 32 * j),
                 j == 0 && fresh ? 0 : 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_n128(part, hi[j], desc_sw128(wlo + 32 * j), 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_n128(part, hi[j], desc_sw128(whi + 32 * j), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
    fence_frags(hi);
    fence_frags(lo);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (kb % kPromote == kPromote - 1 || kb == a.k_blocks - 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += part[i];
    }
    ++it;
  }

  __device__ __forceinline__ void tile(int row0, int col0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.0f;
    for (int kb = 0; kb < a.k_blocks; ++kb) stage(kb);
    // the staging tile is free once the last tile's stores have read it
    // (a whole mainloop ago)
    uint8_t* staging = smem + kStages * kStageBytes;
    if (tid == 0) bulk_wait_read();
    consumers_sync();
    stage_tile(a, total, staging, r, row0, col0, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
    if (tid == 0) {
      for (int q = 0; q < BN / 32 && col0 + 32 * q < a.n; ++q)
        tma_store_2d(omap, sbase + kStages * kStageBytes + q * BM * 128,
                     col0 + 32 * q, row0);
      bulk_commit();
    }
  }
};

// Warpgroups 0 and 1 are the consumers (rows 0-63 and 64-127 of a tile),
// warpgroup 2 the producer, whose first thread issues the TMA loads; it
// gives its registers up to the consumers (setmaxnreg). Shared memory
// (1024-aligned): kStages stages of [x 128 x 32 | w_hi 128 x 32 | w_lo 128
// x 32] f32, the output's staging tile, then the full and the empty
// mbarriers. The output's stores (TMA, asynchronous) run on while the
// consumers start the next tile.
__global__ void __launch_bounds__(kThreads, 1)
    tf32x3_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap himap,
                       const __grid_constant__ CUtensorMap lomap,
                       const __grid_constant__ CUtensorMap omap,
                       const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t sbase = raw + pad;
  const uint32_t full0 = sbase + kBarOff;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const int row0 = (tile / a.col_blocks) * BM;
        const int col0 = (tile % a.col_blocks) * BN;
        for (int kb = 0; kb < a.k_blocks; ++kb, ++it) {
          const int s = it % kStages;
          if (it >= kStages)
            mbar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);
          const uint32_t full = full0 + 8 * s;
          const uint32_t dst = sbase + s * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(dst, &xmap, full, kb * BK, row0);
          tma_load_2d(dst + kTile, &himap, full, kb * BK, col0);
          tma_load_2d(dst + 2 * kTile, &lomap, full, kb * BK, col0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = tid & 31;
    Consumer c{a, &omap, smem_raw + pad, sbase, full0, empty0,
               // this thread's fragment rows in the tile: r and r + 8
               // (both = g mod 8, the swizzle's row phase)
               64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2), lane >> 2,
               lane & 3, lane, tid};
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x)
      c.tile((tile / a.col_blocks) * BM, (tile % a.col_blocks) * BN);
    if (tid == 0) bulk_wait();  // the last stores done before the CTA ends
  }
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

// A row-major f32 matrix [rows, k] as tiles of 128 rows x 32 columns,
// 128-byte swizzle, zeros out of bounds (loads) or clipped (stores).
bool encode(CUtensorMap* map, const float* base, int rows, int k) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 4};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// y [m, n] = act(x [m, k] w^T + bias) (+ residual), w = w_hi + w_lo (its
// TF32 parts, [n, k] each), all f32 row-major, x, w_hi, w_lo and y starting
// on 16 bytes and k and n multiples of 4 (TMA's strides), bias and
// residual on 8 bytes. bias [n] and residual [m, n] may be null; act 0
// none, 1 GELU. Returns the cudaError_t of the launch.
extern "C" int tf32x3_gemm(const float* x, const float* w_hi,
                           const float* w_lo, const float* bias,
                           const float* residual, float* out, int m, int n,
                           int k, int act, cudaStream_t stream) {
  if (m == 0 || n == 0) return 0;
  if (k <= 0 || k % 4 != 0 || n % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.bias = bias;
  a.residual = residual;
  a.m = m;
  a.n = n;
  a.k_blocks = (k + BK - 1) / BK;
  a.col_blocks = (n + BN - 1) / BN;
  const long long tiles =
      static_cast<long long>((m + BM - 1) / BM) * a.col_blocks;
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  a.act = act;
  CUtensorMap xmap, himap, lomap, omap;
  if (!encode(&xmap, x, m, k) || !encode(&himap, w_hi, n, k) ||
      !encode(&lomap, w_lo, n, k) || !encode(&omap, out, m, n))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tf32x3_gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.tiles < sms ? a.tiles : sms;
  tf32x3_gemm_kernel<<<grid, kThreads, kSmem, stream>>>(xmap, himap, lomap,
                                                        omap, a);
  return static_cast<int>(cudaGetLastError());
}
