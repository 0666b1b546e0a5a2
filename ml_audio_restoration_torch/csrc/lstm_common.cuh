// Device helpers shared by the LSTM recurrence kernels (lstm_recurrence.cu,
// lstm_train.cu): type conversions, the gate activations, the reduction of
// a unit's gate partials across its lanes and asynchronous copies into
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

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

// k * sigmoid(k * x) + (1 - k): sigmoid(x) for k = 1, tanh(x) for k = 2, so
// the lanes of one warp activate sigmoid and tanh gates without diverging.
// exp and the reciprocal run on the special-function unit (__expf,
// __fdividef): a few 1e-7 from the correctly rounded value, where expf and
// a full division cost several times the instructions on the step's
// critical path. (tanh.approx.f32 would be one instruction but is ~5e-4
// off.) It saturates without a NaN: for k * x < -88 the exp overflows to
// inf and 1 / inf is 0; for k * x > 88 it flushes to 0 and gives 1.
__device__ __forceinline__ float gate_act(float x, float k) {
  return fmaf(k, __fdividef(1.0f, 1.0f + __expf(-k * x)), 1.0f - k);
}

__device__ __forceinline__ float fast_tanh(float x) {
  return gate_act(x, 2.0f);
}

// Sums each of the four gates' partials over the L lanes of a group and
// leaves gate (4 / L) * r + q's total in a[q]. Each round halves the gates a
// lane keeps: it sends its partner the half the partner keeps and adds what
// it receives, so every total is summed in one lane, in a fixed order.
template <int L>
__device__ __forceinline__ void reduce_gates(float (&v)[4], int r,
                                             float (&a)[4 / L]) {
  int n = 4;
#pragma unroll
  for (int s = L / 2; s >= 1; s /= 2) {
    n /= 2;
    const bool up = r & s;
#pragma unroll
    for (int q = 0; q < n; ++q) {
      const float keep = up ? v[n + q] : v[q];
      const float send = up ? v[q] : v[n + q];
      v[q] = keep + __shfl_xor_sync(FULL_MASK, send, s);
    }
  }
#pragma unroll
  for (int q = 0; q < 4 / L; ++q) a[q] = v[q];
}

// 16 bytes global -> shared, asynchronous (cp.async); zero-filled when
// !valid. The recurrences stream their per-step rows this way: a
// __syncthreads waits for the warp's outstanding global loads, so a load
// into registers, however far ahead, costs a step a memory latency (about
// 250 ns on an H100, PERF.md), while these copies are tracked by commit
// groups that only cp_async_wait waits for.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid = true) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's latest commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
