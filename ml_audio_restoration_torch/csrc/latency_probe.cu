// Latency probe: cycles of the building blocks of a recurrence step, each a
// dependent chain of n links timed with clock64 in a block of 128 threads
// (the recurrence kernels' block at H = 64): an FFMA, an FADD, one gate
// activation (gate_act), a shuffle plus an FADD, one shared-memory round
// trip through the step's barrier (STS, __syncthreads, LDS of another
// thread's value, FADD), and a DADD (the IIR scan's double-precision
// chain). ops/_latency.py counts each kernel's latency floor from them. A
// measurement tool: no model path launches it.
#include "lstm_common.cuh"

#define CHAIN(slot, body)                                   \
  x = x + 0.0f * static_cast<float>(clock64() & 1);         \
  t0 = clock64();                                           \
  for (int i = 0; i < n; ++i) { body; }                     \
  asm volatile("" ::"f"(x));                                \
  t1 = clock64();                                           \
  if (tid == 0) out[slot] = t1 - t0;

__global__ void latency_kernel(long long* out, float* sink, int n) {
  __shared__ float s[2][128];
  const int tid = threadIdx.x;
  float x = 0.5f + tid * 1e-6f;
  long long t0, t1;
  s[0][tid] = x;
  __syncthreads();
  CHAIN(0, x = fmaf(x, 0.9999f, 1e-4f))
  CHAIN(1, x = x + 1e-7f)
  CHAIN(2, x = gate_act(x, 1.0f))
  CHAIN(3, x = __shfl_xor_sync(FULL_MASK, x, 1) + 1e-7f)
  CHAIN(4, s[i & 1][tid] = x; __syncthreads();
           x = s[i & 1][(tid + 1) & 127] + 1e-7f)
  double d = x + 0.0 * static_cast<double>(clock64() & 1);
  t0 = clock64();
  for (int i = 0; i < n; ++i) d = d + 1e-12;
  asm volatile("" ::"d"(d));
  t1 = clock64();
  if (tid == 0) out[5] = t1 - t0;
  sink[tid] = x + static_cast<float>(d);
}

extern "C" int latency(long long* out, float* sink, int n, void* stream) {
  latency_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, sink,
                                                                    n);
  return static_cast<int>(cudaGetLastError());
}
