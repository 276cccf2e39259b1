// Row-block copy of a float32 [rows, cols] tensor for Hopper (sm_90a),
// behind a plain C interface loaded with ctypes (tfk8s_tpu_torch/ops/_build.py
// builds this file with nvcc).
//
// Replaces the Pallas TPU kernel of tools/roofline.py:124 pallas_copy_gbps
// (pallas_call :141): the device-memory bandwidth a hand-written kernel
// sees, as opposed to what the library's own copy reaches.
//
// What bounds it: bytes. Each value is read once and written once
// (8 bytes a value); [8192, 8192] moves 512 MiB, 0.160 ms at 3.35 TB/s.
// Design: block i copies rows [i * block_rows, (i + 1) * block_rows) as one
// flat range. Each thread moves 16 bytes at a time (float4), neighbouring
// threads on neighbouring addresses, and issues UNROLL loads before their
// stores so that enough bytes are in flight to cover the memory latency.
// The range's ragged head and tail (when cols is not a multiple of 4) are
// copied one value at a time. The wrapper checks that both pointers are
// 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    tfk8s_block_copy_kernel(const float* __restrict__ x, float* __restrict__ y, long long rows,
                            long long cols, int block_rows) {
  const long long r0 = (long long)blockIdx.x * block_rows;
  const long long r1 = r0 + block_rows < rows ? r0 + block_rows : rows;
  const long long e0 = r0 * cols, e1 = r1 * cols;
  const long long a0 = (e0 + 3) & ~3LL;  // first float4-aligned value
  const long long a1 = e1 & ~3LL;        // end of the last whole float4
  const int tid = threadIdx.x;
  if (a0 >= a1) {  // no whole float4 in the range
    for (long long e = e0 + tid; e < e1; e += kThreads) y[e] = x[e];
    return;
  }
  for (long long e = e0 + tid; e < a0; e += kThreads) y[e] = x[e];
  for (long long e = a1 + tid; e < e1; e += kThreads) y[e] = x[e];

  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x) + a0 / 4;
  float4* __restrict__ y4 = reinterpret_cast<float4*>(y) + a0 / 4;
  const long long n4 = (a1 - a0) / 4;
  for (long long i = tid; i < n4; i += kUnroll * kThreads) {
    float4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + (long long)k * kThreads;
      if (j < n4) v[k] = x4[j];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + (long long)k * kThreads;
      if (j < n4) y4[j] = v[k];
    }
  }
}

}  // namespace

extern "C" {

// Copies x to y on `stream`; returns the cudaError_t of the launch.
int tfk8s_block_copy(const void* x, void* y, long long rows, long long cols, int block_rows,
                     void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (block_rows <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + block_rows - 1) / block_rows;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  tfk8s_block_copy_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, rows, cols, block_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
