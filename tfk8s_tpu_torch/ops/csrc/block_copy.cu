// Copy of a float32 [rows, cols] tensor by the TMA's bulk copies, for
// Hopper (sm_90a), behind a plain C interface loaded with ctypes
// (tfk8s_tpu_torch/ops/_build.py builds this file with nvcc).
//
// Replaces the Pallas TPU kernel of tools/roofline.py:124 pallas_copy_gbps
// (pallas_call :141): a copy staged device memory -> fast memory -> device
// memory by the DMA engines, the bandwidth a hand-written kernel sees, as
// opposed to what the library's own copy reaches.
//
// What bounds it: bytes. Each value is read once and written once
// (8 bytes a value); [8192, 8192] moves 512 MiB, 0.160 ms at 3.35 TB/s.
// Design: Hopper's counterpart of that DMA is the TMA's bulk copy. The
// tensor's bytes are cut into chunks of kChunk bytes, which the blocks take
// in turns (chunk c to block c mod grid), so that the whole grid streams
// through one region of memory at a time. A block moves its chunks through
// a ring of kStages shared-memory stages: one thread issues
// cp.async.bulk global -> shared into a stage (completion counted in bytes
// on the stage's mbarrier), waits for it, then issues cp.async.bulk
// shared -> global from the stage as one bulk group, and refills the stage
// once that store has read it out (cp.async.bulk.wait_group.read). No
// register carries the data, and kStages - 1 loads stay in flight a block.
// Every read and write of the staged bytes is by the async proxy (bulk in,
// bulk out), so no fence.proxy.async is needed between them. The grid is
// kBlocksPerSm blocks on each SM; both streams are marked evict-first in
// L2. (Chunk, stages, blocks and hints were picked on the card with
// tfk8s_tpu_torch/tools/kernel_variants.py.) Bulk copies move multiples
// of 16 bytes from 16-byte aligned addresses (the wrapper checks the
// bases); the last rows * cols * 4 % 16 bytes are copied by plain threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16384;  // bytes a stage
constexpr int kStages = 4;
constexpr int kBlocksPerSm = 2;
constexpr int kThreads = 32;   // one issues every copy; all copy the tail

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// An L2 policy that marks lines evict-first: nothing copied is read again.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// global -> shared, `bytes` counted on bar on arrival
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// shared -> global, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes,
                                           uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;" ::
                   "l"(reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes), "l"(policy)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    tfk8s_block_copy_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
                            long long bulk, long long total) {
  extern __shared__ __align__(128) uint8_t stage[];  // kStages * kChunk bytes
  __shared__ uint64_t full[kStages];

  if (blockIdx.x == gridDim.x - 1) {  // the tail past the last 16-byte boundary
    const float* xf = reinterpret_cast<const float*>(x);
    float* yf = reinterpret_cast<float*>(y);
    for (long long e = bulk / 4 + threadIdx.x; e < total / 4; e += kThreads) yf[e] = xf[e];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  // this block's chunks: the i-th is at byte offset_of(i), n of them
  const long long chunks = (bulk + kChunk - 1) / kChunk;
  const int n = (int)((chunks - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto offset_of = [&](int i) { return (blockIdx.x + (long long)i * gridDim.x) * kChunk; };
  auto bytes_of = [&](int i) {
    const long long start = offset_of(i);
    return (uint32_t)(bulk - start < kChunk ? bulk - start : kChunk);
  };
  const uint64_t policy = evict_first();
  for (int i = 0; i < n && i < kStages; ++i)
    bulk_load(stage + i * kChunk, x + offset_of(i), bytes_of(i), &full[i], policy);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    bulk_store(y + offset_of(i), stage + s * kChunk, bytes_of(i), policy);
    // refill the stage of chunk i - 1 once its store has read it: of the
    // stores issued, at most this chunk's may still be reading
    const int j = i - 1 + kStages;
    if (i >= 1 && j < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      const int r = (i - 1) % kStages;
      bulk_load(stage + r * kChunk, x + offset_of(j), bytes_of(j), &full[r], policy);
    }
  }
  // every store has written its bytes before the block (and its stages) ends
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

extern "C" {

// Copies x to y on `stream`; returns the cudaError_t of the launch.
int tfk8s_block_copy(const void* x, void* y, long long rows, long long cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long total = rows * cols * 4, bulk = total / 16 * 16;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int smem = kStages * kChunk;
  err = cudaFuncSetAttribute(tfk8s_block_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (bulk + kChunk - 1) / kChunk;
  long long blocks = (long long)sms * kBlocksPerSm;
  if (chunks < blocks) blocks = chunks > 0 ? chunks : 1;
  tfk8s_block_copy_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)y, bulk, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
