// Flash attention on Hopper's tensor cores (sm_90a): every bfloat16 kernel
// (the forward, dq, dk/dv, and the pre-pass that gives both backward
// kernels their per-row D = rowsum(dO * O) and lse * log2e). A plain C
// interface, loaded with ctypes (tfk8s_tpu_torch/ops/_build.py builds this
// file with nvcc). Nothing is linked beyond the CUDA runtime:
// cuTensorMapEncodeTiled is fetched from the CUDA driver library through
// cudaGetDriverEntryPoint.
//
// Replaces, for bfloat16 inputs, the Pallas TPU kernels of
// tfk8s_tpu/ops/flash_attention.py:
//   tfk8s_fwd_wgmma_kernel <- _fwd_kernel     (:149, launched by _flash_fwd_impl :424)
//   tfk8s_dq_wgmma_kernel  <- _bwd_dq_kernel  (:233, launched by _flash_bwd_impl :451)
//   tfk8s_dkv_wgmma_kernel <- _bwd_dkv_kernel (:290, launched by _flash_bwd_impl :469)
//   tfk8s_dsum_kernel      <- those kernels' D = rowsum(dO * O) (:247, :317)
// The backward runs the pre-pass once and feeds it to dq and dk/dv.
// float32 inputs take the CUDA-core kernels of flash_attention.cu.
//
// Contract: that of flash_attention.cu (contiguous [b, l, h, d], q
// pre-scaled, [b, lk] uint8 key mask, bottom-right causal with lq <= lk,
// fully masked rows give zero output and zero gradients, lse [b, h, lq]
// float32, any length, d in 16, 32, 64, 128), and every tensor's base is
// 16-byte aligned, as TMA needs.
//
// What bounds them. At GPT-2-small's shape (b=8, l=1024, h=12, d=64,
// causal) the forward does 12.9 GFLOP (13 us at 989 TFLOP/s) on ~50 MB
// (15 us at 3.35 TB/s), dq 19.4 GFLOP on ~64 MB, dk/dv 25.8 GFLOP on ~76
// MB: all sit near the ridge, so the work is to keep the tensor cores
// fed. Every product is a
// wgmma (m64nNk16, bf16 in, f32 accumulate), and every tile reaches shared
// memory by TMA, in the swizzled layout the wgmma descriptors read,
// through a ring of stages that one producer warp keeps ahead of the
// consumer warpgroup (mbarrier completion, no __syncthreads in the loop).
// What is left between them and the bound: the softmax. A warpgroup
// waits for its S before its exp2 pass and for P V before the next S, so
// its tensor-core work and its softmax take turns. Independent blocks on
// an SM fill in for each other instead: a block is ONE consumer
// warpgroup, since the warpgroups of one block would step through the
// ring together and reach their softmax at the same time, and the
// forward is held to 102 registers at d <= 64 so that four blocks share
// an SM. (Issuing the next tile's S before this tile's softmax, as
// FlashAttention-3 does, costs 32 registers and so blocks an SM: slower.)
//
// Forward: a block owns 64 query rows. Q is loaded once; K and V tiles of
// 64 keys stream through the ring. S = Q K^T reads both operands from
// shared memory; the online softmax runs in registers on log2e-scaled
// scores with exp2; P is rounded to bf16 in the accumulator's own layout,
// which is the register A fragment of P V. Masks are evaluated only on tiles that hold the causal
// diagonal, the ragged key edge or a key mask; tiles above the diagonal are
// never loaded; the q tiles with the most keys launch first.
//
// dk/dv, in FlashAttention-3's transposed form: a block owns 64 keys and
// keeps K and V resident; Q, dO, D and the log2e-scaled lse stream
// through the ring in tiles of 64 query rows (32 at d=128, so that dK and
// dV stay in registers). S^T = K Q^T and dP^T = V dO^T read shared
// memory; P^T and dS^T = P^T (dP^T - D) are rounded to bf16 in registers
// and are the A fragments of dV += P^T dO and dK += dS^T Q. dK and dV
// accumulate in f32 registers and are stored once; nothing is reduced
// across blocks and no atomics are used, so results repeat bit for bit.
//
// dq is the forward's loop with one more product: a block owns 64 query
// rows with Q and dO resident, K and V tiles of 64 keys stream through
// the ring, S = Q K^T and dP = dO V^T read shared memory, and
// dS = P (dP - D) is split in registers into two bf16 A fragments, hi +
// lo, for dQ += dS K, which reads K MN-major as the forward's P V reads V.
// (dS rounded once to bf16, as dk/dv rounds it, puts dq a bf16 step of dq
// off its float32 value: dk multiplies dS by the pre-scaled Q, dq by the
// unscaled K. The split costs a fourth product a tile.) P comes from the
// pre-pass's lse * log2e with no running max; the row's D and lse2 are
// read once into registers. dQ stays in f32 registers and is stored once,
// so dq repeats bit for bit too. Two blocks share an SM (registers held to
// 204).
//
// Numerics: the first products take the bf16 inputs exactly and accumulate
// in f32; P and dS are rounded to bf16 before the second products, as every
// FlashAttention does (the port's plain model attention also rounds its
// probabilities to the input type before P V), except dq's dS (above).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;  // the lse of a fully masked row (_NEG of the reference)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// -- shared-memory tiles -------------------------------------------------------
// A tile of rows of d bf16 lives in shared memory as ATOMS swizzle atoms:
// 128-byte swizzle at d = 64 and 128 (two atoms at 128), 64-byte at d = 32,
// 32-byte at d = 16. Atom a holds columns [a * COLS, (a + 1) * COLS) of
// every row, rows SW bytes apart, so one TMA box [1, rows, 1, COLS] of a
// [b, l, h, d] tensor fills it. Atoms start on 1024-byte boundaries: the
// swizzle is a function of the absolute address, for TMA and wgmma alike.
template <int D>
struct Tile {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head_dim must be 16, 32, 64 or 128");
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // bytes of a row in an atom
  static constexpr int COLS = SW / 2;
  static constexpr int ATOMS = D / COLS;
  // the wgmma descriptor's layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int bytes(int rows) { return rows * D * 2; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// A wgmma shared-memory matrix descriptor; offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFFu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFFu) << 32 | layout << 62;
}

// A K-major operand: the tile's rows are the M (or N) index and its
// columns the reduction index. k-step kk takes columns [16 kk, 16 kk + 16):
// inside an atom it moves the start address by 32 bytes; groups of 8 rows
// are 8 * SW bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  using T = Tile<D>;
  const int byte = kk * 32;
  return make_desc(tile + (byte / T::SW) * rows * T::SW + byte % T::SW, 16, 8 * T::SW, T::LAYOUT);
}

// An MN-major operand: the tile's rows are the reduction index and its
// columns the N index. k-step kk takes rows [16 kk, 16 kk + 16); groups of
// 8 rows are 8 * SW bytes apart (SBO) and atoms rows * SW bytes (LBO).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using T = Tile<D>;
  return make_desc(tile + kk * 16 * T::SW, rows * T::SW, 8 * T::SW, T::LAYOUT);
}

// -- mbarrier, TMA ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of the given parity has completed.
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

// One box of a 4-D [b, l, h, d] map (coordinates innermost first) into
// shared memory; completion is counted on bar in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A contiguous run of bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- wgmma -------------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products that write them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, f32 accumulate. ss: A and B
// from shared-memory descriptors; rs: A from registers. TB = 1 reads B
// MN-major (transposed). scale_d = 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int TB>
  __device__ static __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  __device__ static __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  template <int TB>
  __device__ static __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  __device__ static __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TB>
  __device__ static __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  __device__ static __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TB>
  __device__ static __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  __device__ static __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

// An m64nN accumulator as one thread holds it: element i sits at row
// 16 * warp + lane / 4 + 8 * acc_half(i) and column acc_col(i) of the tile.
__device__ __forceinline__ int acc_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of an m64nN product, rounded to bf16, is the register A
// operand of a product that reduces over those N columns: k-step kk takes
// columns [16 kk, 16 kk + 16), four registers of bf16 pairs.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
  }
}

// The same A operand as two bf16 terms, hi + lo, which carry 16 bits of
// each value's mantissa: dq's dS = P (dP - D) reaches |dS| ~ 10 (dP = dO V^T
// is not scaled, unlike the pre-scaled Q that multiplies dS in dk), where
// one bf16 rounding of dS moves dq by more than a bf16 step of dq.
template <int N>
__device__ __forceinline__ void to_a_frags_split(const float (&acc)[N / 2], uint32_t (&hi)[N / 16][4],
                                                 uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = acc[8 * kk + 2 * j], x1 = acc[8 * kk + 2 * j + 1];
      __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][j] = *reinterpret_cast<uint32_t*>(&h);
      lo[kk][j] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
  }
}

// A row of an accumulator is spread over the four lanes of a quad.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stores the rows of an m64nD accumulator (times scale) that this thread
// holds into a [b, l, h, D] tensor; row0 is its first row's token index.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2], const float* scale,
                                           int row0, int rows, int bi, int h, int hi, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    bf16* dst = out + (((long long)bi * rows + row) * h + hi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dst + acc_col(i, lane)) =
          __floats2bfloat162_rn(acc[i] * scale[r], acc[i + 1] * scale[r]);
    }
  }
}

// -- forward -------------------------------------------------------------------

// A block of either kernel is one consumer warpgroup (threads 0-127) and
// one producer warp (threads 128-159).
constexpr int kThreads = 128 + 32;

template <int D>
struct Fwd {
  static constexpr int BM = 64;      // query rows a block
  static constexpr int BN = 64;      // keys a tile
  static constexpr int STAGES = 2;   // K/V tiles in flight
  // blocks an SM must hold: four at d <= 64, which caps registers at 102
  static constexpr int MIN_BLOCKS = D <= 64 ? 4 : 1;
  static constexpr int Q_BYTES = Tile<D>::bytes(BM);
  static constexpr int KV_BYTES = Tile<D>::bytes(BN);
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(kThreads, Fwd<D>::MIN_BLOCKS)
tfk8s_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ mask,
                       bf16* __restrict__ o, float* __restrict__ lse, int lq, int lk, int h,
                       int causal) {
  using C = Fwd<D>;
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* skv = sq + C::Q_BYTES;  // stage s: its K tile, then its V tile
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(skv + C::STAGES * 2 * C::KV_BYTES);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + C::STAGES;

  const int bh = blockIdx.x, bi = bh / h, hi = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;  // the rows with the most keys first
  const int offset = lk - lq;                           // causal: query i sees keys <= i + offset
  const int kend = causal ? min(lk, offset + min(q0 + C::BM, lq)) : lk;
  const int ntiles = (kend + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int a = 0; a < T::ATOMS; ++a)
        tma_load(sq + a * C::BM * T::SW, &tm_q, bar_q, a * T::COLS, hi, q0, bi);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::STAGES;
        if (t >= C::STAGES) mbar_wait(&empty[s], (t / C::STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        uint8_t* kt = skv + s * 2 * C::KV_BYTES;
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load(kt + a * C::BN * T::SW, &tm_k, &full[s], a * T::COLS, hi, t * C::BN, bi);
          tma_load(kt + C::KV_BYTES + a * C::BN * T::SW, &tm_v, &full[s], a * T::COLS, hi,
                   t * C::BN, bi);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = q0 + 16 * warp + lane / 4;  // this thread's rows: row and row + 8
  const uint8_t* mrow = mask ? mask + (long long)bi * lk : nullptr;
  const uint32_t q_tile = smem_u32(sq);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in log2 units
  mbar_wait(bar_q, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % C::STAGES, k0 = t * C::BN;
    mbar_wait(&full[s], (t / C::STAGES) & 1);
    const uint32_t kt = smem_u32(skv + s * 2 * C::KV_BYTES), vt = kt + C::KV_BYTES;
    float sc[C::BN / 2];
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) sc[i] = 0.f;
    pin(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<C::BN>::template ss<0>(sc, desc_k<D>(q_tile, C::BM, kk), desc_k<D>(kt, C::BN, kk),
                                   kk > 0);
    wg_commit();
    wg_wait_all();
    pin(sc);

    const bool edge =
        k0 + C::BN > lk || mrow != nullptr || (causal && k0 + C::BN - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) {
      float x = sc[i] * kLog2e;
      if (edge) {
        const int key = k0 + acc_col(i, lane);
        const int qpos = offset + row + 8 * acc_half(i);
        const bool vis =
            key < lk && (!causal || key <= qpos) && (mrow == nullptr || mrow[key] != 0);
        x = vis ? x : -INFINITY;
      }
      sc[i] = x;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i)
        if (acc_half(i) == r) mx = fmaxf(mx, sc[i]);
      const float m_new = fmaxf(m[r], quad_max(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no key seen yet
      const float corr = exp2f(m[r] - base);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        if (acc_half(i) == r) acc[i] *= corr;
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) {
        if (acc_half(i) != r) continue;
        sc[i] = exp2f(sc[i] - base);
        l[r] += sc[i];
      }
    }

    uint32_t pa[C::BN / 16][4];
    to_a_frags<C::BN>(sc, pa);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk)
      Wgmma<D>::template rs<1>(acc, pa[kk], desc_mn<D>(vt, C::BN, kk), 1);
    wg_commit();
    wg_wait_all();
    pin(acc);
    mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    inv[r] = lt > 0.f ? 1.f / lt : 0.f;
    const int qi = row + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && qi < lq)
      lse[(long long)bh * lq + qi] = lt > 0.f ? (m[r] + log2f(lt)) * kLn2 : kNeg;
  }
  store_rows<D>(o, acc, inv, row, lq, bi, h, hi, lane);
}

// -- backward: the D = rowsum(dO * O) pre-pass -----------------------------------
// Writes, for every (b, h) and query row padded to lqp (a multiple of 64),
// D and lse * log2e; padding rows and fully masked rows get lse2 = +inf,
// so that their probabilities come out exactly 0 in dq and dk/dv without
// a mask.

template <int D>
__global__ void __launch_bounds__(256)
tfk8s_dsum_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ o,
                  const float* __restrict__ lse, float* __restrict__ dsum,
                  float* __restrict__ lse2, int lq, int h, int lqp, int rows) {
  constexpr int TPR = D / 8;  // threads a row, one 16-byte vector each
  // 32-bit indices (the launch checks that they fit): 64-bit division
  // would cost more than the row's arithmetic
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = gid / TPR, g = gid % TPR;
  const int bh = r / lqp, qi = r % lqp;
  const bool ok = r < rows && qi < lq;
  float part = 0.f;
  if (ok) {
    const long long off = ((long long)(bh / h * lq + qi) * h + bh % h) * D + g * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(dout + off);
    const uint4 b = *reinterpret_cast<const uint4*>(o + off);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(a2[j]), y = __bfloat1622float2(b2[j]);
      part = fmaf(x.x, y.x, part);
      part = fmaf(x.y, y.y, part);
    }
  }
#pragma unroll
  for (int s = TPR / 2; s > 0; s >>= 1) part += __shfl_xor_sync(0xffffffffu, part, s);
  if (g == 0 && r < rows) {
    dsum[r] = part;
    const float L = ok ? lse[(long long)bh * lq + qi] : 0.f;
    lse2[r] = ok && L > -1e29f ? L * kLog2e : INFINITY;
  }
}

// -- backward: dk, dv ------------------------------------------------------------

template <int D>
struct Dkv {
  static constexpr int BN = 64;                  // keys a block
  static constexpr int BM = D <= 64 ? 64 : 32;   // query rows a streamed tile
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = Tile<D>::bytes(BN);
  static constexpr int QT_BYTES = Tile<D>::bytes(BM);
  static constexpr int VEC_BYTES = BM * 4;
  // a stage: Q tile, dO tile, lse2[BM], D[BM], rounded up to keep atoms aligned
  static constexpr int STAGE_BYTES = (2 * QT_BYTES + 2 * VEC_BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
tfk8s_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ dsum,
                       const float* __restrict__ lse2, const uint8_t* __restrict__ mask,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int lq, int lk, int h, int lqp,
                       int causal) {
  using C = Dkv<D>;
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + C::KV_BYTES;
  uint8_t* sst = sv + C::KV_BYTES;  // stage s at sst + s * STAGE_BYTES
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sst + C::STAGES * C::STAGE_BYTES);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + C::STAGES;

  const int bh = blockIdx.x, bi = bh / h, hi = bh % h;
  const int k0 = blockIdx.y * C::BN;  // under causal masking the first key tiles see the most rows
  const int offset = lk - lq;
  // the first query row that sees key k0 is k0 - offset: earlier tiles are skipped
  const int qstart = causal ? max(0, k0 - offset) / C::BM * C::BM : 0;
  const int ntiles = (lq - qstart + C::BM - 1) / C::BM;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
      for (int a = 0; a < T::ATOMS; ++a) {
        tma_load(sk + a * C::BN * T::SW, &tm_k, bar_kv, a * T::COLS, hi, k0, bi);
        tma_load(sv + a * C::BN * T::SW, &tm_v, bar_kv, a * T::COLS, hi, k0, bi);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::STAGES, q0 = qstart + t * C::BM;
        if (t >= C::STAGES) mbar_wait(&empty[s], (t / C::STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::QT_BYTES + 2 * C::VEC_BYTES);
        uint8_t* st = sst + s * C::STAGE_BYTES;
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load(st + a * C::BM * T::SW, &tm_q, &full[s], a * T::COLS, hi, q0, bi);
          tma_load(st + C::QT_BYTES + a * C::BM * T::SW, &tm_do, &full[s], a * T::COLS, hi, q0,
                   bi);
        }
        const long long vec = (long long)bh * lqp + q0;
        bulk_load(st + 2 * C::QT_BYTES, lse2 + vec, C::VEC_BYTES, &full[s]);
        bulk_load(st + 2 * C::QT_BYTES + C::VEC_BYTES, dsum + vec, C::VEC_BYTES, &full[s]);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = k0 + 16 * warp + lane / 4;  // this thread's keys: key and key + 8
  bool key_ok[2];  // the key exists and the mask lets it be seen
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key + 8 * r;
    key_ok[r] = kj < lk && (mask == nullptr || mask[(long long)bi * lk + kj] != 0);
  }
  const uint32_t k_tile = smem_u32(sk), v_tile = smem_u32(sv);

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % C::STAGES, q0 = qstart + t * C::BM;
    mbar_wait(&full[s], (t / C::STAGES) & 1);
    const uint8_t* st = sst + s * C::STAGE_BYTES;
    const uint32_t q_t = smem_u32(st), do_t = q_t + C::QT_BYTES;
    const float* l2 = reinterpret_cast<const float*>(st + 2 * C::QT_BYTES);
    const float* dd = l2 + C::BM;
    float sc[C::BM / 2], dp[C::BM / 2];
#pragma unroll
    for (int i = 0; i < C::BM / 2; ++i) sc[i] = dp[i] = 0.f;
    pin(sc);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<C::BM>::template ss<0>(sc, desc_k<D>(k_tile, C::BN, kk), desc_k<D>(q_t, C::BM, kk),
                                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<C::BM>::template ss<0>(dp, desc_k<D>(v_tile, C::BN, kk), desc_k<D>(do_t, C::BM, kk),
                                   kk > 0);
    wg_commit();
    wg_wait_all();
    pin(sc);
    pin(dp);

    // causal masking within the tile only where it holds the diagonal
    const bool diag = causal && k0 + C::BN - 1 > q0 + offset;
#pragma unroll
    for (int i = 0; i < C::BM / 2; ++i) {
      const int c = acc_col(i, lane), r = acc_half(i);
      bool vis = key_ok[r];
      if (diag) vis = vis && key + 8 * r <= q0 + c + offset;
      const float p = vis ? exp2f(fmaf(sc[i], kLog2e, -l2[c])) : 0.f;
      sc[i] = p;
      dp[i] = p * (dp[i] - dd[c]);
    }
    uint32_t pa[C::BM / 16][4], da[C::BM / 16][4];
    to_a_frags<C::BM>(sc, pa);
    to_a_frags<C::BM>(dp, da);
    pin(dva);
    pin(dka);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk)
      Wgmma<D>::template rs<1>(dva, pa[kk], desc_mn<D>(do_t, C::BM, kk), 1);
#pragma unroll
    for (int kk = 0; kk < C::BM / 16; ++kk)
      Wgmma<D>::template rs<1>(dka, da[kk], desc_mn<D>(q_t, C::BM, kk), 1);
    wg_commit();
    wg_wait_all();
    pin(dva);
    pin(dka);
    mbar_arrive(&empty[s]);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, dka, one, key, lk, bi, h, hi, lane);
  store_rows<D>(dv, dva, one, key, lk, bi, h, hi, lane);
}

// -- backward: dq ----------------------------------------------------------------

template <int D>
struct Dq {
  static constexpr int BM = 64;     // query rows a block
  static constexpr int BN = 64;     // keys a tile
  static constexpr int STAGES = 2;  // K/V tiles in flight
  // blocks an SM must hold: two, which caps registers at 204
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int Q_BYTES = Tile<D>::bytes(BM);
  static constexpr int KV_BYTES = Tile<D>::bytes(BN);
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(kThreads, Dq<D>::MIN_BLOCKS)
tfk8s_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ dsum,
                      const float* __restrict__ lse2, const uint8_t* __restrict__ mask,
                      bf16* __restrict__ dq, int lq, int lk, int h, int lqp, int causal) {
  using C = Dq<D>;
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sdo = sq + C::Q_BYTES;
  uint8_t* skv = sdo + C::Q_BYTES;  // stage s: its K tile, then its V tile
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(skv + C::STAGES * 2 * C::KV_BYTES);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + C::STAGES;

  const int bh = blockIdx.x, bi = bh / h, hi = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;  // the rows with the most keys first
  const int offset = lk - lq;
  const int kend = causal ? min(lk, offset + min(q0 + C::BM, lq)) : lk;
  const int ntiles = (kend + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
      for (int a = 0; a < T::ATOMS; ++a) {
        tma_load(sq + a * C::BM * T::SW, &tm_q, bar_q, a * T::COLS, hi, q0, bi);
        tma_load(sdo + a * C::BM * T::SW, &tm_do, bar_q, a * T::COLS, hi, q0, bi);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::STAGES;
        if (t >= C::STAGES) mbar_wait(&empty[s], (t / C::STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        uint8_t* kt = skv + s * 2 * C::KV_BYTES;
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load(kt + a * C::BN * T::SW, &tm_k, &full[s], a * T::COLS, hi, t * C::BN, bi);
          tma_load(kt + C::KV_BYTES + a * C::BN * T::SW, &tm_v, &full[s], a * T::COLS, hi,
                   t * C::BN, bi);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = q0 + 16 * warp + lane / 4;  // this thread's rows: row and row + 8
  const uint8_t* mrow = mask ? mask + (long long)bi * lk : nullptr;
  const uint32_t q_tile = smem_u32(sq), do_tile = smem_u32(sdo);
  // the pre-pass's D and lse * log2e of this thread's rows (padded to a
  // multiple of BM, so in bounds); +inf lse2 makes a padding or fully
  // masked row's probabilities, and with them its dq, exactly zero
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = (long long)bh * lqp + row + 8 * r;
    l2[r] = lse2[i];
    dd[r] = dsum[i];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % C::STAGES, k0 = t * C::BN;
    mbar_wait(&full[s], (t / C::STAGES) & 1);
    const uint32_t kt = smem_u32(skv + s * 2 * C::KV_BYTES), vt = kt + C::KV_BYTES;
    float sc[C::BN / 2], dp[C::BN / 2];
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) sc[i] = dp[i] = 0.f;
    pin(sc);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<C::BN>::template ss<0>(sc, desc_k<D>(q_tile, C::BM, kk), desc_k<D>(kt, C::BN, kk),
                                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<C::BN>::template ss<0>(dp, desc_k<D>(do_tile, C::BM, kk), desc_k<D>(vt, C::BN, kk),
                                   kk > 0);
    wg_commit();
    wg_wait_all();
    pin(sc);
    pin(dp);

    // dS = P (dP - D), masks only on tiles with the diagonal, the ragged
    // key edge or a key mask
    const bool edge =
        k0 + C::BN > lk || mrow != nullptr || (causal && k0 + C::BN - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) {
      const int r = acc_half(i);
      float p = exp2f(fmaf(sc[i], kLog2e, -l2[r]));
      if (edge) {
        const int key = k0 + acc_col(i, lane);
        const bool vis = key < lk && (!causal || key <= offset + row + 8 * r) &&
                         (mrow == nullptr || mrow[key] != 0);
        p = vis ? p : 0.f;
      }
      dp[i] = p * (dp[i] - dd[r]);
    }
    uint32_t da[C::BN / 16][4], db[C::BN / 16][4];  // dS = da + db
    to_a_frags_split<C::BN>(dp, da, db);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) {
      Wgmma<D>::template rs<1>(acc, da[kk], desc_mn<D>(kt, C::BN, kk), 1);
      Wgmma<D>::template rs<1>(acc, db[kk], desc_mn<D>(kt, C::BN, kk), 1);
    }
    wg_commit();
    wg_wait_all();
    pin(acc);
    mbar_arrive(&empty[s]);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, acc, one, row, lq, bi, h, hi, lane);
}

// -- host: tensor maps and launches ------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a contiguous [b, l, h, D] bf16 tensor whose box is one swizzle
// atom of `rows` tokens of one (batch, head): [1, rows, 1, COLS]. Rows past
// l read as zeros, which is the ragged edge.
template <int D>
bool make_map(CUtensorMap* map, const void* base, int b, int l, int h, int rows) {
  using T = Tile<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)h, (cuuint64_t)l, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)h * D * 2,
                                 (cuuint64_t)l * h * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::COLS, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets a kernel take more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                       void* lse, int b, int lq, int lk, int h, int causal, cudaStream_t st) {
  using C = Fwd<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(&mq, q, b, lq, h, C::BM) || !make_map<D>(&mk, k, b, lk, h, C::BN) ||
      !make_map<D>(&mv, v, b, lk, h, C::BN))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(tfk8s_fwd_wgmma_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(b * h, (lq + C::BM - 1) / C::BM);
  tfk8s_fwd_wgmma_kernel<D><<<grid, kThreads, C::SMEM, st>>>(
      mq, mk, mv, (const uint8_t*)mask, (bf16*)o, (float*)lse, lq, lk, h, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dsum(const void* dout, const void* o, const void* lse, void* dsum, void* lse2,
                        int b, int lq, int h, int lqp, cudaStream_t st) {
  const long long rows = (long long)b * h * lqp;
  const long long threads = rows * (D / 8);
  if (threads + 255 > INT_MAX) return cudaErrorInvalidValue;
  tfk8s_dsum_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const bf16*)dout, (const bf16*)o, (const float*)lse, (float*)dsum, (float*)lse2, lq, h, lqp,
      (int)rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* dsum, const void* lse2, const void* mask, void* dk, void* dv,
                       int b, int lq, int lk, int h, int lqp, int causal, cudaStream_t st) {
  using C = Dkv<D>;
  // the kernel reads whole tiles of the pre-pass's padded rows
  if (lqp < lq || lqp % C::BM != 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<D>(&mq, q, b, lq, h, C::BM) || !make_map<D>(&mdo, dout, b, lq, h, C::BM) ||
      !make_map<D>(&mk, k, b, lk, h, C::BN) || !make_map<D>(&mv, v, b, lk, h, C::BN))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(tfk8s_dkv_wgmma_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(b * h, (lk + C::BN - 1) / C::BN);
  tfk8s_dkv_wgmma_kernel<D><<<grid, kThreads, C::SMEM, st>>>(
      mq, mk, mv, mdo, (const float*)dsum, (const float*)lse2, (const uint8_t*)mask, (bf16*)dk,
      (bf16*)dv, lq, lk, h, lqp, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* dsum, const void* lse2, const void* mask, void* dq, int b,
                      int lq, int lk, int h, int lqp, int causal, cudaStream_t st) {
  using C = Dq<D>;
  // each thread reads the pre-pass's values of its rows, padding rows included
  if (lqp < lq || lqp % C::BM != 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<D>(&mq, q, b, lq, h, C::BM) || !make_map<D>(&mdo, dout, b, lq, h, C::BM) ||
      !make_map<D>(&mk, k, b, lk, h, C::BN) || !make_map<D>(&mv, v, b, lk, h, C::BN))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(tfk8s_dq_wgmma_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(b * h, (lq + C::BM - 1) / C::BM);
  tfk8s_dq_wgmma_kernel<D><<<grid, kThreads, C::SMEM, st>>>(
      mq, mk, mv, mdo, (const float*)dsum, (const float*)lse2, (const uint8_t*)mask, (bf16*)dq,
      lq, lk, h, lqp, causal);
  return cudaGetLastError();
}

#define TFK8S_BY_HEAD_DIM(FN, ...)                  \
  do {                                              \
    switch (d) {                                    \
      case 16: return (int)FN<16>(__VA_ARGS__);     \
      case 32: return (int)FN<32>(__VA_ARGS__);     \
      case 64: return (int)FN<64>(__VA_ARGS__);     \
      case 128: return (int)FN<128>(__VA_ARGS__);   \
    }                                               \
    return (int)cudaErrorInvalidValue;              \
  } while (0)

}  // namespace

// Each entry point takes bfloat16 tensors and returns the cudaError_t of
// its launch (0 = success); cudaErrorInvalidValue also when a tensor map
// cannot be made.
extern "C" {

int tfk8s_flash_fwd_wgmma(const void* q, const void* k, const void* v, const void* mask, void* o,
                          void* lse, int b, int lq, int lk, int h, int d, int causal,
                          void* stream) {
  TFK8S_BY_HEAD_DIM(launch_fwd, q, k, v, mask, o, lse, b, lq, lk, h, causal,
                    (cudaStream_t)stream);
}

int tfk8s_flash_bwd_dsum(const void* dout, const void* o, const void* lse, void* dsum, void* lse2,
                         int b, int lq, int h, int d, int lqp, void* stream) {
  TFK8S_BY_HEAD_DIM(launch_dsum, dout, o, lse, dsum, lse2, b, lq, h, lqp, (cudaStream_t)stream);
}

int tfk8s_flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                              const void* dsum, const void* lse2, const void* mask, void* dk,
                              void* dv, int b, int lq, int lk, int h, int d, int lqp, int causal,
                              void* stream) {
  TFK8S_BY_HEAD_DIM(launch_dkv, q, k, v, dout, dsum, lse2, mask, dk, dv, b, lq, lk, h, lqp, causal,
                    (cudaStream_t)stream);
}

int tfk8s_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const void* dsum, const void* lse2, const void* mask, void* dq, int b,
                             int lq, int lk, int h, int d, int lqp, int causal, void* stream) {
  TFK8S_BY_HEAD_DIM(launch_dq, q, k, v, dout, dsum, lse2, mask, dq, b, lq, lk, h, lqp, causal,
                    (cudaStream_t)stream);
}

}  // extern "C"
