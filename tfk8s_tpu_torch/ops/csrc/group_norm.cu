// Fused NHWC GroupNorm + affine + optional ReLU for Hopper (sm_90a),
// forward and backward, behind a plain C interface loaded with ctypes
// (tfk8s_tpu_torch/ops/_build.py builds this file with nvcc). Nothing is
// linked beyond the CUDA runtime: cuTensorMapEncodeTiled is fetched from
// libcuda through cudaGetDriverEntryPoint.
//
// Replaces the Pallas TPU kernels of tfk8s_tpu/ops/group_norm.py:
//   tfk8s_gn_fwd_cluster_kernel <- _fwd_kernel (:68, launched by _fwd_impl :98 at :103)
//   tfk8s_gn_bwd_cluster_kernel <- _bwd_kernel (:137, launched by _bwd_impl :184 at :187)
// and, for the shapes whose slab does not fit a cluster (below), the
// two-read kernels of the same file (tfk8s_group_norm_fwd_2pass,
// tfk8s_group_norm_bwd_2pass).
//
// Contract (the same as the plain PyTorch versions in group_norm.py):
// x, dy, y, dx are contiguous [B, H*W, C] (NHWC) float32 or bfloat16, any
// C; groups are contiguous channel blocks of C / G; gamma, beta are [C]
// float32; mean and rstd are [B, G] float32. Statistics are float32 with
// the biased variance and eps inside the square root:
//   y = ((x - mean) * rstd) * gamma + beta, then max(y, 0) if relu,
// evaluated with separately rounded float32 operations (no fused
// multiply-add), exactly as the plain version's PyTorch ops do, so the
// backward's ReLU mask is the forward's bit for bit. The backward writes
// per-sample [B, C] partials of dgamma and dbeta, every entry of them.
//
// What bounds it. Every pass over [B, H*W, C] is elementwise with a
// per-(sample, group) reduction: memory-bound. The bound counts each input
// read once and each output written once: bfloat16 4 bytes a value
// forward (x in, y out), 6 backward (dy, x in, dx out).
//
// The one-read design. The Pallas kernel keeps one whole sample in VMEM and
// reads x once; a [56, 56, 256] bfloat16 sample is 1.6 MB against 227 KB of
// shared memory here. What must be resident for statistics that need
// nothing from outside is less: a (sample, channel tile) slab, the tile a
// whole number of groups, over all H*W positions. A thread-block cluster of
// K <= 8 blocks holds one slab: each block holds its share of the slab's
// positions in its shared memory. Thread 0 issues the whole share at once,
// as TMA boxes of up to 256 positions over a [B, HW, C] tensor map (C * elt
// a multiple of 16 bytes and 16-byte aligned tensors, every ResNet-50
// site), each box row counted on its own mbarrier; otherwise every thread
// issues cp.async copies as wide as C and the tensors' alignment allow
// (pick_vec), so a view that starts mid-buffer still reads once. Then
//   forward:  sums each channel over its positions box by box as the boxes
//             land; the cluster adds the groups' sums over distributed
//             shared memory in rank order (mean), then the same for
//             sum (x - mean)^2 from shared memory (the reference's two-pass
//             formula, tfk8s_tpu/ops/group_norm.py:80-84: exact, no Welford
//             merges); y is written from shared memory;
//   backward: sums dz * xhat and dz per channel box by box (dz: dy under the
//             recomputed ReLU mask; mean, rstd, gamma, beta are read while
//             the boxes arrive), adds them over the cluster in rank order
//             (rank 0 writes them as the [B, C] partials), folds them into
//             the group's two moments and writes dx from shared memory.
// x (and dy) are read from device memory once and y (dx) written once: the
// bound's own traffic, 4 and 6 bytes a bfloat16 value, in one launch. The
// layout rule (plan_slab, kPrefs) takes the fewest blocks a cluster, then
// the widest tile of whole groups, first with tiles of at least 64 bytes a
// position and blocks of at most 113 KB (two to an SM), then 32 bytes, then
// blocks of up to 227 KB (one to an SM). Every ResNet-50 norm site fits in
// both types and both directions, in clusters of 1 to 8 (the stem's
// [112, 112, 64]: 8 in bfloat16, 7 in float32). What is left between the
// kernels and the bound: a block's phases run in turn (loads, then the
// cluster's two reductions and the second sweep, then the stores), so an
// SM's memory traffic pauses while both of its blocks reduce.
//
// The two-read path, for a slab beyond 8 blocks' shared memory (one group
// across a 256x256x32 image, say) or a tile wider than 512 columns
// (plan_slab and the wrapper choose it, not a failure): three kernels a
// direction, as the first version of this file ran everything:
//   1. a sweep over x (and dy) that writes per-channel partials of each
//      chunk of positions: [B, S, C] float2;
//   2. a small kernel, one block per (sample, group), that merges a group's
//      partials: mean and rstd forward; the group's two moments and the
//      per-sample dgamma, dbeta backward;
//   3. a sweep that writes y (dx).
// x is read twice forward (6 bytes a bfloat16 value), dy and x twice
// backward (10). The sweeps' blocks each take one (sample, channel tile,
// chunk) of positions; inside a block each thread owns VEC consecutive
// channels (16-byte loads) of every rows-th position of the chunk. Each
// thread keeps a Welford (count, mean, M2) per channel; rows, then chunks,
// then a group's channels are merged with Chan's formula in a fixed order.
//
// Numerics of both paths: no one-pass E[x^2] - mean^2 (which cancels
// catastrophically when |mean| >> std) and no float atomic: every sum runs
// in a fixed order, so every output repeats bit for bit from run to run.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}
template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

// xhat = (x - mean) * rstd, rounded once per operation (no contraction)
__device__ __forceinline__ float xhat_of(float x, float mu, float rs) {
  return __fmul_rn(__fsub_rn(x, mu), rs);
}
// the pre-ReLU output xhat * gamma + beta, rounded once per operation
__device__ __forceinline__ float affine(float xh, float ga, float be) {
  return __fadd_rn(__fmul_rn(xh, ga), be);
}

// ============================================================================
// One read: a (sample, channel tile) slab in a thread-block cluster
// ============================================================================

// threads of a block whose tile is at most that many columns, forward and
// backward (the backward's block holds more registers a thread)
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 256;
constexpr int kSlabMaxThreads = 512;  // the widest tile: a thread a column
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kBoxRows = 256;         // the TMA's largest box side
constexpr int kSmemTwoBlocks = 113 * 1024;  // a block's shared memory when two share an SM
constexpr int kSmemMax = 227 * 1024;        // the most one block may take
// The layout rule's preferences, in order: (the least bytes a tile holds
// of a position, the most shared memory a block takes). A tile is never
// narrower than one 32-byte sector a position, unless C itself is; two
// sectors a position, where they fit two blocks to an SM, measured 7-16%
// faster at the 56x56 and 112x112 ResNet-50 sites (kernel_variants, "gn").
constexpr int kPrefs[][2] = {{64, kSmemTwoBlocks}, {32, kSmemTwoBlocks}, {32, kSmemMax}};

// The layout of a one-read launch; every field is set by plan_slab.
struct Slab {
  int b, hw, c, groups, cg;
  int elt, vec, nin, tma;   // bytes a value; values a vector; inputs held (1 fwd, 2 bwd); TMA?
  int gpt, ct, tiles, k;    // groups and channels a tile; tiles a sample; blocks a cluster
  int rbox, chunk;          // positions a box; positions a block holds (a multiple of rbox)
  int bc, bcols;            // channels a box (the tile's width without TMA); bc / vec
  int tcols, rows, threads; // a thread per vec channels of a position: tcols x rows threads
  int sub, wrows;           // rows a warp butterfly folds; rows left for the shared sum
  int off_red, off_ch, off_tot, off_grp, off_gam, off_bar;  // shared-memory layout, bytes
  int smem;                 // bytes a block asks for, 128 of alignment slack included
};

__host__ __device__ constexpr long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

// The block geometry for cluster size k and gpt groups a tile; false when
// a block of it cannot launch.
bool slab_geom(Slab& s, int k, int gpt) {
  s.k = k;
  s.gpt = gpt;
  s.ct = gpt * s.cg;
  s.tiles = s.groups / gpt;
  s.tcols = s.ct / s.vec;
  if (s.tcols > kSlabMaxThreads) return false;
  const int base = s.nin == 1 ? kFwdThreads : kBwdThreads;
  s.threads = s.tcols > base ? s.tcols : base / s.tcols * s.tcols;
  s.rows = s.threads / s.tcols;
  // a warp's lanes of one column fold by butterfly when columns tile a warp
  s.sub = s.tcols < 32 && 32 % s.tcols == 0 ? 32 / s.tcols : 1;
  s.wrows = s.rows / s.sub;
  // a block's share of the positions: whole boxes of a multiple of 8 rows
  const int share = (s.hw + k - 1) / k;
  const int nbox = (share + kBoxRows - 1) / kBoxRows;
  s.rbox = (int)round_up((share + nbox - 1) / nbox, 8);
  s.chunk = s.rbox * nbox;
  if ((long long)(k - 1) * s.chunk >= s.hw) return false;  // every block holds a position
  s.bc = s.ct;
  if (s.tma && s.bc > kBoxRows) {  // the widest box of at most 256 channels dividing the tile
    s.bc = kBoxRows / s.vec * s.vec;
    while (s.ct % s.bc) s.bc -= s.vec;
  }
  s.bcols = s.bc / s.vec;
  const int nq = s.nin;  // quantities summed a channel: 1 forward, 2 backward
  long long off = round_up((long long)s.chunk * s.ct * s.elt, 128) * s.nin;
  s.off_red = (int)off;
  off += round_up(4LL * nq * s.wrows * s.ct, 16);
  s.off_ch = (int)off;  // the block's channel sums, which the cluster reads
  off += round_up(4LL * nq * s.ct, 16);
  s.off_tot = (int)off;  // the cluster's channel sums (backward)
  off += round_up(4LL * nq * s.ct, 16);
  s.off_grp = (int)off;  // per group: sum, M2, mean, rstd (forward); s1, s2 (backward)
  off += round_up(4LL * 4 * s.gpt, 16);
  s.off_gam = (int)off;  // the tile's gamma (backward)
  off += round_up(4LL * s.ct, 16);
  s.off_bar = (int)off;  // an mbarrier a row box
  off += 8 * nbox + 128;
  if (off > kSmemMax) return false;
  s.smem = (int)off;
  return true;
}

// The largest power of two, at most 16, that divides every address.
int align_of(const void* const* ptrs, int nptrs) {
  int align = 16;
  for (int i = 0; i < nptrs; ++i)
    while ((uintptr_t)ptrs[i] % align) align /= 2;
  return align;
}

// The values a load moves: the widest load, of at most 16 bytes, that
// divides C and that addresses aligned to `align` bytes allow.
int pick_vec(int c, int elt, int align) {
  int vec = 16 / elt;
  while (vec > 1 && (c % vec || align % (vec * elt))) vec /= 2;
  return vec;
}

// The one-read layout of a launch on [b, hw, c] with `groups` groups and
// tensors `align` bytes aligned (align_of), or false when none fits (then
// the two-read path runs): for the first of kPrefs that any layout meets,
// the fewest blocks a cluster and, for them, the widest tile of whole
// groups.
bool plan_slab(Slab& s, int b, int hw, int c, int groups, int dtype, int backward, int align) {
  if (b <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups || (dtype != 0 && dtype != 1))
    return false;
  if ((long long)b * groups * kMaxCluster >= (1LL << 31)) return false;  // a 1-D grid
  s = Slab{};
  s.b = b;
  s.hw = hw;
  s.c = c;
  s.groups = groups;
  s.cg = c / groups;
  s.elt = dtype == 0 ? 4 : 2;
  s.nin = backward ? 2 : 1;
  if (align % s.elt) return false;
  s.vec = pick_vec(c, s.elt, align);
  s.tma = s.vec * s.elt == 16;  // C * elt a multiple of 16 bytes, 16-byte aligned tensors
  for (const auto& pref : kPrefs) {
    const int min_bytes = pref[0], budget = pref[1];
    for (int k = 1; k <= kMaxCluster; ++k) {
      // no wider tile can fit: its slab share alone would exceed the budget
      const long long per_group = (long long)s.nin * ((hw + k - 1) / k) * s.cg * s.elt;
      long long top = budget / per_group;
      if (top > groups) top = groups;
      if (top > (long long)kSlabMaxThreads * s.vec / s.cg) top = kSlabMaxThreads * s.vec / s.cg;
      for (int gpt = (int)top; gpt >= 1; --gpt) {
        if (groups % gpt || (gpt * s.cg) % s.vec) continue;
        if (gpt < groups && gpt * s.cg * s.elt < min_bytes) break;
        if (slab_geom(s, k, gpt) && s.smem <= budget) return true;
      }
    }
  }
  return false;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
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

// One box of a 3-D [b, hw, c] map (coordinates innermost first) into
// shared memory; completion is counted on bar in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One vector global -> shared by cp.async (4, 8 or 16 bytes); a single
// bfloat16 by a plain copy.
template <typename T, int VEC>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
                 "l"(__cvta_generic_to_global(src))
                 : "memory");
  } else if constexpr (kBytes >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)),
                 "l"(__cvta_generic_to_global(src)), "n"(kBytes)
                 : "memory");
  } else {
    *dst = *src;
  }
}

// The cluster barrier in two halves: arrive once this block has read the
// others' shared memory, wait before it exits, so that its own stays
// readable until every block of the cluster is done with it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Sum of v over a warp by butterfly: every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[g] = the sum of v[g * cg + i] over a group's cg channels, for each of
// the tile's gpt groups: a warp a group, lanes over channels, then a
// butterfly (a partial last warp sits out).
__device__ __forceinline__ void group_sums(const float* v, float* out, const Slab& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = s.threads >> 5;
  if (warp >= nwarps) return;
  for (int g = warp; g < s.gpt; g += nwarps) {
    float a = 0.f;
    for (int i = lane; i < s.cg; i += 32) a += v[g * s.cg + i];
    a = warp_sum(a);
    if (lane == 0) out[g] = a;
  }
}

// Shared-memory element offset of column `col`'s vector at position 0: a
// tile is held as [channel box][chunk positions][bc channels].
__device__ __forceinline__ int col_base(const Slab& s, int col, int vec) {
  return (col / s.bcols) * s.chunk * s.bc + (col % s.bcols) * vec;
}

// Start loading this block's n positions from p0 of tile t of sample b,
// for NIN inputs, into shared memory. TMA: thread 0 sets up one mbarrier a
// row box of rbox positions (every channel box of every input counted on
// it) and issues every box at once. cp.async: every thread issues its
// vectors. Each thread must pass a __syncthreads before wait_box.
template <typename T, int VEC, int NIN>
__device__ __forceinline__ void issue_slab(const CUtensorMap* const (&maps)[NIN],
                                           const T* const (&src)[NIN], T* const (&dst)[NIN],
                                           uint64_t* bars, const Slab& s, int b, int t, int p0,
                                           int n) {
  const int tid = threadIdx.x;
  if (s.tma) {
    if (tid != 0) return;
    const int nrb = (n + s.rbox - 1) / s.rbox, ncb = s.ct / s.bc;
    for (int r = 0; r < nrb; ++r) mbar_init(&bars[r], 1);
    for (int r = 0; r < nrb; ++r) {
      mbar_expect_tx(&bars[r], (uint32_t)NIN * ncb * s.rbox * s.bc * (uint32_t)sizeof(T));
      for (int i = 0; i < NIN; ++i)
        for (int j = 0; j < ncb; ++j)
          tma_load(dst[i] + ((size_t)j * s.chunk + (size_t)r * s.rbox) * s.bc, maps[i],
                   &bars[r], t * s.ct + j * s.bc, p0 + r * s.rbox, b);
    }
  } else {
    const size_t base = ((size_t)b * s.hw + p0) * s.c + (size_t)t * s.ct;
    for (int i = 0; i < NIN; ++i)
      for (int v = tid; v < n * s.tcols; v += s.threads) {
        const int q = v / s.tcols, col = v % s.tcols;
        copy_async<T, VEC>(dst[i] + col_base(s, col, VEC) + q * s.bc,
                           src[i] + base + (size_t)q * s.c + col * VEC);
      }
  }
}

// The loads arrive in boxes: TMA row boxes of rbox positions, or under
// cp.async the whole share as one box. Box r holds positions
// [r * box_rows, min((r + 1) * box_rows, n)).
__device__ __forceinline__ int box_count(const Slab& s, int n) {
  return s.tma ? (n + s.rbox - 1) / s.rbox : 1;
}
__device__ __forceinline__ int box_rows(const Slab& s) { return s.tma ? s.rbox : s.chunk; }

// Wait until box r is in shared memory and visible to this thread. Every
// thread calls it for r = 0, 1, ... in turn.
__device__ __forceinline__ void wait_box(const Slab& s, uint64_t* bars, int r) {
  if (s.tma) {
    mbar_wait(&bars[r], 0);
  } else if (r == 0) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }
}

// The block's per-channel sums of NQ quantities: acc[q][e] is this
// thread's partial of channel lcol * VEC + e over its positions. Lanes of
// one column fold by butterfly inside a warp, then the warps' rows are
// added in order through shared memory. out[q * ct + ch] gets the sums;
// every thread sees them on return.
template <int VEC, int NQ>
__device__ __forceinline__ void column_sums(float (&acc)[NQ][VEC], float* red, float* out,
                                            const Slab& s) {
  const int tid = threadIdx.x, lcol = tid % s.tcols, row = tid / s.tcols;
  for (int o = s.tcols; s.sub > 1 && o < 32; o <<= 1) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][e] += __shfl_xor_sync(0xffffffffu, acc[q][e], o);
  }
  if (row % s.sub == 0) {
    const int wr = row / s.sub;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[(q * s.wrows + wr) * s.ct + lcol * VEC + e] = acc[q][e];
  }
  __syncthreads();
  for (int i = tid; i < NQ * s.ct; i += s.threads) {
    const int q = i / s.ct, ch = i % s.ct;
    float sum = 0.f;
    for (int r = 0; r < s.wrows; ++r) sum += red[(q * s.wrows + r) * s.ct + ch];
    out[i] = sum;
  }
  __syncthreads();
}

// ---- forward: statistics and y from one read of x ---------------------------

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kSlabMaxThreads) tfk8s_gn_fwd_cluster_kernel(
    const __grid_constant__ CUtensorMap tm_x, const T* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ beta, T* __restrict__ y,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, const Slab s, float eps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cell = blockIdx.x / s.k, b = cell / s.tiles, t = cell % s.tiles;
  const int p0 = rank * s.chunk, n = max(0, min(s.chunk, s.hw - p0));
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + s.off_red);
  float* chs = reinterpret_cast<float*>(smem + s.off_ch);
  float* gsum = reinterpret_cast<float*>(smem + s.off_grp);
  float *gm2 = gsum + s.gpt, *gmean = gsum + 2 * s.gpt, *grstd = gsum + 3 * s.gpt;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + s.off_bar);
  {
    const CUtensorMap* const maps[1] = {&tm_x};
    const T* const srcs[1] = {x};
    T* const dsts[1] = {xs};
    issue_slab<T, VEC, 1>(maps, srcs, dsts, bars, s, b, t, p0, n);
  }
  const int tid = threadIdx.x, lcol = tid % s.tcols, row = tid / s.tcols;
  const T* xcol = xs + col_base(s, lcol, VEC);
  // 1 / (values in a group), once: no division subroutine in the kernel
  const float inv_count = __frcp_rn((float)s.hw * (float)s.cg);
  float ga[VEC], be[VEC];  // read while the slab arrives
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    ga[e] = gamma[t * s.ct + lcol * VEC + e];
    be[e] = beta[t * s.ct + lcol * VEC + e];
  }
  __syncthreads();  // the barriers are set up

  // 1. the mean: channel sums box by box as the boxes land, a group's sum
  //    over its channels, then over the cluster
  float acc[1][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[0][e] = 0.f;
  const int nbox = box_count(s, n), rb = box_rows(s);
  for (int r = 0; r < nbox; ++r) {
    wait_box(s, bars, r);
    const int q1 = min(n, (r + 1) * rb);
    for (int q = r * rb + row; q < q1; q += s.rows) {
      const Pack<T, VEC> v = load<T, VEC>(xcol + q * s.bc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[0][e] += to_f(v.v[e]);
    }
  }
  column_sums<VEC, 1>(acc, red, chs, s);
  group_sums(chs, gsum, s);
  cluster.sync();
  for (int g = tid; g < s.gpt; g += s.threads) {
    float sum = 0.f;
    for (int r = 0; r < s.k; ++r) sum += *cluster.map_shared_rank(gsum + g, r);
    gmean[g] = sum * inv_count;
  }
  __syncthreads();

  // 2. the variance: sum (x - mean)^2 from the same shared memory
  float mu[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    mu[e] = gmean[(lcol * VEC + e) / s.cg];
    acc[0][e] = 0.f;
  }
  for (int q = row; q < n; q += s.rows) {
    const Pack<T, VEC> v = load<T, VEC>(xcol + q * s.bc);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = to_f(v.v[e]) - mu[e];
      acc[0][e] += d * d;
    }
  }
  column_sums<VEC, 1>(acc, red, chs, s);
  group_sums(chs, gm2, s);
  cluster.sync();
  for (int g = tid; g < s.gpt; g += s.threads) {
    float sum = 0.f;
    for (int r = 0; r < s.k; ++r) sum += *cluster.map_shared_rank(gm2 + g, r);
    grstd[g] = rsqrtf(sum * inv_count + eps);
    if (rank == 0) {
      mean_out[(size_t)b * s.groups + t * s.gpt + g] = gmean[g];
      rstd_out[(size_t)b * s.groups + t * s.gpt + g] = grstd[g];
    }
  }
  cluster_arrive();
  __syncthreads();

  // 3. normalize, affine, ReLU; y straight from registers to device memory
  float rs[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) rs[e] = grstd[(lcol * VEC + e) / s.cg];
  T* yb = y + ((size_t)b * s.hw + p0) * s.c + (size_t)t * s.ct + lcol * VEC;
  for (int q = row; q < n; q += s.rows) {
    const Pack<T, VEC> v = load<T, VEC>(xcol + q * s.bc);
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float yv = affine(xhat_of(to_f(v.v[e]), mu[e], rs[e]), ga[e], be[e]);
      if (RELU) yv = fmaxf(yv, 0.f);
      o.v[e] = from_f<T>(yv);
    }
    store<T, VEC>(yb + (size_t)q * s.c, o);
  }
  cluster_wait();
}

// ---- backward: dgamma, dbeta partials and dx from one read of dy and x ------

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kSlabMaxThreads) tfk8s_gn_bwd_cluster_kernel(
    const __grid_constant__ CUtensorMap tm_dy, const __grid_constant__ CUtensorMap tm_x,
    const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ mean,
    const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ dgamma_b,
    float* __restrict__ dbeta_b, const Slab s) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cell = blockIdx.x / s.k, b = cell / s.tiles, t = cell % s.tiles;
  const int p0 = rank * s.chunk, n = max(0, min(s.chunk, s.hw - p0));
  const size_t held = (size_t)round_up((long long)s.chunk * s.ct * s.elt, 128) / sizeof(T);
  T* xs = reinterpret_cast<T*>(smem);
  T* dys = xs + held;
  float* red = reinterpret_cast<float*>(smem + s.off_red);
  float* chs = reinterpret_cast<float*>(smem + s.off_ch);  // [2][ct]: sum dz * xhat, sum dz
  float* tot = reinterpret_cast<float*>(smem + s.off_tot);
  float* s1 = reinterpret_cast<float*>(smem + s.off_grp);
  float* s2 = s1 + s.gpt;
  float* gam = reinterpret_cast<float*>(smem + s.off_gam);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + s.off_bar);
  {
    const CUtensorMap* const maps[2] = {&tm_x, &tm_dy};
    const T* const srcs[2] = {x, dy};
    T* const dsts[2] = {xs, dys};
    issue_slab<T, VEC, 2>(maps, srcs, dsts, bars, s, b, t, p0, n);
  }
  // everything but the slab is read while the slab arrives
  const int tid = threadIdx.x, lcol = tid % s.tcols, row = tid / s.tcols;
  const int cb = col_base(s, lcol, VEC);
  float mu[VEC], rs[VEC], ga[VEC], be[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = t * s.ct + lcol * VEC + e;
    const size_t bg = (size_t)b * s.groups + ch / s.cg;
    mu[e] = mean[bg];
    rs[e] = rstd[bg];
    ga[e] = gamma[ch];
    be[e] = beta[ch];
  }
  for (int i = tid; i < s.ct; i += s.threads) gam[i] = gamma[t * s.ct + i];
  __syncthreads();  // the barriers are set up, gam is written

  // 1. per channel: sum dz * xhat and sum dz, box by box as the boxes land,
  //    over the block, then the cluster
  float acc[2][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[0][e] = acc[1][e] = 0.f;
  const int nbox = box_count(s, n), rb = box_rows(s);
  for (int r = 0; r < nbox; ++r) {
    wait_box(s, bars, r);
    const int q1 = min(n, (r + 1) * rb);
    for (int q = r * rb + row; q < q1; q += s.rows) {
      const Pack<T, VEC> vx = load<T, VEC>(xs + cb + q * s.bc);
      const Pack<T, VEC> vd = load<T, VEC>(dys + cb + q * s.bc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = xhat_of(to_f(vx.v[e]), mu[e], rs[e]);
        float dz = to_f(vd.v[e]);
        if (RELU && !(affine(xh, ga[e], be[e]) > 0.f)) dz = 0.f;
        acc[0][e] += dz * xh;
        acc[1][e] += dz;
      }
    }
  }
  column_sums<VEC, 2>(acc, red, chs, s);
  cluster.sync();
  for (int i = tid; i < s.ct; i += s.threads) {
    float tg = 0.f, tb = 0.f;
    for (int r = 0; r < s.k; ++r) {
      const float* other = cluster.map_shared_rank(chs, r);
      tg += other[i];
      tb += other[s.ct + i];
    }
    tot[i] = tg;
    tot[s.ct + i] = tb;
    if (rank == 0) {
      dgamma_b[(size_t)b * s.c + t * s.ct + i] = tg;
      dbeta_b[(size_t)b * s.c + t * s.ct + i] = tb;
    }
  }
  cluster_arrive();
  __syncthreads();

  // 2. a group's moments: s1 = mean of dz * gamma, s2 = mean of dz * gamma *
  //    xhat, a warp a group as in group_sums
  const float inv_count = __frcp_rn((float)s.hw * (float)s.cg);
  const int lane = tid & 31, warp = tid >> 5, nwarps = s.threads >> 5;
  for (int g = warp; warp < nwarps && g < s.gpt; g += nwarps) {
    float a1 = 0.f, a2 = 0.f;
    for (int i = lane; i < s.cg; i += 32) {
      const int ch = g * s.cg + i;
      a1 += gam[ch] * tot[s.ct + ch];
      a2 += gam[ch] * tot[ch];
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      s1[g] = a1 * inv_count;
      s2[g] = a2 * inv_count;
    }
  }
  __syncthreads();

  // 3. dx from shared memory
  float m1[VEC], m2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    m1[e] = s1[(lcol * VEC + e) / s.cg];
    m2[e] = s2[(lcol * VEC + e) / s.cg];
  }
  T* dxb = dx + ((size_t)b * s.hw + p0) * s.c + (size_t)t * s.ct + lcol * VEC;
  for (int q = row; q < n; q += s.rows) {
    const Pack<T, VEC> vx = load<T, VEC>(xs + cb + q * s.bc);
    const Pack<T, VEC> vd = load<T, VEC>(dys + cb + q * s.bc);
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float xh = xhat_of(to_f(vx.v[e]), mu[e], rs[e]);
      float dz = to_f(vd.v[e]);
      if (RELU && !(affine(xh, ga[e], be[e]) > 0.f)) dz = 0.f;
      const float dxh = dz * ga[e];
      o.v[e] = from_f<T>(rs[e] * (dxh - m1[e] - xh * m2[e]));
    }
    store<T, VEC>(dxb + (size_t)q * s.c, o);
  }
  cluster_wait();
}

// ============================================================================
// Two reads: chunk partials, a per-group merge, a second sweep
// ============================================================================

constexpr int kMinThreads = 256;    // a sweep's block has at least this many threads
constexpr int kTargetBlocks = 1024; // blocks a sweep aims for: ~8 on each of 132 SMs
constexpr int kMinChunk = 32;       // positions a chunk keeps at least, so that the
                                    // [B, S, C] float2 partials stay small next to x
constexpr int kFinalThreads = 128;  // threads of a (sample, group) block

// The most threads a sweep's block of VEC-wide columns takes, and so the
// columns of a channel tile: 2048 channels (1024 at VEC = 1).
__host__ __device__ constexpr int max_threads(int vec) {
  return 2048 / vec < kMinThreads ? kMinThreads : (2048 / vec > 1024 ? 1024 : 2048 / vec);
}

// Chan's merge of (nb, mb, m2b) into (na, ma, m2a); an empty side is a no-op.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float delta = mb - ma;
  const float wb = nb / n;
  ma += delta * wb;
  m2a += m2b + delta * delta * na * wb;
  na = n;
}

struct Geom {
  int b, hw, c, groups;
  int chunks, chunk;  // a sample's positions: `chunks` chunks of `chunk` (the last ragged)
  int ncol;           // columns: c / vec
  int tcols, tiles;   // columns of a channel tile; tiles = ceil(ncol / tcols)
  int rows;           // positions a sweep's block reads at once; threads = rows * tcols
  __host__ __device__ int cg() const { return c / groups; }
};

// The (sample, tile, chunk) of a sweep's block.
__device__ __forceinline__ void block_cell(const Geom& g, int& b, int& t, int& s) {
  const int blk = blockIdx.x;
  s = blk % g.chunks;
  t = (blk / g.chunks) % g.tiles;
  b = blk / (g.chunks * g.tiles);
}

// Positions [p0, p1) of chunk s.
__device__ __forceinline__ void chunk_range(const Geom& g, int s, int& p0, int& p1) {
  p0 = s * g.chunk;
  p1 = min(p0 + g.chunk, g.hw);
}

// Sum of v over the block in a fixed order (butterfly in each warp, then
// the warps in order): every thread gets the same bits. sh holds 32 floats.
__device__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // sh may still be read by the previous call
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += sh[w];
  return t;
}

// ---- forward, sweep 1: per-chunk (mean, M2) of every channel ---------------

template <typename T, int VEC>
__global__ void __launch_bounds__(max_threads(VEC))
    tfk8s_gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, Geom g) {
  extern __shared__ float smem[];
  const int span = g.tcols * VEC;          // channels of a tile
  float* sh_mean = smem;                   // [rows][span]
  float* sh_m2 = smem + g.rows * span;     // [rows][span]
  int b, t, s;
  block_cell(g, b, t, s);
  const int tid = threadIdx.x, lcol = tid % g.tcols, row = tid / g.tcols;
  const int col = t * g.tcols + lcol;
  int p0, p1;
  chunk_range(g, s, p0, p1);
  const int len = p1 - p0;

  float mean[VEC], m2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) mean[e] = m2[e] = 0.f;
  if (col < g.ncol) {
    int n = 0;
    const T* xb = x + (size_t)b * g.hw * g.c + (size_t)col * VEC;
    for (int p = p0 + row; p < p1; p += g.rows) {
      const Pack<T, VEC> v = load<T, VEC>(xb + (size_t)p * g.c);
      ++n;
      const float inv = 1.f / (float)n;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xv = to_f(v.v[e]);
        const float d = xv - mean[e];
        mean[e] += d * inv;
        m2[e] += d * (xv - mean[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sh_mean[row * span + lcol * VEC + e] = mean[e];
    sh_m2[row * span + lcol * VEC + e] = m2[e];
  }
  __syncthreads();

  // each channel: merge the rows in order; row r saw ceil((len - r) / rows)
  // positions
  for (int lch = tid; lch < span && t * span + lch < g.c; lch += blockDim.x) {
    float na = 0.f, ma = 0.f, m2a = 0.f;
    for (int r = 0; r < g.rows; ++r) {
      const float nb = r < len ? (float)((len - r + g.rows - 1) / g.rows) : 0.f;
      chan_merge(na, ma, m2a, nb, sh_mean[r * span + lch], sh_m2[r * span + lch]);
    }
    part[((size_t)b * g.chunks + s) * g.c + t * span + lch] = make_float2(ma, m2a);
  }
}

// The chunk partials of channel ch of sample b merged in order: its (mean,
// M2) over all hw positions.
__device__ __forceinline__ void channel_stats(const float2* __restrict__ part, const Geom& g,
                                              int b, int ch, float& m, float& m2) {
  float na = 0.f, ma = 0.f, m2a = 0.f;
  for (int k = 0; k < g.chunks; ++k) {
    const float2 pm = part[((size_t)b * g.chunks + k) * g.c + ch];
    chan_merge(na, ma, m2a, (float)min(g.chunk, g.hw - k * g.chunk), pm.x, pm.y);
  }
  m = ma;
  m2 = m2a;
}

// ---- forward, step 2: a group's mean and rstd, one block a (sample, group) --

__global__ void __launch_bounds__(kFinalThreads) tfk8s_gn_stats_final_kernel(
    const float2* __restrict__ part, float* __restrict__ mean_out, float* __restrict__ rstd_out,
    Geom g, float eps) {
  __shared__ float sh[32];
  const int b = blockIdx.x / g.groups, gr = blockIdx.x % g.groups, cg = g.cg();
  // its channels all hold hw positions, so the group's merge is the mean
  // of the channel means plus the spread of the means
  float m, m2, msum = 0.f;
  for (int k = threadIdx.x; k < cg; k += blockDim.x) {
    channel_stats(part, g, b, gr * cg + k, m, m2);
    msum += m;
  }
  const float mg = block_sum(msum, sh) / (float)cg;
  float m2sum = 0.f, dev = 0.f;
  for (int k = threadIdx.x; k < cg; k += blockDim.x) {
    channel_stats(part, g, b, gr * cg + k, m, m2);
    const float d = m - mg;
    m2sum += m2;
    dev += d * d;
  }
  m2sum = block_sum(m2sum, sh);
  dev = block_sum(dev, sh);
  if (threadIdx.x == 0) {
    const float m2g = m2sum + (float)g.hw * dev;
    mean_out[(size_t)b * g.groups + gr] = mg;
    rstd_out[(size_t)b * g.groups + gr] = 1.f / sqrtf(m2g / ((float)g.hw * (float)cg) + eps);
  }
}

// ---- forward, sweep 3: normalize, affine, ReLU ------------------------------

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(max_threads(VEC)) tfk8s_gn_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ mean, const float* __restrict__ rstd, T* __restrict__ y, Geom g) {
  int b, t, s;
  block_cell(g, b, t, s);
  const int col = t * g.tcols + (int)threadIdx.x % g.tcols, row = threadIdx.x / g.tcols;
  if (col >= g.ncol) return;
  const int cg = g.cg();
  float mu[VEC], rs[VEC], ga[VEC], be[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = col * VEC + e;
    mu[e] = mean[(size_t)b * g.groups + ch / cg];
    rs[e] = rstd[(size_t)b * g.groups + ch / cg];
    ga[e] = gamma[ch];
    be[e] = beta[ch];
  }
  int p0, p1;
  chunk_range(g, s, p0, p1);
  const size_t base = (size_t)b * g.hw * g.c + (size_t)col * VEC;
  for (int p = p0 + row; p < p1; p += g.rows) {
    const Pack<T, VEC> v = load<T, VEC>(x + base + (size_t)p * g.c);
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float yv = affine(xhat_of(to_f(v.v[e]), mu[e], rs[e]), ga[e], be[e]);
      if (RELU) yv = fmaxf(yv, 0.f);
      o.v[e] = from_f<T>(yv);
    }
    store<T, VEC>(y + base + (size_t)p * g.c, o);
  }
}

// ---- backward, sweep 1: per-chunk sums of dz * xhat and dz per channel -----

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(max_threads(VEC)) tfk8s_gn_bwd_reduce_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ mean,
    const float* __restrict__ rstd, float2* __restrict__ part, Geom g) {
  extern __shared__ float smem[];
  const int span = g.tcols * VEC;
  float* sh_g = smem;                  // [rows][span]: sum dz * xhat
  float* sh_b = smem + g.rows * span;  // [rows][span]: sum dz
  int b, t, s;
  block_cell(g, b, t, s);
  const int tid = threadIdx.x, lcol = tid % g.tcols, row = tid / g.tcols;
  const int col = t * g.tcols + lcol;
  const int cg = g.cg();
  float sg[VEC], sb[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sg[e] = sb[e] = 0.f;
  if (col < g.ncol) {
    float mu[VEC], rs[VEC], ga[VEC], be[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int ch = col * VEC + e;
      mu[e] = mean[(size_t)b * g.groups + ch / cg];
      rs[e] = rstd[(size_t)b * g.groups + ch / cg];
      ga[e] = gamma[ch];
      be[e] = beta[ch];
    }
    int p0, p1;
    chunk_range(g, s, p0, p1);
    const size_t base = (size_t)b * g.hw * g.c + (size_t)col * VEC;
    for (int p = p0 + row; p < p1; p += g.rows) {
      const Pack<T, VEC> vx = load<T, VEC>(x + base + (size_t)p * g.c);
      const Pack<T, VEC> vd = load<T, VEC>(dy + base + (size_t)p * g.c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = xhat_of(to_f(vx.v[e]), mu[e], rs[e]);
        float dz = to_f(vd.v[e]);
        if (RELU && !(affine(xh, ga[e], be[e]) > 0.f)) dz = 0.f;
        sg[e] += dz * xh;
        sb[e] += dz;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sh_g[row * span + lcol * VEC + e] = sg[e];
    sh_b[row * span + lcol * VEC + e] = sb[e];
  }
  __syncthreads();
  for (int lch = tid; lch < span && t * span + lch < g.c; lch += blockDim.x) {
    float tg = 0.f, tb = 0.f;
    for (int r = 0; r < g.rows; ++r) {
      tg += sh_g[r * span + lch];
      tb += sh_b[r * span + lch];
    }
    part[((size_t)b * g.chunks + s) * g.c + t * span + lch] = make_float2(tg, tb);
  }
}

// ---- backward, step 2: per-sample dgamma/dbeta and a group's moments --------

__global__ void __launch_bounds__(kFinalThreads) tfk8s_gn_bwd_final_kernel(
    const float2* __restrict__ part, const float* __restrict__ gamma,
    float* __restrict__ dgamma_b, float* __restrict__ dbeta_b, float2* __restrict__ moments,
    Geom g) {
  __shared__ float sh[32];
  const int b = blockIdx.x / g.groups, gr = blockIdx.x % g.groups, cg = g.cg();
  // s1 = mean of dxhat over the group, s2 = mean of dxhat * xhat, where
  // dxhat = dz * gamma: sum_c gamma_c * (the channel's sums) / n
  float a1 = 0.f, a2 = 0.f;
  for (int k = threadIdx.x; k < cg; k += blockDim.x) {
    const int ch = gr * cg + k;
    float tg = 0.f, tb = 0.f;
    for (int s = 0; s < g.chunks; ++s) {
      const float2 pp = part[((size_t)b * g.chunks + s) * g.c + ch];
      tg += pp.x;
      tb += pp.y;
    }
    dgamma_b[(size_t)b * g.c + ch] = tg;
    dbeta_b[(size_t)b * g.c + ch] = tb;
    a1 += gamma[ch] * tb;
    a2 += gamma[ch] * tg;
  }
  a1 = block_sum(a1, sh);
  a2 = block_sum(a2, sh);
  if (threadIdx.x == 0) {
    const float n = (float)g.hw * (float)cg;
    moments[(size_t)b * g.groups + gr] = make_float2(a1 / n, a2 / n);
  }
}

// ---- backward, sweep 3: dx ---------------------------------------------------

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(max_threads(VEC)) tfk8s_gn_bwd_dx_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float2* __restrict__ moments, T* __restrict__ dx,
    Geom g) {
  int b, t, s;
  block_cell(g, b, t, s);
  const int col = t * g.tcols + (int)threadIdx.x % g.tcols, row = threadIdx.x / g.tcols;
  if (col >= g.ncol) return;
  const int cg = g.cg();
  float mu[VEC], rs[VEC], ga[VEC], be[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = col * VEC + e;
    const size_t bg = (size_t)b * g.groups + ch / cg;
    mu[e] = mean[bg];
    rs[e] = rstd[bg];
    ga[e] = gamma[ch];
    be[e] = beta[ch];
    s1[e] = moments[bg].x;
    s2[e] = moments[bg].y;
  }
  int p0, p1;
  chunk_range(g, s, p0, p1);
  const size_t base = (size_t)b * g.hw * g.c + (size_t)col * VEC;
  for (int p = p0 + row; p < p1; p += g.rows) {
    const Pack<T, VEC> vx = load<T, VEC>(x + base + (size_t)p * g.c);
    const Pack<T, VEC> vd = load<T, VEC>(dy + base + (size_t)p * g.c);
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float xh = xhat_of(to_f(vx.v[e]), mu[e], rs[e]);
      float dz = to_f(vd.v[e]);
      if (RELU && !(affine(xh, ga[e], be[e]) > 0.f)) dz = 0.f;
      const float dxh = dz * ga[e];
      o.v[e] = from_f<T>(rs[e] * (dxh - s1[e] - xh * s2[e]));
    }
    store<T, VEC>(dx + base + (size_t)p * g.c, o);
  }
}

// ============================================================================
// Launchers
// ============================================================================

struct Args {
  const void* x;
  const void* dy;
  const float* gamma;
  const float* beta;
  float* mean;
  float* rstd;
  void* out;           // y (forward) or dx (backward)
  float* dgamma_b;     // [B, C] per-sample partials (backward)
  float* dbeta_b;
  float eps;
  cudaStream_t stream;
  // one read
  Slab s;
  CUtensorMap map_x, map_dy;  // used when s.tma
  // two reads
  float2* part;        // [B, S, C] chunk partials
  float2* moments;     // [B, G] (s1, s2) of each group (backward)
  Geom g;
};

// cuTensorMapEncodeTiled from libcuda, looked up once.
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

// cuTensorMapEncodeTiled is a libcuda call: it needs the device's context
// current on the calling thread. A thread that has made no runtime call
// yet has none (autograd's worker thread, when the caching allocator
// served every tensor of the backward so far); cudaSetDevice binds it.
cudaError_t bind_context() {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  return err == cudaSuccess ? cudaSetDevice(device) : err;
}

// A map of a contiguous [b, hw, c] tensor whose box is [1, rbox, bc]:
// positions past hw read as zeros and move no bytes.
bool make_slab_map(CUtensorMap* map, const void* base, const Slab& s) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)s.c, (cuuint64_t)s.hw, (cuuint64_t)s.b};
  const cuuint64_t strides[2] = {(cuuint64_t)s.c * s.elt, (cuuint64_t)s.hw * s.c * s.elt};
  const cuuint32_t box[3] = {(cuuint32_t)s.bc, (cuuint32_t)s.rbox, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, s.elt == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch `kernel` as clusters of s.k blocks. The first launch of each
// (device, kernel, cluster, threads, shared memory) lifts the kernel's
// shared-memory limit and asks cudaOccupancyMaxActiveClusters whether one
// such cluster can be resident at all; the answer is remembered, and a
// layout the card cannot schedule returns an error instead of hanging.
template <typename... P, typename... A>
cudaError_t launch_cluster(void (*kernel)(P...), const Slab& s, cudaStream_t stream,
                           A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(s.b * s.tiles * s.k));
  cfg.blockDim = dim3((unsigned)s.threads);
  cfg.dynamicSmemBytes = (size_t)s.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)s.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int, int>, cudaError_t> checked;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(device, (const void*)kernel, s.k, s.threads, s.smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = checked.find(key);
    if (it != checked.end()) {
      err = it->second;
    } else {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      int clusters = 0;
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err == cudaSuccess && clusters < 1) err = cudaErrorLaunchOutOfResources;
      checked[key] = err;
    }
  }
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
}

template <typename T, int VEC, bool RELU>
struct Fwd {
  static cudaError_t run(const Args& a) {
    return launch_cluster(tfk8s_gn_fwd_cluster_kernel<T, VEC, RELU>, a.s, a.stream, a.map_x,
                          (const T*)a.x, a.gamma, a.beta, (T*)a.out, a.mean, a.rstd, a.s, a.eps);
  }
};

template <typename T, int VEC, bool RELU>
struct Bwd {
  static cudaError_t run(const Args& a) {
    return launch_cluster(tfk8s_gn_bwd_cluster_kernel<T, VEC, RELU>, a.s, a.stream, a.map_dy,
                          a.map_x, (const T*)a.dy, (const T*)a.x, a.gamma, a.beta,
                          (const float*)a.mean, (const float*)a.rstd, (T*)a.out, a.dgamma_b,
                          a.dbeta_b, a.s);
  }
};

template <typename T, int VEC, bool RELU>
struct Fwd2Pass {
  static cudaError_t run(const Args& a) {
    const Geom& g = a.g;
    const int blocks = g.b * g.tiles * g.chunks, threads = g.rows * g.tcols;
    tfk8s_gn_stats_kernel<T, VEC><<<blocks, threads, 2 * threads * VEC * sizeof(float),
                                    a.stream>>>((const T*)a.x, a.part, g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    tfk8s_gn_stats_final_kernel<<<g.b * g.groups, kFinalThreads, 0, a.stream>>>(
        a.part, a.mean, a.rstd, g, a.eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    tfk8s_gn_norm_kernel<T, VEC, RELU><<<blocks, threads, 0, a.stream>>>(
        (const T*)a.x, a.gamma, a.beta, a.mean, a.rstd, (T*)a.out, g);
    return cudaGetLastError();
  }
};

template <typename T, int VEC, bool RELU>
struct Bwd2Pass {
  static cudaError_t run(const Args& a) {
    const Geom& g = a.g;
    const int blocks = g.b * g.tiles * g.chunks, threads = g.rows * g.tcols;
    tfk8s_gn_bwd_reduce_kernel<T, VEC, RELU>
        <<<blocks, threads, 2 * threads * VEC * sizeof(float), a.stream>>>(
            (const T*)a.dy, (const T*)a.x, a.gamma, a.beta, a.mean, a.rstd, a.part, g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    tfk8s_gn_bwd_final_kernel<<<g.b * g.groups, kFinalThreads, 0, a.stream>>>(
        a.part, a.gamma, a.dgamma_b, a.dbeta_b, a.moments, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    tfk8s_gn_bwd_dx_kernel<T, VEC, RELU><<<blocks, threads, 0, a.stream>>>(
        (const T*)a.dy, (const T*)a.x, a.gamma, a.beta, a.mean, a.rstd, a.moments, (T*)a.out,
        g);
    return cudaGetLastError();
  }
};

// dtype code: 0 = float32, 1 = bfloat16 (the wrapper's _DTYPE_CODES).
template <template <typename, int, bool> class Op>
cudaError_t dispatch(int dtype, int vec, int relu, const Args& a) {
  if (dtype == 0) {
    switch (vec) {
      case 1: return relu ? Op<float, 1, true>::run(a) : Op<float, 1, false>::run(a);
      case 2: return relu ? Op<float, 2, true>::run(a) : Op<float, 2, false>::run(a);
      case 4: return relu ? Op<float, 4, true>::run(a) : Op<float, 4, false>::run(a);
    }
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    switch (vec) {
      case 1: return relu ? Op<B, 1, true>::run(a) : Op<B, 1, false>::run(a);
      case 2: return relu ? Op<B, 2, true>::run(a) : Op<B, 2, false>::run(a);
      case 4: return relu ? Op<B, 4, true>::run(a) : Op<B, 4, false>::run(a);
      case 8: return relu ? Op<B, 8, true>::run(a) : Op<B, 8, false>::run(a);
    }
  }
  return cudaErrorInvalidValue;
}

// The chunks a sample's hw positions are cut into: enough that B * S
// blocks fill the card, each of at least kMinChunk positions, none empty.
int chunk_count(int b, int hw, int* chunk) {
  int s = (kTargetBlocks + b - 1) / b;
  if (s > hw / kMinChunk) s = hw / kMinChunk;
  if (s < 1) s = 1;
  *chunk = (hw + s - 1) / s;
  return (hw + *chunk - 1) / *chunk;
}

// The two-read launch's layout: a thread per VEC channels of a position,
// tiles of at most max_threads(vec) columns, and at least kMinThreads
// threads (several positions at once) when a tile is narrow.
bool make_geom(Geom& g, int b, int hw, int c, int groups, int dtype, const void* const* ptrs,
               int nptrs, int& vec) {
  if (b <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups || (dtype != 0 && dtype != 1))
    return false;
  vec = pick_vec(c, dtype == 0 ? 4 : 2, align_of(ptrs, nptrs));
  g.b = b;
  g.hw = hw;
  g.c = c;
  g.groups = groups;
  g.chunks = chunk_count(b, hw, &g.chunk);
  g.ncol = c / vec;
  g.tcols = g.ncol < max_threads(vec) ? g.ncol : max_threads(vec);
  g.tiles = (g.ncol + g.tcols - 1) / g.tcols;
  g.rows = g.tcols >= kMinThreads ? 1 : kMinThreads / g.tcols;
  // one-dimensional grids
  return (long long)b * g.tiles * g.chunks < (1LL << 31) && (long long)b * groups < (1LL << 31);
}

}  // namespace

extern "C" {

// The blocks of a cluster (1-8) when a launch on [b, hw, c] with `groups`
// groups (dtype code, backward 0 or 1) and tensors whose addresses are all
// multiples of `align` bytes (1, 2, 4, 8 or 16) takes the one-read kernel;
// 0 when it takes the two-read path. The wrapper asks once per shape and
// alignment.
int tfk8s_group_norm_cluster_size(int b, int hw, int c, int groups, int dtype, int backward,
                                  int align) {
  Slab s;
  return plan_slab(s, b, hw, c, groups, dtype, backward, align) ? s.k : 0;
}

// The S of the [B, S, C] float2 partials a two-read launch on [b, hw, C] uses.
int tfk8s_group_norm_chunks(int b, int hw) {
  int chunk;
  return chunk_count(b, hw, &chunk);
}

// Each entry point launches on `stream` and returns the cudaError_t of its
// launches (0 = success). The one-read ones refuse (cudaErrorInvalidValue)
// a launch that tfk8s_group_norm_cluster_size sends to the two-read path.
int tfk8s_group_norm_fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                         void* rstd, int b, int hw, int c, int groups, float eps, int relu,
                         int dtype, void* stream) {
  Args a{};
  const void* ptrs[] = {x, y};
  if (!plan_slab(a.s, b, hw, c, groups, dtype, 0, align_of(ptrs, 2)))
    return (int)cudaErrorInvalidValue;
  if (a.s.tma) {
    const cudaError_t err = bind_context();
    if (err != cudaSuccess) return (int)err;
    if (!make_slab_map(&a.map_x, x, a.s)) return (int)cudaErrorInvalidValue;
  }
  a.x = x;
  a.gamma = (const float*)gamma;
  a.beta = (const float*)beta;
  a.out = y;
  a.mean = (float*)mean;
  a.rstd = (float*)rstd;
  a.eps = eps;
  a.stream = (cudaStream_t)stream;
  return (int)dispatch<Fwd>(dtype, a.s.vec, relu, a);
}

int tfk8s_group_norm_bwd(const void* dy, const void* x, const void* gamma, const void* beta,
                         const void* mean, const void* rstd, void* dx, void* dgamma_b,
                         void* dbeta_b, int b, int hw, int c, int groups, int relu, int dtype,
                         void* stream) {
  Args a{};
  const void* ptrs[] = {dy, x, dx};
  if (!plan_slab(a.s, b, hw, c, groups, dtype, 1, align_of(ptrs, 3)))
    return (int)cudaErrorInvalidValue;
  if (a.s.tma) {
    const cudaError_t err = bind_context();
    if (err != cudaSuccess) return (int)err;
    if (!make_slab_map(&a.map_x, x, a.s) || !make_slab_map(&a.map_dy, dy, a.s))
      return (int)cudaErrorInvalidValue;
  }
  a.dy = dy;
  a.x = x;
  a.gamma = (const float*)gamma;
  a.beta = (const float*)beta;
  a.mean = (float*)mean;
  a.rstd = (float*)rstd;
  a.out = dx;
  a.dgamma_b = (float*)dgamma_b;
  a.dbeta_b = (float*)dbeta_b;
  a.stream = (cudaStream_t)stream;
  return (int)dispatch<Bwd>(dtype, a.s.vec, relu, a);
}

// The two-read path: part is [B, S, C] float2 with S =
// tfk8s_group_norm_chunks(b, hw); moments is [B, G] float2.
int tfk8s_group_norm_fwd_2pass(const void* x, const void* gamma, const void* beta, void* y,
                               void* mean, void* rstd, void* part, int b, int hw, int c,
                               int groups, float eps, int relu, int dtype, void* stream) {
  Args a{};
  const void* ptrs[] = {x, y};
  int vec;
  if (!make_geom(a.g, b, hw, c, groups, dtype, ptrs, 2, vec)) return (int)cudaErrorInvalidValue;
  a.x = x;
  a.gamma = (const float*)gamma;
  a.beta = (const float*)beta;
  a.out = y;
  a.mean = (float*)mean;
  a.rstd = (float*)rstd;
  a.part = (float2*)part;
  a.eps = eps;
  a.stream = (cudaStream_t)stream;
  return (int)dispatch<Fwd2Pass>(dtype, vec, relu, a);
}

int tfk8s_group_norm_bwd_2pass(const void* dy, const void* x, const void* gamma,
                               const void* beta, const void* mean, const void* rstd, void* dx,
                               void* dgamma_b, void* dbeta_b, void* part, void* moments, int b,
                               int hw, int c, int groups, int relu, int dtype, void* stream) {
  Args a{};
  const void* ptrs[] = {dy, x, dx};
  int vec;
  if (!make_geom(a.g, b, hw, c, groups, dtype, ptrs, 3, vec)) return (int)cudaErrorInvalidValue;
  a.dy = dy;
  a.x = x;
  a.gamma = (const float*)gamma;
  a.beta = (const float*)beta;
  a.mean = (float*)mean;
  a.rstd = (float*)rstd;
  a.out = dx;
  a.dgamma_b = (float*)dgamma_b;
  a.dbeta_b = (float*)dbeta_b;
  a.part = (float2*)part;
  a.moments = (float2*)moments;
  a.stream = (cudaStream_t)stream;
  return (int)dispatch<Bwd2Pass>(dtype, vec, relu, a);
}

}  // extern "C"
