// Fused NHWC GroupNorm + affine + optional ReLU for Hopper (sm_90a),
// forward and backward, behind a plain C interface loaded with ctypes
// (tfk8s_tpu_torch/ops/_build.py builds this file with nvcc).
//
// Replaces the Pallas TPU kernels of tfk8s_tpu/ops/group_norm.py:
//   tfk8s_group_norm_fwd <- _fwd_kernel (:68, launched by _fwd_impl :98)
//   tfk8s_group_norm_bwd <- _bwd_kernel (:137, launched by _bwd_impl :184)
//
// Contract (the same as the plain PyTorch versions in group_norm.py):
// x, dy, y, dx are contiguous [B, H*W, C] (NHWC) float32 or bfloat16, any
// C; groups are contiguous channel blocks of C / G; gamma, beta are [C]
// float32; mean and rstd are [B, G] float32. Statistics are float32 with
// the biased variance and eps inside the square root:
//   y = ((x - mean) * rstd) * gamma + beta, then max(y, 0) if relu,
// evaluated with separately rounded float32 operations (no fused
// multiply-add), exactly as the plain version's PyTorch ops do, so the
// backward's ReLU mask is the forward's bit for bit.
//
// What bounds it. Every pass over [B, H*W, C] is elementwise with a
// per-(sample, group) reduction: memory-bound. The bound counts each input
// read once and each output written once (bfloat16: 4 bytes a value
// forward, 6 backward). The Pallas kernel keeps one whole sample in VMEM
// and so reads x once; a [56, 56, 256] bfloat16 sample is 1.6 MB against
// 227 KB of shared memory here, so this first version reads x twice in
// the forward (statistics, then normalize) and dy, x twice in the backward
// (sums, then dx): 6 and 10 bytes a value in bfloat16, 1.5 and 1.67 times
// the bound's traffic. Holding a sample in the shared memory of a
// thread-block cluster would read it once; that is later work.
//
// Layout of a launch. Each direction is three kernels:
//   1. a sweep over x (and dy) that writes per-channel partials of each
//      chunk of positions: [B, S, C] float2;
//   2. a small kernel, one block per (sample, group), that merges a group's
//      partials: mean and rstd forward; the group's two moments and the
//      per-sample dgamma, dbeta backward;
//   3. a sweep that writes y (dx).
// The sweeps' blocks each take one (sample, channel tile, chunk): a
// sample's H*W positions are cut into S chunks of contiguous positions so
// that the blocks fill the card (one block a sample would leave the second
// wave of 256 samples on 132 SMs half empty), and C into tiles of at most
// 2048 channels, so any C runs. Inside a block each thread owns VEC
// consecutive channels (16-byte loads: 8 bfloat16 or 4 float32 values) of
// every rows-th position of the chunk; neighbouring threads read
// neighbouring 16 bytes of a position, so a warp reads whole positions.
// Every rule of this layout lives in this file (make_geom, chunk_count);
// the wrapper asks tfk8s_group_norm_chunks for the size of the partials.
//
// Numerics. Each thread keeps a Welford (count, mean, M2) per channel over
// its positions; rows are merged with Chan's formula in a fixed order, then
// the S chunk partials of a channel, then the channels of a group by their
// exact equal-count merge (mean of means plus the spread of the means).
// There is no one-pass E[x^2] - mean^2 (which cancels catastrophically
// when |mean| >> std) and no float atomic: every sum runs in a fixed order,
// so every output repeats bit for bit from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---- launchers -----------------------------------------------------------

struct Args {
  const void* x;
  const void* dy;
  const float* gamma;
  const float* beta;
  float* mean;
  float* rstd;
  void* out;           // y (forward) or dx (backward)
  float2* part;        // [B, S, C] chunk partials
  float2* moments;     // [B, G] (s1, s2) of each group (backward)
  float* dgamma_b;     // [B, C] per-sample partials (backward)
  float* dbeta_b;
  Geom g;
  float eps;
  cudaStream_t stream;
};

template <typename T, int VEC, bool RELU>
struct Fwd {
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
struct Bwd {
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

// The widest load of at most 16 bytes that divides C and keeps every
// pointer aligned.
int pick_vec(int c, int elt, const void* const* ptrs, int nptrs) {
  int vec = 16 / elt;
  for (;;) {
    bool ok = c % vec == 0;
    for (int i = 0; ok && i < nptrs; ++i) ok = (uintptr_t)ptrs[i] % (vec * elt) == 0;
    if (ok || vec == 1) return vec;
    vec /= 2;
  }
}

// The launch's layout: a thread per VEC channels of a position, tiles of
// at most max_threads(vec) columns, and at least kMinThreads threads
// (several positions at once) when a tile is narrow.
bool make_geom(Geom& g, int b, int hw, int c, int groups, int dtype, const void* const* ptrs,
               int nptrs, int& vec) {
  if (b <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups || (dtype != 0 && dtype != 1))
    return false;
  vec = pick_vec(c, dtype == 0 ? 4 : 2, ptrs, nptrs);
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

// The S of the [B, S, C] float2 partials a launch on [b, hw, C] uses.
int tfk8s_group_norm_chunks(int b, int hw) {
  int chunk;
  return chunk_count(b, hw, &chunk);
}

// Each entry point launches its three kernels on `stream` and returns the
// cudaError_t of the launches (0 = success). part is [B, S, C] float2
// with S = tfk8s_group_norm_chunks(b, hw); moments is [B, G] float2.
int tfk8s_group_norm_fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                         void* rstd, void* part, int b, int hw, int c, int groups, float eps,
                         int relu, int dtype, void* stream) {
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
  return (int)dispatch<Fwd>(dtype, vec, relu, a);
}

int tfk8s_group_norm_bwd(const void* dy, const void* x, const void* gamma, const void* beta,
                         const void* mean, const void* rstd, void* dx, void* dgamma_b,
                         void* dbeta_b, void* part, void* moments, int b, int hw, int c,
                         int groups, int relu, int dtype, void* stream) {
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
  return (int)dispatch<Bwd>(dtype, vec, relu, a);
}

}  // extern "C"
