// Flash attention on the CUDA cores (sm_90a): the float32 forward, dq and
// dk/dv kernels (FlashAttention-2's loops), behind a plain C interface
// loaded with ctypes (tfk8s_tpu_torch/ops/_build.py builds this file with
// nvcc). Every bfloat16 kernel runs on the tensor cores:
// flash_attention_sm90.cu.
//
// Replaces, for float32 inputs, the Pallas TPU kernels of
// tfk8s_tpu/ops/flash_attention.py:
//   tfk8s_fwd_simt_kernel <- _fwd_kernel     (:149, launched by _flash_fwd_impl :424)
//   tfk8s_dq_simt_kernel  <- _bwd_dq_kernel  (:233, launched by _flash_bwd_impl :451)
//   tfk8s_dkv_simt_kernel <- _bwd_dkv_kernel (:290, launched by _flash_bwd_impl :469)
//
// Contract (the same as the plain PyTorch versions in flash_attention.py):
// q/k/v/do/o are contiguous [b, l, h, d] float32 tensors, q pre-scaled by
// 1/sqrt(d); the optional mask is [b, lk] uint8 key validity; causal
// masking is bottom-right aligned (query i sees keys <= i + lk - lq);
// every probability of a masked (query, key) pair is exactly zero, so a
// row whose keys are all masked gives zero output and zero gradients.
// lse is the per-row logsumexp, [b, h, lq] float32.
//
// What bounds them. float32 FMA and shared-memory issue on the CUDA cores:
// they keep float32 exact (TF32 would not be), which is what the float32
// parity checks hold them to. The design keeps the flash property that
// matters most: no [lq, lk] matrix ever reaches device memory, each K/V
// (or Q/dO) tile is staged once per block in shared memory and read by
// every row of the block, and the tiles above the causal diagonal are
// never visited. dq and dk/dv compute D = rowsum(dO * O) themselves, as
// the reference's kernels do.
//
// Layout of a block. A block owns 64 rows (query rows in fwd/dq, key rows
// in dk/dv); each row is held by a group of TPR = d/32 threads (1 for
// d <= 32), each thread keeping DPT = d/TPR of the row's dims in
// registers, interleaved in float4 chunks so that a group's reads of one
// staged row hit distinct banks and the other groups' reads of the same
// row are broadcasts. A dot product over d is DPT FMAs per thread plus a
// butterfly shuffle inside the group. Nothing is reduced across blocks:
// dq is one block per q tile, dk/dv one block per k tile (the reference's
// no-atomics design).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // _NEG of the reference
constexpr int kRows = 64;       // rows owned by one block
constexpr int kChunk = 16;      // keys per online-softmax rescale (fwd)

template <int D>
struct Cfg {
  static constexpr int DPT = D < 32 ? D : 32;  // dims per thread
  static constexpr int TPR = D / DPT;          // threads per row
  static constexpr int THREADS = kRows * TPR;
  static constexpr int NV4 = DPT / 4;          // float4 chunks per thread
  // rows of a staged tile: 2 tiles of TILE x D floats stay at <= 32 KB
  static constexpr int TILE = (4096 / D) < 64 ? (4096 / D) : 64;
  static_assert(D % 16 == 0 && D <= 128, "head_dim must be 16, 32, 64 or 128");
  static_assert(TILE % kChunk == 0, "tile must hold whole chunks");
};

// Sum over the TPR consecutive lanes that hold one row; every lane of the
// group gets the total. All lanes of the warp must call it.
template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The dims a thread owns: float4 chunk c of lane g in its group covers
// dims 4 * (TPR * c + g) .. +3.
template <int D>
__device__ __forceinline__ int dim_of(int c, int g) {
  return 4 * (Cfg<D>::TPR * c + g);
}

// Registers <- one global row (zeros when the row does not exist).
template <int D>
__device__ __forceinline__ void load_row(float* dst, const float* row, bool ok, int g) {
#pragma unroll
  for (int c = 0; c < Cfg<D>::NV4; ++c) {
    const int d0 = dim_of<D>(c, g);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[4 * c + e] = ok ? row[d0 + e] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* row, const float* src, float scale, int g) {
#pragma unroll
  for (int c = 0; c < Cfg<D>::NV4; ++c) {
    const int d0 = dim_of<D>(c, g);
#pragma unroll
    for (int e = 0; e < 4; ++e) row[d0 + e] = src[4 * c + e] * scale;
  }
}

// Dot product of a thread's register slice with its dims of a staged row.
template <int D>
__device__ __forceinline__ float dot_part(const float* x, const float* srow, int g) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < Cfg<D>::NV4; ++c) {
    const float4 y = s4[Cfg<D>::TPR * c + g];
    acc = fmaf(x[4 * c + 0], y.x, acc);
    acc = fmaf(x[4 * c + 1], y.y, acc);
    acc = fmaf(x[4 * c + 2], y.z, acc);
    acc = fmaf(x[4 * c + 3], y.w, acc);
  }
  return acc;
}

// acc += a * (a thread's dims of a staged row)
template <int D>
__device__ __forceinline__ void axpy_part(float* acc, float a, const float* srow, int g) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
#pragma unroll
  for (int c = 0; c < Cfg<D>::NV4; ++c) {
    const float4 y = s4[Cfg<D>::TPR * c + g];
    acc[4 * c + 0] = fmaf(a, y.x, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(a, y.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(a, y.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(a, y.w, acc[4 * c + 3]);
  }
}

// Shared tile <- rows [0, nrows) of a [., h, D] slab (token stride tok);
// missing rows are zero.
template <int D>
__device__ __forceinline__ void stage(float (*dst)[D], const float* src, long long tok, int nrows) {
  constexpr int TILE = Cfg<D>::TILE;
  for (int i = threadIdx.x; i < TILE * D; i += Cfg<D>::THREADS) {
    const int r = i / D, c = i % D;
    dst[r][c] = r < nrows ? src[r * tok + c] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int key, int lk, int qpos, bool causal,
                                        const uint8_t* mrow) {
  return key < lk && (!causal || key <= qpos) && (mrow == nullptr || mrow[key] != 0);
}

// -- forward -----------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
tfk8s_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ mask,
                      float* __restrict__ o, float* __restrict__ lse, int lq, int lk, int h,
                      int causal) {
  using C = Cfg<D>;
  __shared__ __align__(16) float ks[C::TILE][D];
  __shared__ __align__(16) float vs[C::TILE][D];

  const int bh = blockIdx.x, bi = bh / h, hi = bh % h;
  const int r = threadIdx.x / C::TPR, g = threadIdx.x % C::TPR;
  const int q0 = blockIdx.y * kRows, qi = q0 + r;
  const bool row_ok = qi < lq;
  const long long tok = (long long)h * D;
  const int offset = lk - lq;
  const int qpos = offset + qi;  // causal: keys <= qpos are visible
  const uint8_t* mrow = mask ? mask + (long long)bi * lk : nullptr;

  float qr[C::DPT], acc[C::DPT];
  load_row<D>(qr, q + ((long long)bi * lq + qi) * tok + (long long)hi * D, row_ok, g);
#pragma unroll
  for (int i = 0; i < C::DPT; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  // tiles past the last visible key of the block's last row are skipped
  const int kend = causal ? min(lk, offset + min(q0 + kRows, lq)) : lk;
  const float* kb = k + (long long)bi * lk * tok + (long long)hi * D;
  const float* vb = v + (long long)bi * lk * tok + (long long)hi * D;

  for (int t0 = 0; t0 < kend; t0 += C::TILE) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(ks, kb + t0 * tok, tok, min(C::TILE, lk - t0));
    stage<D>(vs, vb + t0 * tok, tok, min(C::TILE, lk - t0));
    __syncthreads();
    for (int j0 = 0; j0 < C::TILE; j0 += kChunk) {
      float s[kChunk];
      unsigned ok = 0;
      float cmax = kNeg;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int key = t0 + j0 + jj;
        const float dot = group_sum<C::TPR>(dot_part<D>(qr, ks[j0 + jj], g));
        const bool vis = row_ok && visible(key, lk, qpos, causal, mrow);
        ok |= (unsigned)vis << jj;
        s[jj] = vis ? dot : kNeg;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < C::DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = (ok >> jj) & 1u ? expf(s[jj] - m_new) : 0.f;
        l += p;
        axpy_part<D>(acc, p, vs[j0 + jj], g);
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float ls = fmaxf(l, 1e-30f);
    store_row<D>(o + ((long long)bi * lq + qi) * tok + (long long)hi * D, acc, 1.f / ls, g);
    if (lse != nullptr && g == 0) lse[(long long)bh * lq + qi] = m + logf(ls);
  }
}

// -- backward: dq --------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
tfk8s_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ o, const float* __restrict__ lse,
                     const uint8_t* __restrict__ mask, float* __restrict__ dq, int lq, int lk,
                     int h, int causal) {
  using C = Cfg<D>;
  __shared__ __align__(16) float ks[C::TILE][D];
  __shared__ __align__(16) float vs[C::TILE][D];

  const int bh = blockIdx.x, bi = bh / h, hi = bh % h;
  const int r = threadIdx.x / C::TPR, g = threadIdx.x % C::TPR;
  const int q0 = blockIdx.y * kRows, qi = q0 + r;
  const bool row_ok = qi < lq;
  const long long tok = (long long)h * D;
  const long long row_off = ((long long)bi * lq + qi) * tok + (long long)hi * D;
  const int offset = lk - lq;
  const int qpos = offset + qi;
  const uint8_t* mrow = mask ? mask + (long long)bi * lk : nullptr;

  float qr[C::DPT], dor[C::DPT], acc[C::DPT];
  load_row<D>(qr, q + row_off, row_ok, g);
  load_row<D>(dor, dout + row_off, row_ok, g);
  // D = rowsum(dO * O), computed here from the row as the reference does;
  // acc holds the row of O until the key loop needs it as dq
  load_row<D>(acc, o + row_off, row_ok, g);
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < C::DPT; ++i) part = fmaf(dor[i], acc[i], part);
  const float dsum = group_sum<C::TPR>(part);
#pragma unroll
  for (int i = 0; i < C::DPT; ++i) acc[i] = 0.f;
  const float L = row_ok ? lse[(long long)bh * lq + qi] : 0.f;

  const int kend = causal ? min(lk, offset + min(q0 + kRows, lq)) : lk;
  const float* kb = k + (long long)bi * lk * tok + (long long)hi * D;
  const float* vb = v + (long long)bi * lk * tok + (long long)hi * D;

  for (int t0 = 0; t0 < kend; t0 += C::TILE) {
    __syncthreads();
    stage<D>(ks, kb + t0 * tok, tok, min(C::TILE, lk - t0));
    stage<D>(vs, vb + t0 * tok, tok, min(C::TILE, lk - t0));
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < C::TILE; ++j) {
      const int key = t0 + j;
      const float s = group_sum<C::TPR>(dot_part<D>(qr, ks[j], g));
      const float dp = group_sum<C::TPR>(dot_part<D>(dor, vs[j], g));
      const bool vis = row_ok && visible(key, lk, qpos, causal, mrow);
      const float p = vis ? expf(s - L) : 0.f;
      axpy_part<D>(acc, p * (dp - dsum), ks[j], g);
    }
  }
  if (row_ok) store_row<D>(dq + row_off, acc, 1.f, g);
}

// -- backward: dk, dv ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
tfk8s_dkv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ o, const float* __restrict__ lse,
                      const uint8_t* __restrict__ mask, float* __restrict__ dk,
                      float* __restrict__ dv, int lq, int lk, int h, int causal) {
  using C = Cfg<D>;
  __shared__ __align__(16) float qs[C::TILE][D];
  __shared__ __align__(16) float dos[C::TILE][D];
  __shared__ float lse_s[C::TILE];
  __shared__ float dsum_s[C::TILE];

  const int bh = blockIdx.x, bi = bh / h, hi = bh % h;
  const int r = threadIdx.x / C::TPR, g = threadIdx.x % C::TPR;
  const int k0 = blockIdx.y * kRows, kj = k0 + r;
  const long long tok = (long long)h * D;
  const int offset = lk - lq;
  // a key row takes part only if it exists and the mask lets it be seen
  const bool key_ok = kj < lk && (mask == nullptr || mask[(long long)bi * lk + kj] != 0);
  const long long krow = ((long long)bi * lk + kj) * tok + (long long)hi * D;

  float kr[C::DPT], vr[C::DPT], dka[C::DPT], dva[C::DPT];
  load_row<D>(kr, k + krow, kj < lk, g);
  load_row<D>(vr, v + krow, kj < lk, g);
#pragma unroll
  for (int i = 0; i < C::DPT; ++i) dka[i] = dva[i] = 0.f;

  // first query row that sees key k0 is k0 - offset; earlier tiles skipped
  const int qstart = causal ? max(0, k0 - offset) / C::TILE * C::TILE : 0;
  const float* qb = q + (long long)bi * lq * tok + (long long)hi * D;
  const float* dob = dout + (long long)bi * lq * tok + (long long)hi * D;
  const float* ob = o + (long long)bi * lq * tok + (long long)hi * D;

  for (int t0 = qstart; t0 < lq; t0 += C::TILE) {
    const int nrows = min(C::TILE, lq - t0);
    __syncthreads();
    stage<D>(qs, qb + t0 * tok, tok, nrows);
    stage<D>(dos, dob + t0 * tok, tok, nrows);
    __syncthreads();
    {
      // D = rowsum(dO * O) for the tile's rows: group r takes row r
      // (a tile has at most as many rows as the block has groups)
      const bool have = r < C::TILE && r < nrows;
      float orow[C::DPT];
      load_row<D>(orow, ob + (long long)(t0 + r) * tok, have, g);
      const float part = have ? dot_part<D>(orow, dos[r < C::TILE ? r : 0], g) : 0.f;
      const float tot = group_sum<C::TPR>(part);
      if (r < C::TILE && g == 0) {
        dsum_s[r] = tot;
        lse_s[r] = have ? lse[(long long)bh * lq + t0 + r] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < C::TILE; ++i) {
      const int qrow = t0 + i;
      const float s = group_sum<C::TPR>(dot_part<D>(kr, qs[i], g));
      const float dp = group_sum<C::TPR>(dot_part<D>(vr, dos[i], g));
      const bool vis = key_ok && qrow < lq && (!causal || kj <= offset + qrow);
      const float p = vis ? expf(s - lse_s[i]) : 0.f;
      axpy_part<D>(dva, p, dos[i], g);
      axpy_part<D>(dka, p * (dp - dsum_s[i]), qs[i], g);
    }
  }
  if (kj < lk) {
    store_row<D>(dk + krow, dka, 1.f, g);
    store_row<D>(dv + krow, dva, 1.f, g);
  }
}

// -- launch --------------------------------------------------------------------

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                       void* lse, int b, int lq, int lk, int h, int causal, cudaStream_t st) {
  dim3 grid(b * h, (lq + kRows - 1) / kRows);
  tfk8s_fwd_simt_kernel<D><<<grid, Cfg<D>::THREADS, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const uint8_t*)mask, (float*)o,
      (float*)lse, lq, lk, h, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* o, const void* lse, const void* mask, void* dq, int b, int lq,
                      int lk, int h, int causal, cudaStream_t st) {
  dim3 grid(b * h, (lq + kRows - 1) / kRows);
  tfk8s_dq_simt_kernel<D><<<grid, Cfg<D>::THREADS, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)o,
      (const float*)lse, (const uint8_t*)mask, (float*)dq, lq, lk, h, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* o, const void* lse, const void* mask, void* dk, void* dv,
                       int b, int lq, int lk, int h, int causal, cudaStream_t st) {
  dim3 grid(b * h, (lk + kRows - 1) / kRows);
  tfk8s_dkv_simt_kernel<D><<<grid, Cfg<D>::THREADS, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)o,
      (const float*)lse, (const uint8_t*)mask, (float*)dk, (float*)dv, lq, lk, h, causal);
  return cudaGetLastError();
}

#define TFK8S_BY_HEAD_DIM(FN, ...)                \
  do {                                            \
    switch (d) {                                  \
      case 16: return (int)FN<16>(__VA_ARGS__);   \
      case 32: return (int)FN<32>(__VA_ARGS__);   \
      case 64: return (int)FN<64>(__VA_ARGS__);   \
      case 128: return (int)FN<128>(__VA_ARGS__); \
    }                                             \
    return (int)cudaErrorInvalidValue;            \
  } while (0)

}  // namespace

// Each entry point takes float32 tensors and returns the cudaError_t of
// its launch (0 = success).
extern "C" {

int tfk8s_flash_fwd_simt(const void* q, const void* k, const void* v, const void* mask, void* o,
                         void* lse, int b, int lq, int lk, int h, int d, int causal,
                         void* stream) {
  TFK8S_BY_HEAD_DIM(launch_fwd, q, k, v, mask, o, lse, b, lq, lk, h, causal,
                    (cudaStream_t)stream);
}

int tfk8s_flash_bwd_dq_simt(const void* q, const void* k, const void* v, const void* dout,
                            const void* o, const void* lse, const void* mask, void* dq, int b,
                            int lq, int lk, int h, int d, int causal, void* stream) {
  TFK8S_BY_HEAD_DIM(launch_dq, q, k, v, dout, o, lse, mask, dq, b, lq, lk, h, causal,
                    (cudaStream_t)stream);
}

int tfk8s_flash_bwd_dkv_simt(const void* q, const void* k, const void* v, const void* dout,
                             const void* o, const void* lse, const void* mask, void* dk, void* dv,
                             int b, int lq, int lk, int h, int d, int causal, void* stream) {
  TFK8S_BY_HEAD_DIM(launch_dkv, q, k, v, dout, o, lse, mask, dk, dv, b, lq, lk, h, causal,
                    (cudaStream_t)stream);
}

}  // extern "C"
