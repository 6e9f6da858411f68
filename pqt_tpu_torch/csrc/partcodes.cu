// Kernel P: the build's part codes.  For each (row, part) of x (n, p * vl)
// float32, over the k = c1 * c2 flattened level-2 centroids of the part's
// codebook cb (p, k, vl) float32, with cn (p, k) the centroids' squared
// norms and xn (n, p) the rows' per-part squared norms:
//
//   dot = sum_v x[row, part * vl + v] * cb[part, j, v]   (FMAs in v order)
//   d   = max((xn[row, part] + cn[part, j]) - 2 * dot, 0)
//
// it writes the int64 index j of the least d, the first such j, a NaN
// counting as the least value (torch.argmin's pick).  With k1_build >= c1
// the flat index j is the part code l1 * c2 + l2 itself.
//
// It is not one of the Pallas kernels of the JAX package.  It replaces the
// chain the JAX package leaves to XLA (pqt_tpu/models/db.py:176-200
// encode_part_codes over ops/distance.py part_sqdist_tables), which the
// port ran op by op (ops/distance.py part_codes_plain): a batched GEMM
// writes the (n, p, k) float32 tables, three elementwise passes rewrite
// them (the 2 * dot, the norms' broadcast add, the clamp) and the argmin
// reads them back, 256 MiB a pass at a 65536-row SIFT1B chunk (p 4, k 256).
// Here no table leaves the registers.
//
// Each distance rounds as the plain chain's passes do: the sum xn + cn, the
// exact 2 * dot, the difference, the clamp (a NaN stays NaN).  The dot is
// summed by FMAs in v order, as a SIMT GEMM sums it; cuBLAS's order is not
// known, so a pick can differ from the plain chain's at a near-tie only.
// No tensor core and no TF32.
//
// What bounds it on the H100: fp32 operations, 2 * n * p * k * vl, 64 us at
// 67 TFLOP/s for a SIFT1B chunk (it reads 34 MB: 10 us at 3.35 TB/s).  The
// design is an FFMA GEMM whose epilogue is the argmin:
//
//   * a block takes tiles of kRows rows of one part in turn (a grid-stride
//     loop over the blocks that fit on the card at once), a warp 8 of the
//     tile's rows;
//   * at vl 32 and k 256 (the SIFT presets), the block stages its part's
//     codebook (32 KB, transposed to [v][j]) and norms in shared memory once;
//     each tile stages its rows' segments the same way (8 KB);
//   * each thread keeps an 8 x 8 register tile of rows x centroids (rows 4w +
//     i and 32 + 4w + i of warp w, centroids 4 * lane + j and 128 + 4 *
//     lane + j), summing 32 FMAs a distance from float4 reads of shared
//     memory: the rows' reads are broadcasts, the centroids' contiguous;
//   * the epilogue folds each row's 8 distances into a running (value,
//     index) least, in index order, and the warp halves its rows at each
//     of three shuffles, then reduces the last row over two: ties go to
//     the lower index, a NaN is held as -1, below every clamped distance;
//   * any other vl or k, or an unaligned input, loops over tiles of 32
//     dimensions and 256 centroids, staged with bounds (a centroid's tile
//     by float4 loads where it is whole and aligned, as GIST's vl 240
//     gives); the sums keep their v order.
//
// The launch takes the caller's stream (PyTorch's current one), allocates
// nothing and does not synchronise, so a CUDA graph captures it as it is.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // rows a tile
constexpr int kCents = 256;      // centroids a tile: 32 lanes x 8
constexpr int kDims = 32;        // dimensions a tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// v2 (index i2) before v (index i) in torch.argmin's order, a NaN held as -1
__device__ __forceinline__ void take_min(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// One step of the warp's reduction: of its 2 * kHalf rows, a lane keeps
// rows r + (high ? kHalf : 0), hands the others to the lane `width` away,
// and takes in the least of both lanes' values of each row it keeps.
template <int kHalf>
__device__ __forceinline__ void halve(float* v, int* id, bool high,
                                      int width) {
#pragma unroll
  for (int r = 0; r < kHalf; ++r) {
    float kv = high ? v[r + kHalf] : v[r];
    int ki = high ? id[r + kHalf] : id[r];
    const float sv = high ? v[r] : v[r + kHalf];
    const int si = high ? id[r] : id[r + kHalf];
    take_min(kv, ki, __shfl_xor_sync(kFull, sv, width),
             __shfl_xor_sync(kFull, si, width));
    v[r] = kv;
    id[r] = ki;
  }
}

// Stage dims [k0, k0 + 32) of centroids [c0, c0 + 256) of one part's
// codebook as s_cb[v][c], zeros outside the codebook.
template <bool kFixed>
__device__ __forceinline__ void stage_codebook(float (*s_cb)[kCents],
                                               const float* __restrict__ cb,
                                               int k, int vl, int c0,
                                               int k0) {
  const int t = threadIdx.x;
  if (kFixed) {
    // the centroid t's 32 dims as 8 float4 loads
    const float4* src = reinterpret_cast<const float4*>(cb + t * kDims);
#pragma unroll
    for (int q = 0; q < kDims / 4; ++q) {
      const float4 f = __ldg(src + q);
      s_cb[4 * q][t] = f.x;
      s_cb[4 * q + 1][t] = f.y;
      s_cb[4 * q + 2][t] = f.z;
      s_cb[4 * q + 3][t] = f.w;
    }
  } else {
    // a whole tile of the centroid's dims from a 16-byte boundary as float4
    // loads, else one float at a time
    const int c = c0 + t;
    const float* src = cb + (long long)c * vl + k0;
    if (c < k && k0 + kDims <= vl &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0) {
#pragma unroll
      for (int q = 0; q < kDims / 4; ++q) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src) + q);
        s_cb[4 * q][t] = f.x;
        s_cb[4 * q + 1][t] = f.y;
        s_cb[4 * q + 2][t] = f.z;
        s_cb[4 * q + 3][t] = f.w;
      }
    } else {
#pragma unroll 4
      for (int v = 0; v < kDims; ++v)
        s_cb[v][t] = (c < k && k0 + v < vl) ? __ldg(src + v) : 0.0f;
    }
  }
}

// Stage dims [k0, k0 + 32) of rows [row0, row0 + 64) of one part's
// segments as s_x[v][r], zeros past the rows and the segment.
template <bool kFixed>
__device__ __forceinline__ void stage_rows(float (*s_x)[kRows],
                                           const float* __restrict__ x,
                                           long long n, int d, int vl,
                                           long long row0, int k0) {
  const int t = threadIdx.x;
  const int r = t % kRows;
  const long long row = row0 + r;
  if (kFixed) {
    // 8 float4 a row segment, 2 a thread
    const float4* src =
        reinterpret_cast<const float4*>(x + row * d);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = t / kRows + 4 * i;
      const float4 f = row < n ? __ldg(src + q)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      s_x[4 * q][r] = f.x;
      s_x[4 * q + 1][r] = f.y;
      s_x[4 * q + 2][r] = f.z;
      s_x[4 * q + 3][r] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kDims / (kThreads / kRows); ++i) {
      const int v = t / kRows + (kThreads / kRows) * i;
      s_x[v][r] = (row < n && k0 + v < vl)
                      ? __ldg(x + row * d + k0 + v) : 0.0f;
    }
  }
}

// A block takes the row tiles blockIdx.x, blockIdx.x + gridDim.x, ... of
// part blockIdx.y; two blocks an SM, 128 registers a thread at most.
template <bool kFixed>
__global__ void __launch_bounds__(kThreads, 2)
part_codes_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ cn, const float* __restrict__ xn,
                  long long n, int p, int k, int vl,
                  long long* __restrict__ codes) {
  __shared__ __align__(16) float s_cb[kDims][kCents];
  __shared__ __align__(16) float s_x[kDims][kRows];
  __shared__ __align__(16) float s_cn[kCents];
  const int part = blockIdx.y;
  const int d = p * vl;
  x += (long long)part * vl;
  cb += (long long)part * k * vl;
  cn += (long long)part * k;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long tiles = (n + kRows - 1) / kRows;
  if (kFixed) {
    stage_codebook<true>(s_cb, cb, k, vl, 0, 0);
    s_cn[threadIdx.x] = __ldg(cn + threadIdx.x);
  }
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    float best[8];
    int bidx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      best[i] = inf();
      bidx[i] = 4 * lane;   // a row of +inf (or no row) picks index 0
    }
    for (int c0 = 0; c0 < k; c0 += kCents) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < vl; k0 += kDims) {
        __syncthreads();               // the last tile's reads are done
        if (!kFixed) {
          stage_codebook<false>(s_cb, cb, k, vl, c0, k0);
          if (k0 == 0)
            s_cn[threadIdx.x] = c0 + (int)threadIdx.x < k
                                    ? __ldg(cn + c0 + threadIdx.x) : 0.0f;
        }
        stage_rows<kFixed>(s_x, x, n, d, vl, row0, k0);
        __syncthreads();
#pragma unroll
        for (int v = 0; v < kDims; ++v) {
          const float4 a0 = *reinterpret_cast<const float4*>(
              &s_x[v][4 * warp]);
          const float4 a1 = *reinterpret_cast<const float4*>(
              &s_x[v][32 + 4 * warp]);
          const float4 b0 = *reinterpret_cast<const float4*>(
              &s_cb[v][4 * lane]);
          const float4 b1 = *reinterpret_cast<const float4*>(
              &s_cb[v][128 + 4 * lane]);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
        }
      }
      // the epilogue: this thread's 8 centroids of each row, in index order
      float c[8];
      {
        const float4 c0v = *reinterpret_cast<const float4*>(
            &s_cn[4 * lane]);
        const float4 c1v = *reinterpret_cast<const float4*>(
            &s_cn[128 + 4 * lane]);
        c[0] = c0v.x; c[1] = c0v.y; c[2] = c0v.z; c[3] = c0v.w;
        c[4] = c1v.x; c[5] = c1v.y; c[6] = c1v.z; c[7] = c1v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long row = row0 + (i < 4 ? 4 * warp + i
                                            : 32 + 4 * warp + i - 4);
        const float xr = row < n ? __ldg(xn + row * p + part) : 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + (j < 4 ? 4 * lane + j : 128 + 4 * lane + j - 4);
          if (!kFixed && col >= k) continue;
          const float dd = __fsub_rn(__fadd_rn(xr, c[j]),
                                     __fmul_rn(2.0f, acc[i][j]));
          const float v = dd != dd ? -1.0f : fmaxf(dd, 0.0f);
          if (v < best[i]) {
            best[i] = v;
            bidx[i] = col;
          }
        }
      }
    }
    // the warp's least of each row: 8 rows a lane, halved at each of three
    // shuffles (lanes 16 apart, then 8, then 4), then two more for the last
    halve<4>(best, bidx, lane & 16, 16);
    halve<2>(best, bidx, lane & 8, 8);
    halve<1>(best, bidx, lane & 4, 4);
    take_min(best[0], bidx[0], __shfl_xor_sync(kFull, best[0], 2),
             __shfl_xor_sync(kFull, bidx[0], 2));
    take_min(best[0], bidx[0], __shfl_xor_sync(kFull, best[0], 1),
             __shfl_xor_sync(kFull, bidx[0], 1));
    if (lane % 4 == 0) {
      const int i = (lane & 16 ? 4 : 0) + (lane & 8 ? 2 : 0) +
                    (lane & 4 ? 1 : 0);
      const long long row = row0 + (i < 4 ? 4 * warp + i
                                          : 32 + 4 * warp + i - 4);
      if (row < n) codes[row * p + part] = bidx[0];
    }
  }
}

}  // namespace

// x (n, p * vl), cb (p, k, vl), cn (p, k), xn (n, p) float32, contiguous;
// codes (n, p) int64.  Returns cudaGetLastError() after the launch (0:
// launched).
extern "C" int pqt_part_codes(const float* x, const float* cb,
                              const float* cn, const float* xn, long long n,
                              int p, int k, int vl, long long* codes,
                              void* stream) {
  if (n <= 0 || p <= 0 || k <= 0 || vl <= 0 || p > 65535 ||
      (long long)p * vl > INT_MAX || (long long)p * k * vl > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool fixed = vl == kDims && k == kCents &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = fixed ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, part_codes_kernel<true>, kThreads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, part_codes_kernel<false>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // the resident blocks shared among the parts, then as few blocks as
  // take the same number of tiles each
  const long long tiles = (n + kRows - 1) / kRows;
  long long want = ((long long)sms * (per_sm > 0 ? per_sm : 1) + p - 1) / p;
  if (want > tiles) want = tiles;
  const long long per_block = (tiles + want - 1) / want;
  const long long blocks = (tiles + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)p);
  cudaStream_t s = (cudaStream_t)stream;
  if (fixed)
    part_codes_kernel<true><<<grid, kThreads, 0, s>>>(x, cb, cn, xn, n, p, k,
                                                      vl, codes);
  else
    part_codes_kernel<false><<<grid, kThreads, 0, s>>>(x, cb, cn, xn, n, p,
                                                       k, vl, codes);
  return (int)cudaGetLastError();
}
