// Kernel A: per-row top-k (smallest first) by a bitonic sort in shared memory.
//
// Replaces the TPU kernel pqt_tpu/ops/pallas/primitives.py:bitonic_topk,
// which sorts 8 rows per grid step in VMEM and compares values only, so its
// order among equal values is arbitrary.  Here one block sorts one row of
// (value, index) pairs ordered lexicographically: ties come out lowest index
// first, which is the order of lax.top_k and of a stable ascending sort.  The
// port's bin enumeration therefore matches the JAX package bit for bit.
//
// Inputs are never NaN: they are distances, or +inf for masked slots.  A row
// of any length n <= 16384 is padded inside the kernel to the next power of
// two with (+inf, n + i), which sorts after every real element, real +inf
// included.
//
// What bounds it on the H100: the minimum traffic is one read of the row and
// one write of k pairs, so the bound is bytes at 3.35 TB/s.  The full sort
// does O(n log^2 n) compare-exchanges in shared memory, which is what keeps it
// above that bound.  The design keeps the whole row in shared memory (8 bytes
// an element, 128 KB at n = 16384, taken as dynamic shared memory) so no
// stage of the network touches device memory; a network that stops once the
// first k are final is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ bool pair_after(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia > ib);
}

__global__ void bitonic_topk_kernel(const float* __restrict__ x, int n,
                                    int padded, int k,
                                    float* __restrict__ out_v,
                                    int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* sv = smem;
  int* si = reinterpret_cast<int*>(smem + padded);
  const size_t row = blockIdx.x;
  const float* xr = x + row * n;
  for (int t = threadIdx.x; t < padded; t += blockDim.x) {
    sv[t] = t < n ? xr[t] : INFINITY;
    si[t] = t;
  }
  __syncthreads();
  const int half = padded >> 1;
  for (int size = 2; size <= padded; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));   // bit `stride` cleared
        const int j = i + stride;
        const bool ascending = (i & size) == 0;
        const float vi = sv[i], vj = sv[j];
        const int ii = si[i], ij = si[j];
        if (pair_after(vi, ii, vj, ij) == ascending) {
          sv[i] = vj;
          sv[j] = vi;
          si[i] = ij;
          si[j] = ii;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    out_v[row * k + t] = sv[t];
    out_i[row * k + t] = si[t];
  }
}

}  // namespace

// Longest row one block sorts (the wrapper's TOPK_MAX_ROW).
constexpr int kMaxRow = 16384;
constexpr int kMaxDevices = 64;

// x: (rows, n) float32, 1 <= k <= n <= kMaxRow.  Writes (rows, k) values and
// int32 column indices.  Returns the CUDA error code of the launch (0 =
// success).  The dynamic shared-memory limit is raised once per device, to
// what the longest row needs, not on every launch.
extern "C" int pqt_bitonic_topk(const float* x, int rows, int n, int k,
                                float* out_v, int* out_i, void* stream) {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (n > kMaxRow || dev >= kMaxDevices) return (int)cudaErrorInvalidValue;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        bitonic_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kMaxRow * (sizeof(float) + sizeof(int))));
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  int padded = 2;
  while (padded < n) padded <<= 1;
  const size_t smem = (size_t)padded * (sizeof(float) + sizeof(int));
  const int threads = padded / 2 < 1024 ? padded / 2 : 1024;
  bitonic_topk_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
      x, n, padded, k, out_v, out_i);
  return (int)cudaGetLastError();
}
