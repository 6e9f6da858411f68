// Kernel C: line re-rank, reconstructing approximate squared distances from
// the packed payload rows of the gathered candidates.
//
// Replaces the TPU kernel pqt_tpu/ops/pallas/rerank.py:rerank_fused.  That
// kernel needs the rows transposed to (B, W, K) and the tables lane-padded
// to 128, because Mosaic can only gather along lanes.  Here the rows come
// row-major (B, K, W), exactly as the payload-row gather yields them, and the
// query's (lp, c1) table sits in shared memory, where any index is a plain
// load.  Per candidate and line part j:
//
//   d = t3 + sum_j (1 - lam_j) * q[j, A_j] + lam_j * q[j, B_j]
//
// Compact rows only (c1 <= 16, lp <= 32): word 1 is t3's float bits, word
// 2 + j/2 holds line part j in its (j % 2)-th 16-bit half as
// A | B << 4 | lam_u8 << 8, lam = lam_u8 * 8/256 - 4.  The wide layout
// (c1 > 16) is left to the slice that serves such configs.
//
// Grid (ceil(K / 256), B): one thread per candidate, the ragged K tail
// masked, so K need not be a multiple of anything.
//
// What bounds it on the H100: bytes.  Each candidate's W words are read
// once and one float is written (40 + 4 bytes at lp = 16), against about
// 4 * lp flops; the table is 1 KB per query.  Each thread reads its own
// 40-byte row, so a warp's loads are not coalesced into full lines; staging
// the rows of a block through shared memory with coalesced loads, or fusing
// the payload-row gather in, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void rerank_kernel(const int* __restrict__ rows,
                              const float* __restrict__ q, int K, int W,
                              int lp, int c1, float* __restrict__ out) {
  extern __shared__ float qs[];
  const size_t b = blockIdx.y;
  const float* qb = q + b * lp * c1;
  for (int t = threadIdx.x; t < lp * c1; t += blockDim.x) qs[t] = qb[t];
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int* r = rows + (b * K + k) * W;
  float acc = __int_as_float(r[1]);
  for (int j = 0; j < lp; ++j) {
    const unsigned half = ((unsigned)r[2 + (j >> 1)] >> (16 * (j & 1))) &
                          0xFFFFu;
    const unsigned a = half & 0xFu;
    const unsigned bb = (half >> 4) & 0xFu;
    const float lam = (float)((half >> 8) & 0xFFu) * 0.03125f - 4.0f;
    acc += (1.0f - lam) * qs[j * c1 + a] + lam * qs[j * c1 + bb];
  }
  out[b * K + k] = acc;
}

}  // namespace

// rows: (B, K, W) int32; q: (B, lp, c1) float32; out: (B, K) float32.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int pqt_rerank_fused(const int* rows, const float* q, int B, int K,
                                int W, int lp, int c1, float* out,
                                void* stream) {
  const dim3 grid((K + kThreads - 1) / kThreads, B);
  const size_t smem = (size_t)lp * c1 * sizeof(float);
  rerank_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      rows, q, K, W, lp, c1, out);
  return (int)cudaGetLastError();
}
