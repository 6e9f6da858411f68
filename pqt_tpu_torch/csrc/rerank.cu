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
// Word 1 of a row is t3's float bits.  Two layouts of the line parts:
//
// * compact (c1 <= 16): word 2 + j/2 holds line part j in its (j % 2)-th
//   16-bit half as A | B << 4 | lam_u8 << 8, lam = lam_u8 * 8/256 - 4;
// * wide (c1 <= 256, payload_compact=False or c1 > 16): word 2 + j is one
//   uint32 per line part, A | B << 8 | lam_u16 << 16, lam = lam_u16 * 8/65536
//   - 4 (the port's u16_to_lambda, exact in float32).
//
// The table takes lp * c1 floats of shared memory: 32 KB at lp = 32 and
// c1 = 256, within the 48 KB a block gets without asking (the wrapper
// refuses more).
//
// Grid (ceil(K / 256), B): one thread per candidate, the ragged K tail
// masked, so K need not be a multiple of anything.
//
// What bounds it on the H100: bytes.  Each candidate's W words are read
// once and one float is written (40 + 4 bytes at lp = 16), against about
// 4 * lp flops; the table is 1 KB per query (up to 32 KB in the wide
// layout).  Each thread reads its own row (40 bytes compact at lp = 16, 136
// wide at lp = 32), so a warp's loads are not coalesced into full lines; staging
// the rows of a block through shared memory with coalesced loads, or fusing
// the payload-row gather in, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTableBytes = 48 * 1024;

template <bool COMPACT>
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
    unsigned a, bb;
    float lam;
    if (COMPACT) {
      const unsigned half = ((unsigned)r[2 + (j >> 1)] >> (16 * (j & 1))) &
                            0xFFFFu;
      a = half & 0xFu;
      bb = (half >> 4) & 0xFu;
      lam = (float)((half >> 8) & 0xFFu) * 0.03125f - 4.0f;
    } else {
      const unsigned w = (unsigned)r[2 + j];
      a = w & 0xFFu;
      bb = (w >> 8) & 0xFFu;
      lam = (float)(w >> 16) * (1.0f / 8192.0f) - 4.0f;
    }
    acc += (1.0f - lam) * qs[j * c1 + a] + lam * qs[j * c1 + bb];
  }
  out[b * K + k] = acc;
}

}  // namespace

// rows: (B, K, W) int32; q: (B, lp, c1) float32; out: (B, K) float32;
// compact: the 16-bit layout (W = 2 + ceil(lp / 2)), else the wide one
// (W = 2 + lp).  Returns the CUDA error code of the launch (0 = success).
extern "C" int pqt_rerank_fused(const int* rows, const float* q, int B, int K,
                                int W, int lp, int c1, int compact,
                                float* out, void* stream) {
  const size_t smem = (size_t)lp * c1 * sizeof(float);
  if (W != 2 + (compact ? (lp + 1) / 2 : lp) || c1 > (compact ? 16 : 256) ||
      smem > kMaxTableBytes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((K + kThreads - 1) / kThreads, B);
  if (compact)
    rerank_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        rows, q, K, W, lp, c1, out);
  else
    rerank_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        rows, q, K, W, lp, c1, out);
  return (int)cudaGetLastError();
}
