// Kernel L: the build's line-code selection.  It reads the line GEMM's
// output dot (n, lp, c1) as the GEMM wrote it, the segment norms xn (n,
// lp), the centroid norms cn (c1, lp) and the pair table pair (lp, c1, c1),
// all float32, and forms each segment distance in registers:
//
//   d[c] = clamp_min(xn[row, part] + cn[c, part] - 2 * dot[row, part, c], 0)
//
// (ops/distance.py subpart_sqdist_from_terms), so the (n, lp, c1) line
// tables and the four passes that make them are never written.  Then, for
// each (row, line part), over the pairs A < B of L1 centroid segments:
//
//   lambda = ((a2 - b2) - c2) * -0.5 / max(c2, 1e-20)
//   resid  = b2 - (lambda * lambda) * max(c2, 1e-20)
//
// with a2 = d[B] (the distance to B), b2 = d[A] and c2 = pair[part, A, B];
// it writes the packed code A | B << 8 | u16 << 16 (int64) of the pair of
// least residual, u16 its lambda quantised to the configured width, and the
// t3 term (q * q - q) * c2 of the decoded lambda q and the unclamped c2
// (float32).  The sum of the terms over the line parts stays with the
// caller (pqt_tpu_torch/ops/linecodes.py build_line_codes).
//
// It is not one of the Pallas kernels of the JAX package.  It replaces the
// fused reduce that XLA makes of pqt_tpu/ops/linecodes.py:77-105
// (best_lines: the residual, the triangle mask and the argmin in one pass,
// with lambda's take_along_axis after it) and the tables' epilogue before
// it, which the port ran op by op: eight passes over (n, lp, c1, c1)
// float32 intermediates, 2 GiB each at a 65536-row SIFT1B chunk (lp 32, c1
// 16), after four over the (n, lp, c1) tables.  Here no intermediate
// leaves the registers.
//
// Every result equals the plain version (line_codes_plain over the tables
// subpart_sqdist_from_terms makes) to the bit:
//
//   * each operation is rounded on its own, in the plain version's order
//     (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn: no fused multiply-add,
//     an IEEE divide), as PyTorch's elementwise passes round;
//   * the pick is torch.argmin's over the flat index A * c1 + B with the
//     pairs A >= B masked to +inf: the first least value, a NaN counting as
//     the least.  The masked flat index 0 (A = B = 0) is where the scan
//     starts, so a row whose every residual is +inf picks it, as argmin
//     does;
//   * the quantiser truncates toward zero after the two bounds and clamps
//     to [0, 65535] (a NaN lambda gives 0); the 8-bit width rounds on the
//     u16 grid, min((u16 + 128) >> 8, 255) << 8.
//
// What bounds it on the H100: operations.  At a SIFT1B chunk it reads 134
// MB of dot products and 8 MB of norms and writes 25 MB (0.05 ms at 3.35
// TB/s), and evaluates 120 pairs a (row, part), 252M, each with an IEEE
// divide of some ten instructions beside seven other operations and the
// compare: the instruction rate, not the bytes, sets its time.  The design:
//
//   * one thread a (row, line part); a block of kThreads rows of one line
//     part, the blocks of a row tile next to each other in the grid;
//   * the batched GEMM leaves dot with strides (c1, n * c1, 1) on the H100
//     (each line part's (n, c1) block contiguous): a (row, part)'s c1
//     values lie one after another, and a warp's 32 rows of one part read
//     one contiguous span;
//   * at c1 = 16 with those values 16-byte aligned (every build of the
//     port), the thread loads them as four float4 loads into registers,
//     applies the epilogue there, and walks the 120 pairs fully unrolled;
//     the block stages its part's pair table, its clamped twin and its 16
//     centroid norms (2 KB) in shared memory once, and every lane reads the
//     same word, a broadcast;
//   * any other c1 (up to 256), stride or alignment walks the pairs in
//     loops, each value read through the read-only cache at its strides.
//
// The launch takes the caller's stream (PyTorch's current one), allocates
// nothing and does not synchronise, so a CUDA graph captures it as it is.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC1 = 256;
constexpr float kLambdaLo = -4.0f;
constexpr float kLambdaHi = 4.0f;
constexpr float kLambdaScale = 8192.0f;        // 65536 / (hi - lo)

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// torch.clamp_min(c2, 1e-20): a NaN stays NaN
__device__ __forceinline__ float clamp_c2(float c2) {
  const float eps = (float)1e-20;
  return c2 < eps ? eps : c2;
}

// triangle.project_with_residual's lambda and residual, rounded as its
// passes round them
__device__ __forceinline__ void project(float a2, float b2, float c2,
                                        float c2c, float& lam, float& resid) {
  lam = __fdiv_rn(__fmul_rn(__fsub_rn(__fsub_rn(a2, b2), c2), -0.5f), c2c);
  resid = __fsub_rn(b2, __fmul_rn(__fmul_rn(lam, lam), c2c));
}

// whether resid comes before best in torch.argmin's order, resid's index
// being the larger: a NaN is the least value, ties keep the first index
__device__ __forceinline__ bool before(float resid, float best) {
  return resid < best || (resid != resid && best == best);
}

// The code and the t3 term of the picked pair `best` (flat index A * c1 +
// B), its lambda and its unclamped c2.
__device__ __forceinline__ void finish(int best, int c1, float lam, float c2,
                                       int u8, long long slot,
                                       long long* __restrict__ codes,
                                       float* __restrict__ terms) {
  // triangle.lambda_to_u16
  float f = __fmul_rn(__fsub_rn(lam, kLambdaLo), kLambdaScale);
  if (lam >= kLambdaHi) f = 65535.0f;
  else if (lam < kLambdaLo) f = 0.0f;
  int u = __float2int_rz(f);                   // a NaN gives 0
  u = min(max(u, 0), 65535);
  if (u8) u = min((u + 128) >> 8, 255) << 8;   // triangle.lambda_to_u8 << 8
  // triangle.u16_to_lambda
  const float q = __fadd_rn(__fmul_rn((float)u, 1.0f / kLambdaScale),
                            kLambdaLo);
  terms[slot] = __fmul_rn(__fsub_rn(__fmul_rn(q, q), q), c2);
  codes[slot] = (long long)(best / c1) | ((long long)(best % c1) << 8) |
                ((long long)u << 16);
}

// torch.clamp_min(xn + cn - 2.0 * dot, 0.0), rounded as those passes round
// it (ops/distance.py subpart_sqdist_from_terms): the add, the doubling and
// the subtraction each on its own, a NaN kept as clamp_min keeps it
__device__ __forceinline__ float line_dist(float xn, float cn, float dot) {
  const float t = __fsub_rn(__fadd_rn(xn, cn), __fmul_rn(2.0f, dot));
  return t != t ? t : fmaxf(t, 0.0f);
}

// A (row, part)'s c1 dot products lie at dot + row * s_row + part *
// s_part, one after another.
template <int C1>
__global__ void __launch_bounds__(kThreads)
line_codes_fixed_kernel(const float* __restrict__ dot,
                        const float* __restrict__ xn,
                        const float* __restrict__ cn, long long s_row,
                        long long s_part, const float* __restrict__ pair,
                        int n, int lp, int u8, long long* __restrict__ codes,
                        float* __restrict__ terms) {
  __shared__ float s_c2[C1 * C1];
  __shared__ float s_c2c[C1 * C1];
  __shared__ float s_cn[C1];
  const int part = blockIdx.x % lp;
  const long long row = (long long)(blockIdx.x / lp) * kThreads + threadIdx.x;
  const float* p = pair + (long long)part * C1 * C1;
  for (int i = threadIdx.x; i < C1 * C1; i += kThreads) {
    const float c2 = p[i];
    s_c2[i] = c2;
    s_c2c[i] = clamp_c2(c2);
  }
  if (threadIdx.x < C1)
    s_cn[threadIdx.x] = cn[(long long)threadIdx.x * lp + part];
  __syncthreads();
  if (row >= n) return;
  const long long slot = row * lp + part;
  const float x = __ldg(xn + slot);
  float d[C1];
  const float4* v4 =
      reinterpret_cast<const float4*>(dot + row * s_row + part * s_part);
#pragma unroll
  for (int v = 0; v < C1 / 4; ++v) {
    const float4 t = __ldg(v4 + v);
    d[4 * v] = line_dist(x, s_cn[4 * v], t.x);
    d[4 * v + 1] = line_dist(x, s_cn[4 * v + 1], t.y);
    d[4 * v + 2] = line_dist(x, s_cn[4 * v + 2], t.z);
    d[4 * v + 3] = line_dist(x, s_cn[4 * v + 3], t.w);
  }
  // the masked flat index 0 (A = B = 0), +inf
  float best_r = inf(), best_lam, r;
  project(d[0], d[0], s_c2[0], s_c2c[0], best_lam, r);
  int best = 0;
#pragma unroll
  for (int a = 0; a < C1; ++a) {
#pragma unroll
    for (int b = a + 1; b < C1; ++b) {
      float lam;
      project(d[b], d[a], s_c2[a * C1 + b], s_c2c[a * C1 + b], lam, r);
      if (before(r, best_r)) {
        best_r = r;
        best = a * C1 + b;
        best_lam = lam;
      }
    }
  }
  finish(best, C1, best_lam, s_c2[best], u8, slot, codes, terms);
}

// Any c1 and strides: a (row, part)'s c-th dot product at dot + row *
// s_row + part * s_part + c * s_c, the pairs walked in loops.
__global__ void __launch_bounds__(kThreads)
line_codes_any_kernel(const float* __restrict__ dot,
                      const float* __restrict__ xn,
                      const float* __restrict__ cn, long long s_row,
                      long long s_part, long long s_c,
                      const float* __restrict__ pair, int n, int lp, int c1,
                      int u8, long long* __restrict__ codes,
                      float* __restrict__ terms) {
  const int part = blockIdx.x % lp;
  const long long row = (long long)(blockIdx.x / lp) * kThreads + threadIdx.x;
  if (row >= n) return;
  const long long slot = row * lp + part;
  const float* v = dot + row * s_row + part * s_part;
  const float* p = pair + (long long)part * c1 * c1;
  const float x = __ldg(xn + slot);
  auto dist = [&](int c) {
    return line_dist(x, __ldg(cn + (long long)c * lp + part),
                     __ldg(v + c * s_c));
  };
  const float d0 = dist(0), p0 = __ldg(p);
  float best_r = inf(), best_lam, r;
  project(d0, d0, p0, clamp_c2(p0), best_lam, r);
  int best = 0;
  for (int a = 0; a < c1; ++a) {
    const float b2 = dist(a);
    for (int b = a + 1; b < c1; ++b) {
      const float c2 = __ldg(p + a * c1 + b);
      float lam;
      project(dist(b), b2, c2, clamp_c2(c2), lam, r);
      if (before(r, best_r)) {
        best_r = r;
        best = a * c1 + b;
        best_lam = lam;
      }
    }
  }
  finish(best, c1, best_lam, __ldg(p + best), u8, slot, codes, terms);
}

}  // namespace

// dot (n, lp, c1) float32 at the strides s_row, s_part, s_c (elements):
// the line GEMM's output; xn (n, lp) and cn (c1, lp) float32, contiguous:
// the segment norms; pair (lp, c1, c1) float32, contiguous; codes and
// terms (n, lp), int64 and float32.  u8: lambda on the 8-bit grid.
// Returns cudaGetLastError() after the launch (0: launched).
extern "C" int pqt_line_codes(const float* dot, const float* xn,
                              const float* cn, long long s_row,
                              long long s_part, long long s_c,
                              const float* pair, int n, int lp, int c1,
                              int u8, long long* codes, float* terms,
                              void* stream) {
  if (n <= 0 || lp <= 0 || c1 <= 0 || c1 > kMaxC1 ||
      (long long)n * lp > INT_MAX || xn == nullptr || cn == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)n + kThreads - 1) / kThreads * lp;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // each (row, part)'s 16 values as four aligned float4 loads
  if (c1 == 16 && s_c == 1 && s_row % 4 == 0 && s_part % 4 == 0 &&
      reinterpret_cast<uintptr_t>(dot) % 16 == 0)
    line_codes_fixed_kernel<16><<<(int)blocks, kThreads, 0, s>>>(
        dot, xn, cn, s_row, s_part, pair, n, lp, u8, codes, terms);
  else
    line_codes_any_kernel<<<(int)blocks, kThreads, 0, s>>>(
        dot, xn, cn, s_row, s_part, s_c, pair, n, lp, c1, u8, codes, terms);
  return (int)cudaGetLastError();
}
