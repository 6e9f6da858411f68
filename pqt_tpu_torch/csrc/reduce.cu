// Kernel D: per-row sums over `parts` equal contiguous segments,
// (B, D) float32 -> (B, parts), of x or, in square mode, of x * x.
//
// Replaces the TPU kernel pqt_tpu/ops/pallas/primitives.py:segmented_reduce,
// a VMEM reshape + sum over 8 rows per grid step, itself the analog of the
// reference's one-block-per-vector segmented tree reduction
// (ProQuantization.cu:101-137).  In the port it computes the per-part norms
// of the distance tables (parts = p and line_parts) in square mode: the
// square is taken on load, so x is read once, as XLA fuses
// jnp.sum(x ** 2, -1) in the JAX package (pqt_tpu/ops/distance.py).
//
// A row-major (B, D) array is a (B * parts, D / parts) array of segments, so
// the kernel sums rows of length `seg`.  What bounds it on the H100: bytes.
// Every element is read once and one float per segment is written, against
// one add (and one multiply) per element; only the bytes in flight hide the
// latency of the reads.  Little's law at 3.35 TB/s and about a microsecond
// wants some 25 KB in flight an SM, where one 4-byte load a lane gives 8 KB.
// The design:
//
//   * vec4 mode (seg % 4 == 0 and x 16-byte aligned, as every norm of the
//     port): 16-byte loads.  A group of G lanes owns a segment, G the
//     smallest power of two >= seg / 4 up to 32 (seg 4: one lane a segment,
//     no shuffle; seg 32: 8 lanes and 3 shuffles), and each group has kRows
//     = 4 segments in flight, so a lane has four 16-byte loads outstanding
//     (64 KB an SM; 2 and 8 were no faster on the H100).  For a given r the
//     groups of a block own consecutive segments: the block's loads are
//     contiguous;
//   * scalar mode (other segments): a group of G lanes (G the largest power
//     of two <= min(seg, 32)) owns one segment, with strided 4-byte loads;
//   * a lane adds its elements in order, the group adds its lanes' sums in a
//     shuffle tree, and the group's first lane writes.
//
// The square is rounded before it is added (no fused multiply-add), as the
// old route's separate x * x pass rounded it.  With integer-valued inputs
// whose sums stay below 2^24 every result is exact, in any order.  The
// launch shape (mode, G, blocks) is chosen by `_reduce_plan` in
// pqt_tpu_torch/ops/cuda/primitives.py and checked here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;        // segments a vec4 group has in flight

template <bool SQUARE>
__device__ __forceinline__ float term(float v) {
  return SQUARE ? __fmul_rn(v, v) : v;
}

template <int G, bool SQUARE>
__global__ void __launch_bounds__(kThreads)
reduce_vec4_kernel(const float4* __restrict__ x, int n_segments, int nv,
                   float* __restrict__ out) {
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x & (G - 1);
  const int first = blockIdx.x * kGroups * kRows + threadIdx.x / G;
  float s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
  for (int v = lane; v < nv; v += G) {
    float4 a[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = first + r * kGroups;
      a[r] = i < n_segments ? __ldg(x + (long long)i * nv + v)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = __fadd_rn(s[r], term<SQUARE>(a[r].x));
      s[r] = __fadd_rn(s[r], term<SQUARE>(a[r].y));
      s[r] = __fadd_rn(s[r], term<SQUARE>(a[r].z));
      s[r] = __fadd_rn(s[r], term<SQUARE>(a[r].w));
    }
  }
  // every lane of the warp takes part in the shuffles
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], o, G);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = first + r * kGroups;
      if (i < n_segments) out[i] = s[r];
    }
  }
}

template <int G, bool SQUARE>
__global__ void __launch_bounds__(kThreads)
reduce_scalar_kernel(const float* __restrict__ x, int n_segments, int seg,
                     float* __restrict__ out) {
  const int i = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const int lane = threadIdx.x & (G - 1);
  float s = 0.0f;
  if (i < n_segments) {
    const float* xs = x + (long long)i * seg;
    for (int k = lane; k < seg; k += G)
      s = __fadd_rn(s, term<SQUARE>(__ldg(xs + k)));
  }
  // every lane of the warp takes part in the shuffles
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, o, G);
  if (lane == 0 && i < n_segments) out[i] = s;
}

template <int G, bool SQUARE>
int launch_vec4(const float* x, int n_segments, int seg, int blocks,
                float* out, cudaStream_t stream) {
  const long long per_block = (long long)(kThreads / G) * kRows;
  if ((long long)blocks * per_block < n_segments ||
      (long long)(blocks - 1) * per_block >= n_segments)
    return (int)cudaErrorInvalidValue;
  reduce_vec4_kernel<G, SQUARE><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), n_segments, seg / 4, out);
  return (int)cudaGetLastError();
}

template <bool SQUARE>
int vec4(int group, const float* x, int n_segments, int seg, int blocks,
         float* out, cudaStream_t s) {
  // G is the smallest power of two >= seg / 4, at most 32
  const int nv = seg / 4;
  const int want =
      nv >= 32 ? 32 : (nv <= 1 ? 1 : 1 << (32 - __builtin_clz(nv - 1)));
  if (group != want) return (int)cudaErrorInvalidValue;
  switch (group) {
    case 1: return launch_vec4<1, SQUARE>(x, n_segments, seg, blocks, out, s);
    case 2: return launch_vec4<2, SQUARE>(x, n_segments, seg, blocks, out, s);
    case 4: return launch_vec4<4, SQUARE>(x, n_segments, seg, blocks, out, s);
    case 8: return launch_vec4<8, SQUARE>(x, n_segments, seg, blocks, out, s);
    case 16:
      return launch_vec4<16, SQUARE>(x, n_segments, seg, blocks, out, s);
    default:
      return launch_vec4<32, SQUARE>(x, n_segments, seg, blocks, out, s);
  }
}

template <int G, bool SQUARE>
int launch_scalar(const float* x, int n_segments, int seg, int blocks,
                  float* out, cudaStream_t stream) {
  const long long per_block = kThreads / G;
  if ((long long)blocks * per_block < n_segments ||
      (long long)(blocks - 1) * per_block >= n_segments)
    return (int)cudaErrorInvalidValue;
  reduce_scalar_kernel<G, SQUARE><<<blocks, kThreads, 0, stream>>>(
      x, n_segments, seg, out);
  return (int)cudaGetLastError();
}

template <bool SQUARE>
int scalar(int group, const float* x, int n_segments, int seg, int blocks,
           float* out, cudaStream_t s) {
  // G is the largest power of two <= min(seg, 32)
  const int m = seg >= 32 ? 32 : seg;
  if (group != 1 << (31 - __builtin_clz(m))) return (int)cudaErrorInvalidValue;
  switch (group) {
    case 1: return launch_scalar<1, SQUARE>(x, n_segments, seg, blocks, out, s);
    case 2: return launch_scalar<2, SQUARE>(x, n_segments, seg, blocks, out, s);
    case 4: return launch_scalar<4, SQUARE>(x, n_segments, seg, blocks, out, s);
    case 8: return launch_scalar<8, SQUARE>(x, n_segments, seg, blocks, out, s);
    case 16:
      return launch_scalar<16, SQUARE>(x, n_segments, seg, blocks, out, s);
    default:
      return launch_scalar<32, SQUARE>(x, n_segments, seg, blocks, out, s);
  }
}

}  // namespace

// x: (n_segments, seg) float32, contiguous; out: (n_segments,) float32.
// square: sum x * x instead of x.  vec (1: vec4 mode, which needs seg % 4
// == 0 and x 16-byte aligned), group and blocks come from the plan.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int pqt_segmented_reduce(const float* x, int n_segments, int seg,
                                    int square, int vec, int group,
                                    int blocks, float* out, void* stream) {
  if (n_segments <= 0 || seg <= 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if (seg % 4 || (size_t)x % 16) return (int)cudaErrorInvalidValue;
    return square ? vec4<true>(group, x, n_segments, seg, blocks, out, s)
                  : vec4<false>(group, x, n_segments, seg, blocks, out, s);
  }
  return square ? scalar<true>(group, x, n_segments, seg, blocks, out, s)
                : scalar<false>(group, x, n_segments, seg, blocks, out, s);
}
