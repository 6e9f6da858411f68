// Kernel D: per-row sums over `parts` equal contiguous segments,
// (B, D) float32 -> (B, parts).
//
// Replaces the TPU kernel pqt_tpu/ops/pallas/primitives.py:segmented_reduce,
// a VMEM reshape + sum over 8 rows per grid step, itself the analog of the
// reference's one-block-per-vector segmented tree reduction
// (ProQuantization.cu:101-137).  In the port it computes the per-part norms
// of the distance tables (parts = p and line_parts) and the exact re-rank's
// row sums of squared differences (parts = 1).
//
// A row-major (B, D) array is a (B * parts, D / parts) array of segments, so
// the kernel sums rows of length `seg`.  A group of G lanes (G the largest
// power of two <= min(seg, 32)) owns one segment: strided loads, then a
// shuffle reduction inside the group.  Consecutive groups own consecutive
// segments, so a warp's loads are contiguous whatever the segment length:
// seg = 8 puts four segments in a warp, seg = 128 gives each lane four
// elements.  No power-of-two rule on D or parts.
//
// What bounds it on the H100: bytes.  Every element is read once and one
// float per segment is written, against one add per element; the design
// keeps the loads coalesced and touches nothing else.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void segmented_reduce_kernel(const float* __restrict__ x,
                                        long long n_segments, int seg,
                                        float* __restrict__ out) {
  const long long group =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int lane = threadIdx.x & (G - 1);
  float s = 0.0f;
  if (group < n_segments) {
    const float* xs = x + group * seg;
    for (int i = lane; i < seg; i += G) s += xs[i];
  }
  // every lane of the warp takes part in the shuffles
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o, G);
  if (lane == 0 && group < n_segments) out[group] = s;
}

template <int G>
int launch(const float* x, long long n_segments, int seg, float* out,
           cudaStream_t stream) {
  const long long threads = n_segments * G;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segmented_reduce_kernel<G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, n_segments, seg, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_segments, seg) float32, contiguous; out: (n_segments,) float32.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int pqt_segmented_reduce(const float* x, long long n_segments,
                                    int seg, float* out, void* stream) {
  if (n_segments <= 0 || seg <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (seg >= 32) return launch<32>(x, n_segments, seg, out, s);
  if (seg >= 16) return launch<16>(x, n_segments, seg, out, s);
  if (seg >= 8) return launch<8>(x, n_segments, seg, out, s);
  if (seg >= 4) return launch<4>(x, n_segments, seg, out, s);
  if (seg >= 2) return launch<2>(x, n_segments, seg, out, s);
  return launch<1>(x, n_segments, seg, out, s);
}
