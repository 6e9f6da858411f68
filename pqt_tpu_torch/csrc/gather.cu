// Kernel H: row gather out[r, s, :] = tab[pos[r] + s, :] for s < span.
//
// Replaces the TPU kernel benchmarks/micro_gather2.py:pallas_dma_gather,
// which copies one table row per DMA, `inflight` copies queued per query,
// through a VMEM scratch ring.  Hopper needs no ring: each thread copies a
// piece of a row straight from device memory into the output, and the many
// warps in flight hide the latency that the TPU's DMA queue hid.
//
// Uses in the port: the probe's (start, end) extent rows prefix2[bins] (8 B
// rows), the compact payload rows of the candidates (40 B rows), and the raw
// uint8 vectors of the exact re-rank and refine (128 B rows at SIFT width).
// span > 1 is slab mode: S consecutive rows from each start position (the
// start clamp and the validity window stay in the caller,
// pqt_tpu_torch/ops/binning.py:fetch_slab_rows).
//
// The row is copied as bytes in the widest unit V (16, 8, 4, 2 or 1 bytes)
// that divides the row and to which both the table and the output are
// aligned: 16-byte loads for the 128 B vectors, 8-byte loads for the 40 B
// payload rows and the extent rows.  Consecutive threads copy consecutive
// units of a row, then of the next row, so a warp reads whole rows.  A
// source row outside [0, n_rows) reads nothing and yields zeros; callers
// pass in-range positions.
//
// What bounds it on the H100: bytes -- the positions read once, every
// output row written once and every source row read once.  The loads are
// random at row granularity, so rows narrower than a 32-byte sector waste
// part of each sector they touch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ tab,
                                   long long n_rows, int units,
                                   const int* __restrict__ pos, int span,
                                   long long total, V* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const long long r = t / units;              // output row
    const int u = (int)(t - r * units);
    const long long src = (long long)pos[r / span] + r % span;
    V v;
    if (src >= 0 && src < n_rows) {
      v = __ldg(tab + src * units + u);
    } else {
      v = V{};
    }
    out[t] = v;
  }
}

template <typename V>
int launch(const void* tab, long long n_rows, int row_bytes, const int* pos,
           long long n_pos, int span, void* out, cudaStream_t stream) {
  const int units = row_bytes / (int)sizeof(V);
  const long long total = n_pos * span * units;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(tab), n_rows, units, pos, span, total,
      static_cast<V*>(out));
  return (int)cudaGetLastError();
}

bool fits(const void* tab, const void* out, int row_bytes, int v) {
  return row_bytes % v == 0 && (size_t)tab % v == 0 && (size_t)out % v == 0;
}

}  // namespace

// tab: (n_rows, row_bytes) bytes; pos: (n_pos,) int32; out: (n_pos, span,
// row_bytes) bytes.  Returns the CUDA error code of the launch (0 = success).
extern "C" int pqt_gather_rows(const void* tab, long long n_rows,
                               int row_bytes, const int* pos, long long n_pos,
                               int span, void* out, void* stream) {
  if (n_pos <= 0 || span <= 0 || row_bytes <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (fits(tab, out, row_bytes, 16))
    return launch<uint4>(tab, n_rows, row_bytes, pos, n_pos, span, out, s);
  if (fits(tab, out, row_bytes, 8))
    return launch<uint2>(tab, n_rows, row_bytes, pos, n_pos, span, out, s);
  if (fits(tab, out, row_bytes, 4))
    return launch<unsigned int>(tab, n_rows, row_bytes, pos, n_pos, span,
                                out, s);
  if (fits(tab, out, row_bytes, 2))
    return launch<unsigned short>(tab, n_rows, row_bytes, pos, n_pos, span,
                                  out, s);
  return launch<unsigned char>(tab, n_rows, row_bytes, pos, n_pos, span, out,
                               s);
}
