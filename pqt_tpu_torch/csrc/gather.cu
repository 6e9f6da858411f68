// Kernel H: row gather out[r, s, :] = tab[pos[r] + s, :] for s < span.
//
// Replaces the TPU kernel benchmarks/micro_gather2.py:pallas_dma_gather,
// which copies one table row per DMA, `inflight` copies queued per query,
// through a VMEM scratch ring.  Hopper needs no ring: the rows go straight
// from device memory into registers and out, and what the DMA queue hid --
// the latency of a random read -- only loads in flight hide here.
//
// Uses in the port: the probe's (start, end) extent rows prefix2[bins] (8 B
// rows; at SIFT1B_CONFIG widths 32768 a query from a 4 GiB table), the
// compact payload rows of the candidates (40 B at SIFT1M, 72 B at SIFT1B)
// and, in slab mode (span > 1), `span` consecutive payload rows from each
// start position (the start clamp and the validity window stay in the
// caller, pqt_tpu_torch/ops/binning.py:fetch_slab_rows).
//
// What bounds it on the H100: bytes -- the positions read once, every output
// row written once and every source row read once; the reads are random at
// row grain, so a row narrower than a 32-byte sector moves whole sectors.
// Only the number of loads in flight hides their latency.  The design:
//
//   * an item is one position: its `span` rows are contiguous in the table
//     and in the output, so an item is one run of span * row_bytes bytes,
//     copied in units of the widest of 16, 8, 4, 2 or 1 bytes that divides
//     the row and to which table and output are aligned (16 B for the 128 B
//     vectors, 8 B for the extent and payload rows);
//   * rows mode (an item of at most 32 units): a group of exactly `units`
//     lanes owns an item, one unit a lane (8-byte extent rows: one lane a
//     row; 72-byte payload rows: 9 lanes, 3 groups a warp), and each group
//     has kRows items in flight.  A lane loads the positions of all its
//     items first (for each of the kRows a coalesced load of consecutive
//     positions, one transaction for the lanes of a group), then issues
//     every row load, then every store;
//   * long mode (longer items, such as SIFT1M's slabs of 32 x 40 B): a warp
//     owns an item and copies it in rounds of kRows units a lane, the next
//     item's position loaded before the current one is copied;
//   * stores are coalesced: consecutive lanes write consecutive units of
//     out, the groups of a warp consecutive items;
//   * item and unit indices are 32-bit, with no division in the copy; only
//     byte offsets (a position times the row's units, an item times its
//     units) are 64-bit: the extent table is 4 GiB.
//
// kRows is 4: 2, 4 and 8 were within 5% of each other from 256 MiB tables
// up on the H100.  The launch shape (unit, blocks) is chosen by `_gather_plan`
// in pqt_tpu_torch/ops/cuda/gather.py and checked here.  A source row
// outside [0, n_rows) reads nothing and yields zeros; callers pass in-range
// positions.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;

// Units [lo, hi) of an item starting at row p lie in rows inside the table.
struct Window {
  int lo, hi;
};

__device__ __forceinline__ Window window(long long p, long long n_rows,
                                         int span, int upr) {
  long long lo = p < 0 ? -p : 0;
  long long hi = n_rows - p;
  lo = lo < span ? lo : span;
  hi = hi < 0 ? 0 : (hi < span ? hi : span);
  return {(int)lo * upr, (int)hi * upr};
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ tab, long long n_rows, int upr,
                   const int* __restrict__ pos, int n_pos, int span,
                   int units, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int group = lane / units;          // units <= 32; once a thread
  const int per_warp = 32 / units;
  if (group >= per_warp) return;           // lanes past the last group
  const int u = lane - group * units;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int first = warp * per_warp * kRows + group;

  int p[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = first + r * per_warp;
    p[r] = i < n_pos ? __ldg(pos + i) : 0;
  }
  V x[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const Window w = window(p[r], n_rows, span, upr);
    const bool ok = first + r * per_warp < n_pos && u >= w.lo && u < w.hi;
    x[r] = ok ? __ldg(tab + (long long)p[r] * upr + u) : V{};
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = first + r * per_warp;
    if (i < n_pos) out[(long long)i * units + u] = x[r];
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_long_kernel(const V* __restrict__ tab, long long n_rows, int upr,
                   const int* __restrict__ pos, int n_pos, int span,
                   int units, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int p = i < n_pos ? __ldg(pos + i) : 0;
  for (; i < n_pos; i += stride) {
    const int next = i + stride;
    const int p_next = next < n_pos ? __ldg(pos + next) : 0;
    const Window w = window(p, n_rows, span, upr);
    const V* src = tab + (long long)p * upr;
    V* dst = out + (long long)i * units;
    for (int u0 = lane; u0 < units; u0 += 32 * kRows) {
      V x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int u = u0 + 32 * r;
        x[r] = u < units && u >= w.lo && u < w.hi ? __ldg(src + u) : V{};
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int u = u0 + 32 * r;
        if (u < units) dst[u] = x[r];
      }
    }
    p = p_next;
  }
}

template <typename V>
int launch(const void* tab, long long n_rows, int row_bytes, const int* pos,
           int n_pos, int span, int blocks, void* out, cudaStream_t stream) {
  const int upr = row_bytes / (int)sizeof(V);
  const long long units = (long long)upr * span;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (units <= 32) {
    // rows mode: one tile of items a block, every item in a tile, no tile
    // past the last item, so every item index fits in 32 bits
    const long long per_block = (long long)kWarps * (32 / units) * kRows;
    if ((long long)blocks * per_block < n_pos ||
        (long long)(blocks - 1) * per_block >= n_pos ||
        n_pos > 0x7fffffffLL - per_block)
      return (int)cudaErrorInvalidValue;
    gather_rows_kernel<V><<<blocks, kThreads, 0, stream>>>(
        static_cast<const V*>(tab), n_rows, upr, pos, n_pos, span,
        (int)units, static_cast<V*>(out));
  } else {
    // a grid-stride loop over the items, its next index in 32 bits
    if (blocks > (1 << 24) ||
        n_pos > 0x7fffffffLL - (long long)blocks * kWarps)
      return (int)cudaErrorInvalidValue;
    gather_long_kernel<V><<<blocks, kThreads, 0, stream>>>(
        static_cast<const V*>(tab), n_rows, upr, pos, n_pos, span,
        (int)units, static_cast<V*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// tab: (n_rows, row_bytes) bytes; pos: (n_pos,) int32; out: (n_pos, span,
// row_bytes) bytes.  unit (bytes a load moves) and blocks come from the
// plan; unit must divide row_bytes and the addresses of tab and out.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int pqt_gather_rows(const void* tab, long long n_rows,
                               int row_bytes, const int* pos, int n_pos,
                               int span, int unit, int blocks, void* out,
                               void* stream) {
  if (n_pos <= 0 || span <= 0 || row_bytes <= 0 || blocks <= 0 ||
      unit <= 0 || row_bytes % unit || (size_t)tab % unit ||
      (size_t)out % unit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (unit) {
    case 16:
      return launch<uint4>(tab, n_rows, row_bytes, pos, n_pos, span,
                           blocks, out, s);
    case 8:
      return launch<uint2>(tab, n_rows, row_bytes, pos, n_pos, span,
                           blocks, out, s);
    case 4:
      return launch<unsigned int>(tab, n_rows, row_bytes, pos, n_pos, span,
                                    blocks, out, s);
    case 2:
      return launch<unsigned short>(tab, n_rows, row_bytes, pos, n_pos, span,
                                    blocks, out, s);
    case 1:
      return launch<unsigned char>(tab, n_rows, row_bytes, pos, n_pos, span,
                                   blocks, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
