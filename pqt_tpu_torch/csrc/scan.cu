// Kernel B: per-row int32 prefix sums, inclusive or exclusive.
//
// Replaces the TPU kernel pqt_tpu/ops/pallas/primitives.py:block_scan, which
// runs jnp.cumsum over 8 rows per grid step in VMEM.  Rows are independent
// here too, but a row may be far longer than one block can hold: the CSR
// prefix of the build is one row of hash_size slots (2^20 at the bench
// config, 2^29 at SIFT1B_CONFIG).  So there are two modes:
//
//   rows:     one block per row; the block walks the row in tiles of
//             blockDim elements (a warp-shuffle scan inside each warp, the
//             warp totals scanned through shared memory) carrying the
//             running total from tile to tile;
//   long row: three passes -- every tile of TILE elements sums itself, the
//             tile sums are scanned (rows mode, exclusive), then every tile
//             scans itself from its offset.  A single-pass decoupled
//             look-back is later work.
//
// The sum of a row must fit in int32; the caller guards that (a CSR row
// count above 2^31 - 1 is refused where the database is built).
//
// What bounds it on the H100: one read and one write of every element, so
// bytes at 3.35 TB/s.  Each element is loaded by one thread of a coalesced
// tile, and the long-row mode reads the row twice (the price of the three
// passes).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;                    // elements per thread per tile
constexpr int kTile = kThreads * kItems;     // long-row mode tile

// Inclusive scan of one value per thread across the block.  Leaves the
// block total in warp_sums[nwarps - 1]; the caller syncs before reuse.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  return v;
}

// Scan x[begin:end) into out[begin:end), starting from `carry`.
__device__ void scan_range(const int* __restrict__ x, int* __restrict__ out,
                           int begin, int end, int carry, bool exclusive,
                           int* warp_sums) {
  const int nwarps = blockDim.x >> 5;
  for (int base = begin; base < end; base += blockDim.x) {
    const int idx = base + threadIdx.x;
    const int v = idx < end ? x[idx] : 0;
    const int inc = block_inclusive_scan(v, warp_sums);
    if (idx < end) out[idx] = carry + (exclusive ? inc - v : inc);
    carry += warp_sums[nwarps - 1];
    __syncthreads();                         // warp_sums is rewritten next
  }
}

__global__ void scan_rows_kernel(const int* __restrict__ x, int n,
                                 int exclusive, int* __restrict__ out) {
  __shared__ int warp_sums[32];
  const size_t off = (size_t)blockIdx.x * n;
  scan_range(x + off, out + off, 0, n, 0, exclusive != 0, warp_sums);
}

// grid (tiles, rows): sums[row * tiles + tile] = sum of that tile.
__global__ void tile_sums_kernel(const int* __restrict__ x, int n,
                                 int* __restrict__ sums) {
  __shared__ int warp_sums[32];
  const int tiles = gridDim.x;
  const int* xr = x + (size_t)blockIdx.y * n;
  const int begin = blockIdx.x * kTile;
  const int end = min(n, begin + kTile);
  int s = 0;
  for (int i = begin + threadIdx.x; i < end; i += blockDim.x) s += xr[i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(0xffffffffu, w, o);
    if (lane == 0) sums[(size_t)blockIdx.y * tiles + blockIdx.x] = w;
  }
}

// grid (tiles, rows): scan each tile from its exclusive offset.
__global__ void scan_tiles_kernel(const int* __restrict__ x, int n,
                                  const int* __restrict__ offsets,
                                  int exclusive, int* __restrict__ out) {
  __shared__ int warp_sums[32];
  const int tiles = gridDim.x;
  const size_t off = (size_t)blockIdx.y * n;
  const int begin = blockIdx.x * kTile;
  const int end = min(n, begin + kTile);
  const int carry = offsets[(size_t)blockIdx.y * tiles + blockIdx.x];
  scan_range(x + off, out + off, begin, end, carry, exclusive != 0,
             warp_sums);
}

int rows_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  return t < kThreads ? (t < 32 ? 32 : t) : kThreads;
}

}  // namespace

extern "C" int pqt_scan_tile() { return kTile; }

// Rows mode.  x, out: (rows, n) int32.  Returns the CUDA error code.
extern "C" int pqt_block_scan_rows(const int* x, int rows, int n,
                                   int exclusive, int* out, void* stream) {
  scan_rows_kernel<<<rows, rows_threads(n), 0, (cudaStream_t)stream>>>(
      x, n, exclusive, out);
  return (int)cudaGetLastError();
}

// Long-row mode.  sums and offsets: (rows, ceil(n / pqt_scan_tile())) int32
// scratch.  Returns the CUDA error code of the first launch that failed.
extern "C" int pqt_block_scan_long(const int* x, int rows, int n,
                                   int exclusive, int* sums, int* offsets,
                                   int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, rows);
  tile_sums_kernel<<<grid, kThreads, 0, s>>>(x, n, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_rows_kernel<<<rows, rows_threads(tiles), 0, s>>>(sums, tiles, 1,
                                                        offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_tiles_kernel<<<grid, kThreads, 0, s>>>(x, n, offsets, exclusive, out);
  return (int)cudaGetLastError();
}
