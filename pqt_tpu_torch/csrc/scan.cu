// Kernel B: per-row int32 prefix sums, inclusive or exclusive.
//
// Replaces the TPU kernel pqt_tpu/ops/pallas/primitives.py:block_scan, which
// runs jnp.cumsum over 8 rows per grid step in VMEM.  Rows are independent
// here too, but a row may be far longer than one block can hold: the CSR
// prefix of the build is one row of hash_size slots (2^20 at the bench
// config, 2^29 at SIFT1B_CONFIG).  So there are two modes, both picked with
// their launch shape by _scan_plan (pqt_tpu_torch/ops/cuda/primitives.py):
//
//   rows:    a group of `group` warps walks one row in chunks, carrying the
//            running total from chunk to chunk; a block holds several groups
//            (several rows) when rows are short;
//   onepass: rows cut into tiles, and each tile learns the sum of
//            everything before it by a decoupled look-back (Merrill and
//            Garland, "Single-pass Parallel Prefix Scan with Decoupled
//            Look-back", NVIDIA 2016): a block takes its tile id from a
//            device counter in scheduling order (so it waits only on tiles
//            already running or done), publishes its tile's aggregate in a
//            64-bit status word, walks the predecessors one warp at a time
//            (32 status words a step) until it finds an inclusive prefix,
//            publishes its own, and writes.  One read and one write of the
//            row, in one launch.  While the id is on its way the block
//            already loads the tile its blockIdx names, the id it almost
//            always gets, so the atomic's round trip hides behind the load.
//
// Tiles of all rows share one flat id space; a row's first tile needs no
// look-back, and the look-back of a later tile stops at its row's start.
// A status word is (epoch << 2 | flag) << 32 | value, flag 1 = aggregate,
// 2 = inclusive prefix; a word of another epoch reads as "not yet".  So a
// status buffer kept from call to call needs no reset: the wrapper passes a
// new epoch each call (and zeroes the buffer when the epoch would wrap).
// The tile counter resets itself: atomicInc wraps it to 0 when the last
// block of the grid takes its id.  Zeroing the buffer before each launch
// instead cost more than the launch floor at every shape up to 2^20
// elements on the H100 (PERF.md).  A launch captured into a CUDA graph is
// the exception: its epoch would replay unchanged, so the wrapper gives it
// status words of the graph's own, zeroed by the node before it on every
// replay, and epoch 1 (_scan_status in ops/cuda/primitives.py).
//
// Both modes hold a chunk in registers: lane l of warp w of a group holds
// the 16-byte vectors (w * J + j) * 32 + l, j < J, of the chunk -- every
// load instruction of a warp covers 512 contiguous bytes -- and scans them
// with J warp scans; the warp totals are combined through shared memory.
// Vectors sit at flat indices that are multiples of 4 (the output is 16-byte
// aligned), so a row of odd length starts and ends inside a vector: a vector
// that straddles the row's ends, and every load of an input that is not
// 16-byte aligned, takes the scalar path.
//
// The sum of a row must fit in int32; the caller guards that (a CSR row
// count above 2^31 - 1 is refused where the database is built).  The sums
// are taken in uint32, which wraps as torch.cumsum's int32 does.
//
// What bounds it on the H100: one read and one write of every element, so
// bytes at 3.35 TB/s.  Short rows are at the launch floor; long ones are
// held by each tile's serial steps (id, load, look-back, store), which
// larger tiles amortise.  Of the tiles swept, 32 KB ones (kTileWarps warps
// of kTileVecs vectors) did best overall: 64 KB ones were 1% faster at 2^29
// elements and 8% slower at 2^20 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;
// Onepass mode's tile: kTileWarps warps of kTileVecs 16-byte vectors a lane.
constexpr int kTileWarps = 8;
constexpr int kTileVecs = 8;
constexpr unsigned kAggregate = 1u;
constexpr unsigned kPrefix = 2u;
constexpr unsigned kFull = 0xffffffffu;

// A status word holds its flag and its value together and a reader uses
// nothing else the writer wrote, so one relaxed 64-bit access each way is
// enough (acquire and release ordering measured slower on the H100).
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long status_word(unsigned epoch,
                                                          unsigned flag,
                                                          unsigned value) {
  return ((unsigned long long)((epoch << 2) | flag) << 32) | value;
}

__device__ __forceinline__ unsigned warp_inclusive(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Flat index of the first element of vector j held by (group warp gw, lane)
// in the chunk that starts at vector v0.
template <int J>
__device__ __forceinline__ long long vec_first(long long v0, int gw, int j,
                                               int lane) {
  return (v0 + (long long)(gw * J + j) * 32 + lane) * 4;
}

// Load this lane's J vectors; elements outside [lo, hi) read as 0.
template <int J>
__device__ __forceinline__ void load_chunk(const int* __restrict__ x,
                                           long long v0, long long lo,
                                           long long hi, int gw, int lane,
                                           bool vec_in, unsigned (&r)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long f = vec_first<J>(v0, gw, j, lane);
    if (vec_in && f >= lo && f + 4 <= hi) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(x + f));
      r[j][0] = q.x;
      r[j][1] = q.y;
      r[j][2] = q.z;
      r[j][3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        r[j][k] = (f + k >= lo && f + k < hi) ? (unsigned)__ldg(x + f + k)
                                              : 0u;
    }
  }
}

// Scan the lane's vectors across its warp: pre[j] is the sum of the warp's
// elements before vector j (in chunk order); returns the warp's total.
template <int J>
__device__ __forceinline__ unsigned warp_scan_chunk(const unsigned (&r)[J][4],
                                                    int lane,
                                                    unsigned (&pre)[J]) {
  unsigned carry = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const unsigned s = r[j][0] + r[j][1] + r[j][2] + r[j][3];
    const unsigned inc = warp_inclusive(s, lane);
    pre[j] = carry + inc - s;
    carry += __shfl_sync(kFull, inc, 31);
  }
  return carry;
}

// The sum of the group's warps before warp gw, and the group's total, from
// the warp totals tot[0 .. G).
__device__ __forceinline__ void group_offsets(const unsigned* tot, int G,
                                              int gw, int lane,
                                              unsigned* before,
                                              unsigned* total) {
  const unsigned t = lane < G ? tot[lane] : 0u;
  const unsigned inc = warp_inclusive(t, lane);
  const unsigned prev = __shfl_sync(kFull, inc, gw > 0 ? gw - 1 : 0);
  *before = gw > 0 ? prev : 0u;
  *total = __shfl_sync(kFull, inc, G - 1);
}

// Write this lane's vectors: element k of vector j gets `base + pre[j]`
// plus the elements before it in the vector (and itself when inclusive).
template <int J>
__device__ __forceinline__ void store_chunk(int* __restrict__ out,
                                            long long v0, long long lo,
                                            long long hi, int gw, int lane,
                                            const unsigned (&r)[J][4],
                                            const unsigned (&pre)[J],
                                            unsigned base, bool exclusive) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long f = vec_first<J>(v0, gw, j, lane);
    unsigned o[4];
    unsigned run = base + pre[j];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = exclusive ? run : run + r[j][k];
      run += r[j][k];
    }
    if (f >= lo && f + 4 <= hi) {
      *reinterpret_cast<int4*>(out + f) =
          make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (f + k >= lo && f + k < hi) out[f + k] = (int)o[k];
    }
  }
}

// Vectors a row of n elements touches, at most (a row that does not start
// on a multiple of 4 spans one vector more).
__host__ __device__ __forceinline__ long long row_vectors(long long n) {
  return n % 4 == 0 ? n / 4 : (n + 6) / 4;
}

// Rows mode: block b holds blockDim / (32 G) groups of G warps, group g
// scans row b * groups + g in chunks of G * J * 32 vectors.
template <int J>
__global__ void scan_rows_kernel(const int* __restrict__ x, int rows,
                                 long long n, int G, int exclusive,
                                 int vec_in, int* __restrict__ out) {
  __shared__ unsigned tot[2][kMaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / G, gw = warp % G;
  const long long row = (long long)blockIdx.x * ((blockDim.x >> 5) / G) + g;
  // a group past the last row scans nothing but keeps the block's barriers
  const long long lo = row < rows ? row * n : 0;
  const long long hi = row < rows ? lo + n : 0;
  const long long chunk = (long long)G * J * 32;
  const long long chunks = (row_vectors(n) + chunk - 1) / chunk;
  unsigned carry = 0;
  for (long long c = 0; c < chunks; ++c) {
    const long long v0 = (lo >> 2) + c * chunk;
    unsigned r[J][4], pre[J];
    load_chunk<J>(x, v0, lo, hi, gw, lane, vec_in != 0, r);
    const unsigned wt = warp_scan_chunk<J>(r, lane, pre);
    unsigned* t = tot[c & 1];               // two buffers: one barrier a chunk
    if (lane == 0) t[warp] = wt;
    __syncthreads();
    unsigned before, total;
    group_offsets(t + g * G, G, gw, lane, &before, &total);
    store_chunk<J>(out, v0, lo, hi, gw, lane, r, pre, carry + before,
                   exclusive != 0);
    carry += total;
  }
}

// Onepass mode: one block per tile of kTileWarps * kTileVecs * 32 vectors,
// tiles_per_row tiles a row.  The block takes its tile id from the counter,
// so it only ever waits on tiles that are running or done.
__global__ void scan_onepass_kernel(const int* __restrict__ x, long long n,
                                    int tiles_per_row, int exclusive,
                                    int vec_in,
                                    unsigned long long* __restrict__ status,
                                    unsigned* __restrict__ counter,
                                    unsigned epoch, int* __restrict__ out) {
  constexpr int G = kTileWarps, J = kTileVecs;
  __shared__ unsigned tot[G];
  __shared__ unsigned s_tile, s_prefix;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_tile = atomicInc(counter, gridDim.x - 1);
  // While the id is on its way, load the tile this block usually gets (the
  // counter mostly hands out ids in launch order); load again if not.
  const long long chunk = (long long)G * J * 32;
  unsigned r[J][4], pre[J];
  {
    const long long row = blockIdx.x / (unsigned)tiles_per_row;
    const int tile = (int)(blockIdx.x % (unsigned)tiles_per_row);
    const long long lo = row * n;
    load_chunk<J>(x, (lo >> 2) + tile * chunk, lo, lo + n, warp, lane,
                  vec_in != 0, r);
  }
  __syncthreads();
  const unsigned t = s_tile;
  const long long row = t / (unsigned)tiles_per_row;
  const int tile = (int)(t % (unsigned)tiles_per_row);
  const long long lo = row * n, hi = lo + n;
  const long long v0 = (lo >> 2) + tile * chunk;
  if (t != blockIdx.x)
    load_chunk<J>(x, v0, lo, hi, warp, lane, vec_in != 0, r);
  const unsigned wt = warp_scan_chunk<J>(r, lane, pre);
  if (lane == 0) tot[warp] = wt;
  __syncthreads();
  unsigned before, aggregate;
  group_offsets(tot, G, warp, lane, &before, &aggregate);

  if (tile == 0) {
    if (threadIdx.x == 0)
      store_status(status + t, status_word(epoch, kPrefix, aggregate));
  } else if (warp == 0) {
    if (lane == 0)
      store_status(status + t, status_word(epoch, kAggregate, aggregate));
    // Look back: lane l reads tile p - l; the row's start reads as an
    // inclusive prefix of 0.
    const long long first = (long long)t - tile;
    long long p = (long long)t - 1 - lane;
    unsigned prefix = 0;
    while (true) {
      unsigned long long w = 0;
      unsigned flag = 0;
      do {
        if (flag == 0u) {
          w = p >= first ? load_status(status + p)
                         : status_word(epoch, kPrefix, 0u);
          const unsigned head = (unsigned)(w >> 32);
          flag = (head >> 2) == epoch ? (head & 3u) : 0u;
        }
      } while (__any_sync(kFull, flag == 0u));
      const unsigned found = __ballot_sync(kFull, flag == kPrefix);
      const int stop = found ? __ffs(found) - 1 : 31;
      prefix += warp_sum(lane <= stop ? (unsigned)w : 0u);
      if (found) break;
      p -= 32;
    }
    if (lane == 0) {
      store_status(status + t, status_word(epoch, kPrefix,
                                            prefix + aggregate));
      s_prefix = prefix;
    }
  }
  __syncthreads();
  const unsigned base = tile == 0 ? 0u : s_prefix;
  store_chunk<J>(out, v0, lo, hi, warp, lane, r, pre, base + before,
                 exclusive != 0);
}

}  // namespace

// Rows mode.  x, out: (rows, n) int32; `warps` warps a block (at most 32)
// in groups of `group` (warps % group == 0), `vecs` 16-byte vectors a lane
// per chunk (2 or 8); rows / (warps / group) blocks, rounded up.  out must
// be 16-byte aligned (x need not be).  Returns the CUDA error code of the
// launch.
extern "C" int pqt_block_scan_rows(const int* x, int rows, long long n,
                                   int exclusive, int warps, int group,
                                   int vecs, int* out, void* stream) {
  if (rows < 1 || n < 1 || warps < 1 || warps > kMaxWarps ||
      (vecs != 2 && vecs != 8) || group < 1 || warps % group ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int per_block = warps / group;
  const long long blocks = (rows + per_block - 1) / per_block;
  const int vec_in = ((uintptr_t)x & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vecs == 2)
    scan_rows_kernel<2><<<(unsigned)blocks, warps * 32, 0, s>>>(
        x, rows, n, group, exclusive, vec_in, out);
  else
    scan_rows_kernel<8><<<(unsigned)blocks, warps * 32, 0, s>>>(
        x, rows, n, group, exclusive, vec_in, out);
  return (int)cudaGetLastError();
}

// Onepass mode.  x, out: (rows, n) int32; tiles of kTileWarps * kTileVecs *
// 128 elements, tiles_per_row of them a row, one block each.  state: the
// caller's persistent buffer of 1 + rows * tiles_per_row 64-bit words -- the
// tile counter (its low 32 bits) and then the status words -- and epoch
// (1 .. 2^30 - 1) differs from every epoch its words hold.  Returns the CUDA
// error code of the launch.
extern "C" int pqt_block_scan_onepass(const int* x, int rows, long long n,
                                      int exclusive, int tiles_per_row,
                                      void* state, unsigned epoch, int* out,
                                      void* stream) {
  const long long tiles = (long long)rows * tiles_per_row;
  const long long chunk = (long long)kTileWarps * kTileVecs * 32;
  if (rows < 1 || n < 1 || tiles_per_row < 1 ||
      (long long)tiles_per_row * chunk < row_vectors(n) ||
      tiles > 0x7fffffffLL || epoch == 0 || epoch >= (1u << 30) ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  unsigned long long* words = static_cast<unsigned long long*>(state);
  scan_onepass_kernel<<<(unsigned)tiles, kTileWarps * 32, 0,
                        (cudaStream_t)stream>>>(
      x, n, tiles_per_row, exclusive, ((uintptr_t)x & 15) == 0, words + 1,
      reinterpret_cast<unsigned*>(words), epoch, out);
  return (int)cudaGetLastError();
}
