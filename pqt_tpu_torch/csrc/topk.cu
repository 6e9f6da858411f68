// Kernel A: per-row top-k (smallest first, ties lowest index first).
//
// Replaces the TPU kernel pqt_tpu/ops/pallas/primitives.py:bitonic_topk,
// which sorts 8 rows per grid step in VMEM and compares values only, so its
// order among equal values is arbitrary.  Here the result is the first k of a
// stable ascending sort: values ascending, equal values lowest index first,
// which is the order of lax.top_k on the negated row.  The port's bin
// enumeration therefore matches the JAX package bit for bit.
//
// Inputs are never NaN: they are distances, or +inf for masked slots (+inf is
// a real value and sorts after every finite one).  -0.0 and +0.0 are equal
// here, as in torch.sort, jnp.argsort and lax.sort; lax.top_k alone orders
// -0.0 first (IEEE total order).  The port's inputs never hold -0.0: its
// tables are clamped at 0.0 and its sums have non-negative terms.
//
// What bounds it on the H100: the least traffic is one read of the row and
// one write of k (value, index) pairs, so the bound is bytes at 3.35 TB/s.
// A full bitonic sort of the row does O(n log^2 n) compare-exchanges in
// shared memory, 105 block-wide stages at n = 16384, and keeps 8 bytes an
// element in shared memory (one 16384-row block per SM), far above that
// bound.  So the kernel has three modes; the wrapper's _topk_plan picks one
// from (n, k) (ops/cuda/primitives.py):
//
// * select, where k is small beside n: one block per row finds the key of
//   the k-th smallest element by most-significant-digit-first radix passes
//   (8-bit digits of an order-preserving uint32 key, histograms in shared
//   memory by plain shared atomics, which measured faster here than
//   aggregating a warp's equal digits with __match_any_sync; at most 4
//   passes, fewer once the k-th element's bucket is taken whole), gathers
//   the elements below it through a shared counter and the first ties in
//   index order through a scan of per-warp tie counts, then bitonic-sorts
//   only those k pairs.  A row of up to 32 x 512 = 16384 elements is read
//   from device memory once and held in registers (no index array: indices
//   are positions); a longer row (up to 2^30 elements) is read again from
//   device memory or L2 on every pass.
// * sort, for rows of at most 512 elements and for k above n / 2, where the
//   select's passes lost to it on this card: the whole row, padded inside
//   the block to a power of two with (+inf, INT_MAX), bitonic-sorted as
//   (value, index) pairs in shared memory (n <= 16384).
// * merge, for k above 16384, which no block's shared memory sorts: the
//   select writes its k survivors, unsorted, to a scratch row in device
//   memory (or, for k = n, the row itself is the list); each run of 16384
//   pairs is bitonic-sorted in shared memory by one block, in place; then
//   log2(runs) merge passes in device memory double the sorted runs, each
//   block writing one 4096-pair tile of the output: two binary searches
//   along the merge path find where its tile starts and ends in the two
//   runs, it stages those pairs in shared memory, and every thread merges 8
//   outputs from a split point of its own.  Pairs compare as (value,
//   index), the first run winning equal pairs (only the (+inf, INT_MAX)
//   padding repeats), so the order is the same total order as the other
//   modes'.  Each merge pass reads and writes the scratch rows once; the
//   runs' sorts are bound by shared memory, as in sort mode.
//
// Rows of more than 16384 elements, up to C x 16384, take the cluster
// route (pqt_topk_cluster) in merge mode and in select mode for small k;
// the wrapper's _topk_plan picks the route from the cut that chip_sweep.py
// measured: one thread-block cluster of C blocks (C <= 8, the portable
// limit) a row, each block holding one slice of the row as keys in
// registers, so the row is read from device memory once.
// * Merge mode finds the row's k-th key by the select's digit passes, each
//   pass's histograms summed through distributed shared memory (DSMEM)
//   after a cluster barrier; compacts the survivors in position order
//   (block r's tie base and first slot are the counts of blocks 0 to r-1,
//   read the same way), per_k a block; and sorts them by a stable
//   least-significant-digit radix sort on the keys, 4 passes of 8 bits:
//   each block ranks and partitions its pairs by digit in its own shared
//   memory, then copies each digit's run to the cluster-wide digit-major,
//   block-minor offset in the shared memory of the block that holds it (a
//   pass in which one digit holds every key is skipped).  The pairs never
//   go through device memory; values and indices are written once.
// * Select mode has each block select its own slice's k smallest, with no
//   cluster traffic (a digit pass a cluster barrier was slower), and sort
//   the C x k candidates in block 0, as the one-block select sorts its k.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kSelectThreads = 512;        // most threads of a select block
constexpr int kMaxWarps = kSelectThreads / 32;
constexpr int kMaxSort = 16384;            // longest sort: 8 B a pair, 128 KB
constexpr int kMaxSelectRow = 1 << 30;     // row positions stay inside int32
constexpr int kRun = kMaxSort;             // merge mode: pairs a block sorts
constexpr int kRunThreads = 1024;
constexpr int kMergeThreads = 512;
constexpr int kMergeItems = 8;             // outputs a merging thread makes
constexpr int kMergeTile = kMergeThreads * kMergeItems;   // 32 KB of pairs
constexpr int kMaxMerge = 1 << 20;         // merge mode's most pairs a row
constexpr int kClusterThreads = 512;       // cluster route: threads a block
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kClusterRun = 8192;          // most pairs a block sorts in
                                           // merge mode (two 64 KB buffers)
constexpr int kClusterRounds = kClusterRun / kClusterThreads;
constexpr int kMaxCluster = 8;             // the portable cluster size

__device__ __forceinline__ bool pair_after(float va, int ia, float vb,
                                           int ib) {
  return va > vb || (va == vb && ia > ib);
}

// Order-preserving uint32 key of a float that is not NaN: a negative value
// flips every bit, a non-negative one its sign bit; -0.0 takes +0.0's key.
__device__ __forceinline__ uint32_t float_key(float v) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return u ^ ((u & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

// The float of a key (float_key's inverse); neg_zero: the value was -0.0.
__device__ __forceinline__ float key_float(uint32_t key, bool neg_zero) {
  const uint32_t u = (key & 0x80000000u) ? key ^ 0x80000000u : ~key;
  return __uint_as_float(neg_zero ? 0x80000000u : u);
}

// Ascending bitonic sort of len (a power of two) (value, index) pairs in
// shared memory, by every thread of the block; ends in a barrier.
__device__ void bitonic_sort_pairs(float* sv, int* si, int len) {
  const int half = len >> 1;
  for (int size = 2; size <= len; size <<= 1) {
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
}

// Sort mode: one block sorts one whole row, padded to `padded` elements.
__global__ void bitonic_sort_kernel(const float* __restrict__ x, int n,
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
    si[t] = t < n ? t : INT_MAX;
  }
  __syncthreads();
  bitonic_sort_pairs(sv, si, padded);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    out_v[row * k + t] = sv[t];
    out_i[row * k + t] = si[t];
  }
}

// Keys of one tile of the row: thread t holds positions base + j * blockDim
// + t (j < ITEMS), so every load is coalesced and position order is (j,
// warp, lane) order.
template <int ITEMS>
__device__ __forceinline__ void load_keys(const float* __restrict__ xr, int n,
                                          int base, uint32_t (&key)[ITEMS]) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int idx = base + j * blockDim.x + threadIdx.x;
    key[j] = idx < n ? float_key(__ldg(xr + idx)) : 0u;
  }
}

// Select mode: one block per row.  RESIDENT: the row fits one tile of ITEMS
// x blockDim keys, loaded once; otherwise every pass walks the row tile by
// tile.  blockDim is a multiple of 32 (whole warps vote).  TO_SCRATCH (merge
// mode): the k survivors go unsorted to row `row` of out_v / out_i, rows of
// sort_len pairs, and nothing is sorted here.
template <int ITEMS, bool RESIDENT, bool TO_SCRATCH>
__global__ void __launch_bounds__(kSelectThreads, 2)
radix_select_kernel(const float* __restrict__ x, int n, int k, int sort_len,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  const size_t row = blockIdx.x;
  float* sv = TO_SCRATCH ? out_v + row * sort_len : smem;
  int* si = TO_SCRATCH ? out_i + row * sort_len
                       : reinterpret_cast<int*>(smem + sort_len);
  __shared__ int hist[kBins];
  __shared__ int tie_base[ITEMS * kMaxWarps];
  __shared__ int s_bucket, s_before, s_count, s_slot, s_ties;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tile = ITEMS * blockDim.x;
  const unsigned lanes_below = (1u << lane) - 1u;
  const float* xr = x + row * n;

  uint32_t key[ITEMS];
  if (RESIDENT) load_keys<ITEMS>(xr, n, 0, key);

  // 1. The k-th smallest key, digit by digit from the top: bits [shift, 32)
  //    of it are `prefix`'s, and it is the need-th smallest of the keys that
  //    share those bits.
  uint32_t prefix = 0;
  int shift = 32;
  int need = k;
  for (int pass = 0; pass < 32 / kDigitBits; ++pass) {
    const int lo = shift - kDigitBits;
    for (int b = tid; b < kBins; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += tile) {
      if (!RESIDENT) load_keys<ITEMS>(xr, n, base, key);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int idx = base + j * blockDim.x + tid;
        const bool live = idx < n && (shift == 32 ||
                                      (key[j] >> shift) == (prefix >> shift));
        // a row read tile by tile runs faster when warps without a live
        // key skip the item whole (measured); a resident row, slower
        if (!RESIDENT && __ballot_sync(kFull, live) == 0) continue;
        if (live) atomicAdd(&hist[(key[j] >> lo) & (kBins - 1)], 1);
      }
    }
    __syncthreads();
    if (warp == 0) {
      constexpr int kPerLane = kBins / 32;
      int c[kPerLane];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        c[i] = hist[lane * kPerLane + i];
        sum += c[i];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      int run = incl - sum;
      if (run < need && need <= incl) {
        for (int i = 0; i < kPerLane; ++i) {
          if (need <= run + c[i]) {
            s_bucket = lane * kPerLane + i;
            s_before = run;
            s_count = c[i];
            break;
          }
          run += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)s_bucket << lo;
    need -= s_before;
    shift = lo;
    const bool whole = need == s_count;    // the bucket is taken whole
    __syncthreads();                       // s_* and hist are written again
    if (whole) break;
  }

  // 2. Collect: every key whose known bits are below the cut, in any order,
  //    to slots [0, less); then the first `need` keys equal to it in
  //    position order to slots [less, k).
  const int less = k - need;
  const uint32_t cut = prefix >> shift;     // shift < 32 after one pass
  if (tid == 0) {
    s_slot = 0;
    s_ties = 0;
  }
  if (!TO_SCRATCH) {
    for (int t = k + tid; t < sort_len; t += blockDim.x) {
      sv[t] = INFINITY;
      si[t] = INT_MAX;
    }
  }
  __syncthreads();
  for (int base = 0; base < n; base += tile) {
    if (!RESIDENT) load_keys<ITEMS>(xr, n, base, key);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int idx = base + j * blockDim.x + tid;
      const bool valid = idx < n;
      const uint32_t hi = key[j] >> shift;
      const bool below = valid && hi < cut;
      const unsigned b = __ballot_sync(kFull, below);
      if (b) {
        const int leader = __ffs(b) - 1;
        int slot = 0;
        if (lane == leader) slot = atomicAdd(&s_slot, __popc(b));
        slot = __shfl_sync(kFull, slot, leader) + __popc(b & lanes_below);
        if (below) {
          sv[slot] = __ldg(xr + idx);
          si[slot] = idx;
        }
      }
      const unsigned e = __ballot_sync(kFull, valid && hi == cut);
      if (lane == 0) tie_base[j * nwarps + warp] = __popc(e);
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the (item, warp) tie counts, which is position
      // order, continuing from the ties of the earlier tiles
      const int cells = ITEMS * nwarps;
      const int per = (cells + 31) / 32;
      const int c0 = min(cells, lane * per), c1 = min(cells, c0 + per);
      int sum = 0;
      for (int c = c0; c < c1; ++c) sum += tie_base[c];
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      const int earlier = s_ties;
      int run = earlier + incl - sum;
      for (int c = c0; c < c1; ++c) {
        const int v = tie_base[c];
        tie_base[c] = run;
        run += v;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      __syncwarp();
      if (lane == 0) s_ties = earlier + total;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int idx = base + j * blockDim.x + tid;
      const bool tie = idx < n && (key[j] >> shift) == cut;
      const unsigned e = __ballot_sync(kFull, tie);
      if (tie) {
        const int rank = tie_base[j * nwarps + warp] + __popc(e & lanes_below);
        if (rank < need) {
          sv[less + rank] = __ldg(xr + idx);
          si[less + rank] = idx;
        }
      }
    }
    __syncthreads();                       // tie_base is rewritten
  }

  // 3. Sort the k survivors (padded with (+inf, INT_MAX)) and write them.
  if (TO_SCRATCH) return;
  bitonic_sort_pairs(sv, si, sort_len);
  for (int t = tid; t < k; t += blockDim.x) {
    out_v[row * k + t] = sv[t];
    out_i[row * k + t] = si[t];
  }
}


// Merge mode, step 2: one block sorts run `run` of a row's m pairs
// (positions run * kRun ...), padded with (+inf, INT_MAX), in shared memory
// and writes it to row `row` of dst (rows of len pairs); src_i null: the
// indices are the positions.  Runs as its own copy in place (src == dst).
// With one run only, the first k pairs go to out_v / out_i instead.
__global__ void __launch_bounds__(kRunThreads)
run_sort_kernel(const float* src_v, const int* src_i, int src_stride, int m,
                int runs, int len, float* dst_v, int* dst_i, int k,
                float* out_v, int* out_i) {
  extern __shared__ float smem[];
  float* sv = smem;
  int* si = reinterpret_cast<int*>(smem + kRun);
  const size_t row = blockIdx.x / runs;
  const int run = blockIdx.x % runs;
  const float* rv = src_v + row * src_stride;
  const int* ri = src_i ? src_i + row * src_stride : nullptr;
  for (int t = threadIdx.x; t < kRun; t += blockDim.x) {
    const int p = run * kRun + t;
    const bool live = p < m;
    sv[t] = live ? rv[p] : INFINITY;
    si[t] = live ? (ri ? ri[p] : p) : INT_MAX;
  }
  __syncthreads();
  bitonic_sort_pairs(sv, si, kRun);
  if (runs == 1) {
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
      out_v[row * k + t] = sv[t];
      out_i[row * k + t] = si[t];
    }
    return;
  }
  const size_t out = row * len + (size_t)run * kRun;
  for (int t = threadIdx.x; t < kRun; t += blockDim.x) {
    dst_v[out + t] = sv[t];
    dst_i[out + t] = si[t];
  }
}

__device__ __forceinline__ bool pair_before(float va, int ia, float vb,
                                            int ib) {
  return va < vb || (va == vb && ia < ib);
}

// The merge path: how many of the first `diag` pairs of the stable merge of
// sorted lists a (na pairs) and b (nb pairs) come from a, a's pair going
// first between equal pairs.
__device__ __forceinline__ int merge_path(const float* av, const int* ai,
                                          int na, const float* bv,
                                          const int* bi, int nb, int diag) {
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int j = diag - 1 - mid;
    if (pair_before(bv[j], bi[j], av[mid], ai[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// Merge mode, step 3: one pass merges the sorted runs of `width` pairs two
// by two into runs of 2 * width, rows of len pairs; one block writes one
// tile of kMergeTile outputs (a tile never straddles two merges: 2 * width
// >= 2 * kRun is a multiple of it).  final: the pass makes the whole row,
// and only its first k pairs are written, to out (rows of k).
__global__ void __launch_bounds__(kMergeThreads)
merge_pass_kernel(const float* __restrict__ src_v,
                  const int* __restrict__ src_i, int len, int width,
                  float* __restrict__ dst_v, int* __restrict__ dst_i, int k,
                  bool final) {
  __shared__ float tv[kMergeTile];
  __shared__ int ti[kMergeTile];
  __shared__ int split[2];
  const int tiles = len / kMergeTile;
  const size_t row = blockIdx.x / tiles;
  const int o0 = (blockIdx.x % tiles) * kMergeTile;   // first output of
                                                      // the tile in the row
  const int pair0 = o0 / (2 * width) * (2 * width);
  const float* av = src_v + row * len + pair0;
  const int* ai = src_i + row * len + pair0;
  const float* bv = av + width;
  const int* bi = ai + width;
  const int d0 = o0 - pair0;
  if (threadIdx.x == 0 || threadIdx.x == 32)
    split[threadIdx.x >> 5] = merge_path(
        av, ai, width, bv, bi, width, d0 + (threadIdx.x >> 5) * kMergeTile);
  __syncthreads();
  const int a0 = split[0], na = split[1] - a0, b0 = d0 - a0;
  for (int t = threadIdx.x; t < kMergeTile; t += blockDim.x) {
    if (t < na) {
      tv[t] = av[a0 + t];
      ti[t] = ai[a0 + t];
    } else {
      tv[t] = bv[b0 + t - na];
      ti[t] = bi[b0 + t - na];
    }
  }
  __syncthreads();
  // this thread's kMergeItems outputs, from its own split of the tile's
  // two lists ([0, na) and [na, kMergeTile) of tv / ti)
  const int d = threadIdx.x * kMergeItems;
  int a = merge_path(tv, ti, na, tv + na, ti + na, kMergeTile - na, d);
  int b = na + d - a;
  float ov[kMergeItems];
  int oi[kMergeItems];
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    const bool take_a =
        b >= kMergeTile ||
        (a < na && !pair_before(tv[b], ti[b], tv[a], ti[a]));
    const int from = take_a ? a : b;
    ov[j] = tv[from];
    oi[j] = ti[from];
    a += take_a;
    b += !take_a;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    tv[d + j] = ov[j];
    ti[d + j] = oi[j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kMergeTile; t += blockDim.x) {
    const int o = o0 + t;
    if (final) {
      if (o < k) {
        dst_v[row * k + o] = tv[t];
        dst_i[row * k + o] = ti[t];
      }
    } else {
      dst_v[row * len + o] = tv[t];
      dst_i[row * len + o] = ti[t];
    }
  }
}

// The cluster route, select and merge mode, for rows of up to C x ITEMS x
// kClusterThreads elements: a cluster of C blocks a row (blockIdx.x / C),
// block `rank` holding positions [rank * slice, (rank + 1) * slice) as keys
// in registers, thread t positions rank * slice + j * kClusterThreads + t
// (j < ITEMS), so position order is (j, warp, lane) order within a block.
// Select mode: each block selects the k smallest of its own slice (they
// hold every one of the row's k smallest that lies in the slice), with no
// cluster traffic, and sends them to block 0's shared memory (sort_len
// values, then sort_len indices, the candidates of blocks 0 to C-1 in turn,
// padded with (+inf, INT_MAX)), which sorts them and writes the first k.
// Merge mode: the k-th smallest key of the whole row, from the C blocks'
// histograms; survivor g goes to slot g % per_k of block g / per_k, as a
// (value bits, index) pair, then the stable radix passes between two
// buffers of per_k pairs; a kBins counter row a warp follows them in
// dynamic shared memory.
// Registers: merge mode, and select mode with 32 keys a thread, may use
// 128 (one block an SM); the 16-key select keeps to 64 (two blocks).  At
// 64 the 32-key select spilled 356 bytes and ran 4-10% slower at SIFT1B's
// pair selects; at 128 the 16-key one ran slower (chip_sweep.py --only
// topk_ptxas, then --only topk --topk-lib on each build; PERF.md).
template <int ITEMS, bool MERGE>
__global__ void __launch_bounds__(kClusterThreads,
                                  MERGE || ITEMS == 32 ? 1 : 2)
cluster_topk_kernel(const float* __restrict__ x, int n, int k, int slice,
                    int per_k, int sort_len, float* __restrict__ out_v,
                    int* __restrict__ out_i) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  // the select's histograms, then the radix passes' block digit counts;
  // two of each, by pass parity, so that one cluster barrier a pass
  // separates a block's writes from the other blocks' reads
  __shared__ __align__(16) int hist[2][kBins];
  __shared__ int cells[ITEMS * kClusterWarps];
  __shared__ int goff[kBins], lstart[kBins];
  __shared__ int wsum[2][kBins / 32];
  __shared__ int s_mine, s_bucket, s_before, s_count, s_ties0, s_first,
      s_skip, s_total;

  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t row = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int p0 = rank * slice, p1 = min(n, p0 + slice);
  const int held = max(0, p1 - p0);
  const float* xr = x + row * n;
  // merge mode keeps the row's k smallest; select mode, a slice's
  const int kept = MERGE ? k : min(k, held);
  const bool all = MERGE ? k == n : kept == held;

  // Select mode's first access to another block's shared memory comes
  // after no cluster barrier: arrive now, wait before it, so that every
  // block of the cluster has started by then.
  if (!MERGE)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // 1. The slice, read once.  Keys lose the sign of zero: keep it aside.
  uint32_t key[ITEMS];
  uint32_t neg_zero = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int idx = p0 + j * kClusterThreads + tid;
    const float v = idx < p1 ? __ldg(xr + idx) : 0.0f;
    if (__float_as_uint(v) == 0x80000000u) neg_zero |= 1u << j;
    key[j] = float_key(v);
  }

  // 2. The kept-th smallest key, digit by digit from the top, as in
  //    radix_select_kernel: of the slice (select mode), or of the row
  //    (merge mode), from the sum of the C blocks' histograms read through
  //    DSMEM after a cluster barrier a pass.  Plain shared atomics: adding
  //    a warp's equal digits once, found by a ballot a digit bit, measured
  //    slower.
  uint32_t prefix = 0;
  int shift = 32;
  int need = kept;
  for (int pass = 0; !all && pass < 32 / kDigitBits; ++pass) {
    const int lo = shift - kDigitBits;
    int* h = hist[pass & 1];
    for (int b = tid; b < kBins; b += kClusterThreads) h[b] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int idx = p0 + j * kClusterThreads + tid;
      const bool live = idx < p1 && (shift == 32 ||
                                     (key[j] >> shift) == (prefix >> shift));
      if (live) atomicAdd(&h[(key[j] >> lo) & (kBins - 1)], 1);
    }
    if (MERGE)
      cluster.sync();                      // every block's histogram is done
    else
      __syncthreads();
    if (warp == 0) {
      constexpr int kPerLane = kBins / 32;
      static_assert(kPerLane == 8, "two int4 a lane");
      int c[kPerLane] = {};
      for (int r = 0; r < (MERGE ? C : 1); ++r) {
        const int4* q = reinterpret_cast<const int4*>(
            (MERGE ? cluster.map_shared_rank(h, r) : h) + lane * kPerLane);
        const int4 a = q[0], b = q[1];
        c[0] += a.x; c[1] += a.y; c[2] += a.z; c[3] += a.w;
        c[4] += b.x; c[5] += b.y; c[6] += b.z; c[7] += b.w;
      }
      int sum = 0;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) sum += c[i];
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      int run = incl - sum;
      if (run < need && need <= incl) {
        for (int i = 0; i < kPerLane; ++i) {
          if (need <= run + c[i]) {
            s_bucket = lane * kPerLane + i;
            s_before = run;
            s_count = c[i];
            break;
          }
          run += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)s_bucket << lo;
    need -= s_before;
    shift = lo;
    const bool whole = need == s_count;    // the bucket is taken whole
    __syncthreads();                       // s_* are written again
    if (whole) break;
  }

  // 3. Survivors in position order: every key below the cut and the first
  //    `need` ties.  (ties << 16) | below of every (item, warp) cell,
  //    scanned (at most 16384 of each a block: no carry); a warp's
  //    survivors of one item take consecutive slots.  Merge mode: block r's
  //    tie base and first slot are the counts of blocks 0 to r-1, read
  //    through DSMEM.  Select mode: block r's first slot is the count that
  //    blocks 0 to r-1 keep, min(k, their slice), known without asking.
  //    (Placing select mode's candidates in any order, through a shared
  //    counter, measured slower.)
  const uint32_t cut = prefix >> (shift & 31);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int idx = p0 + j * kClusterThreads + tid;
    const uint32_t hi = key[j] >> (shift & 31);
    const bool cand = idx < p1 && (all || hi <= cut);
    // most warps hold no candidate of an item: one ballot says so
    const unsigned cb = __ballot_sync(kFull, cand);
    const unsigned bb =
        cb ? __ballot_sync(kFull, cand && (all || hi < cut)) : 0u;
    if (lane == 0)
      cells[j * kClusterWarps + warp] = (__popc(cb & ~bb) << 16) | __popc(bb);
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kPer = ITEMS * kClusterWarps / 32;
    int c[kPer];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      c[i] = cells[lane * kPer + i];
      sum += c[i];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      cells[lane * kPer + i] = run;
      run += c[i];
    }
    if (lane == 31) s_mine = incl;
  }
  if (MERGE) {
    cluster.sync();                        // every block's counts are done
    if (tid == 0) {
      int tiebase = 0, first = 0;
      for (int r = 0; r < rank; ++r) {
        const int m = *cluster.map_shared_rank(&s_mine, r);
        const int ties = m >> 16;
        first += (m & 0xFFFF) + min(max(need - tiebase, 0), ties);
        tiebase += ties;
      }
      s_ties0 = tiebase;
      s_first = first;
    }
    __syncthreads();
  } else {
    if (tid == 0) {
      int first = 0, total = 0;
      for (int r = 0; r < C; ++r) {
        const int kr = min(k, max(0, min(slice, n - r * slice)));
        first += r < rank ? kr : 0;
        total += kr;
      }
      s_ties0 = 0;
      s_first = first;
      s_total = total;
    }
    __syncthreads();
    if (rank == 0) {                       // pad past every block's share
      int* si = reinterpret_cast<int*>(smem + sort_len);
      for (int t = s_total + tid; t < sort_len; t += kClusterThreads) {
        smem[t] = INFINITY;
        si[t] = INT_MAX;
      }
    }
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
  uint2* pairs = reinterpret_cast<uint2*>(smem);   // merge mode's buffers
  {
    const int tiebase = s_ties0, first = s_first;
    const int taken0 = min(need, tiebase);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int idx = p0 + j * kClusterThreads + tid;
      const uint32_t hi = key[j] >> (shift & 31);
      const bool cand = idx < p1 && (all || hi <= cut);
      const unsigned cb = __ballot_sync(kFull, cand);
      if (cb == 0) continue;
      const bool below = cand && (all || hi < cut);
      const bool tie = cand && !below;
      const unsigned bb = __ballot_sync(kFull, below);
      const unsigned tb = cb & ~bb;
      const int cell = cells[j * kClusterWarps + warp];
      const int below_before = (cell & 0xFFFF) + __popc(bb & lanes_below);
      const int ties_before = (cell >> 16) + __popc(tb & lanes_below);
      if (below || (tie && tiebase + ties_before < need)) {
        const int g = first + below_before +
                      min(need, tiebase + ties_before) - taken0;
        const float v = key_float(key[j], (neg_zero >> j) & 1u);
        if (MERGE) {
          const int b = g / per_k;
          cluster.map_shared_rank(pairs, b)[g - b * per_k] =
              make_uint2(__float_as_uint(v), (uint32_t)idx);
        } else {
          float* dv = cluster.map_shared_rank(smem, 0);
          dv[g] = v;
          reinterpret_cast<int*>(dv + sort_len)[g] = idx;
        }
      }
    }
  }
  cluster.sync();                          // every survivor is in place

  if (!MERGE) {
    // 4s. Block 0 sorts the candidates; the other blocks are done (no
    //     block reads their shared memory any more).
    if (rank != 0) return;
    int* si = reinterpret_cast<int*>(smem + sort_len);
    bitonic_sort_pairs(smem, si, sort_len);
    for (int t = tid; t < k; t += kClusterThreads) {
      out_v[row * k + t] = smem[t];
      out_i[row * k + t] = si[t];
    }
    return;
  }

  // 4m. Stable LSD radix passes over the k pairs, per_k a block.  A warp
  //     ranks a chunk of its block's pairs 32 at a time, holding them in
  //     registers (__match_any_sync finds the lanes of one digit, the
  //     highest of them bumps the warp's counter); the block partitions its
  //     pairs by digit in place, stably; then each block copies its run of
  //     every digit to the cluster-wide digit-major, block-minor offsets,
  //     which DSMEM gives: consecutive pairs go to consecutive slots, so a
  //     warp's remote stores are contiguous.
  const int m = min(max(k - rank * per_k, 0), per_k);
  const int chunk = per_k / kClusterWarps;   // a multiple of 32
  const int rounds = chunk / 32;
  int* whist = reinterpret_cast<int*>(pairs + 2 * per_k);
  int* my_hist = whist + warp * kBins;
  int cur = 0;
  for (int pass = 0; pass < 32 / kDigitBits; ++pass) {
    const int lo = pass * kDigitBits;
    uint2* buf = pairs + cur * per_k;
    for (int b = lane; b < kBins; b += 32) my_hist[b] = 0;
    __syncwarp();
    uint2 pr[kClusterRounds];
    int rk[kClusterRounds];
#pragma unroll
    for (int rd = 0; rd < kClusterRounds; ++rd) {
      if (rd >= rounds) break;
      const int e = warp * chunk + rd * 32 + lane;
      const bool live = e < m;
      pr[rd] = live ? buf[e] : make_uint2(0u, 0u);
      const uint32_t d =
          (float_key(__uint_as_float(pr[rd].x)) >> lo) & (kBins - 1);
      const unsigned peers = __match_any_sync(kFull, live ? d : kBins);
      const int leader = 31 - __clz(peers);
      int base = 0;
      if (lane == leader && live) {
        base = my_hist[d];
        my_hist[d] = base + __popc(peers);
      }
      rk[rd] = __shfl_sync(kFull, base, leader) + __popc(peers & lanes_below);
      __syncwarp();
    }
    __syncthreads();                       // every pair read, every rank
    int* bh = hist[pass & 1];
    if (tid == 0) s_skip = 0;
    if (tid < kBins) {
      int run = 0;
      for (int w = 0; w < kClusterWarps; ++w) {
        const int c = whist[w * kBins + tid];
        whist[w * kBins + tid] = run;
        run += c;
      }
      bh[tid] = run;
    }
    cluster.sync();                        // every block's counts are done
    if (tid < kBins) {
      // digit-major starts: of this block's run of digit tid within the
      // block (local) and within the cluster's k pairs (global)
      int total = 0, before = 0;
      for (int r = 0; r < C; ++r) {
        const int c = cluster.map_shared_rank(bh, r)[tid];
        total += c;
        before += r < rank ? c : 0;
      }
      if (total == k) s_skip = 1;          // every key shares this digit
      const int mine = bh[tid];
      int gi = total, li = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, gi, off);
        const int u = __shfl_up_sync(kFull, li, off);
        if (lane >= off) {
          gi += t;
          li += u;
        }
      }
      if (lane == 31) {
        wsum[0][warp] = gi;
        wsum[1][warp] = li;
      }
      goff[tid] = gi - total + before;
      lstart[tid] = li - mine;
    }
    __syncthreads();
    if (s_skip) continue;                  // the pass would keep the order
    if (tid < kBins) {
      int g = 0, l = 0;
      for (int w = 0; w < warp; ++w) {
        g += wsum[0][w];
        l += wsum[1][w];
      }
      goff[tid] += g;
      lstart[tid] += l;
    }
    __syncthreads();
#pragma unroll
    for (int rd = 0; rd < kClusterRounds; ++rd) {
      if (rd >= rounds) break;
      if (warp * chunk + rd * 32 + lane < m) {
        const uint32_t d =
            (float_key(__uint_as_float(pr[rd].x)) >> lo) & (kBins - 1);
        buf[lstart[d] + my_hist[d] + rk[rd]] = pr[rd];
      }
    }
    __syncthreads();                       // the block's pairs by digit
    uint2* dst = pairs + (cur ^ 1) * per_k;
    for (int t = tid; t < m; t += kClusterThreads) {
      const uint2 p = buf[t];
      const uint32_t d = (float_key(__uint_as_float(p.x)) >> lo) & (kBins - 1);
      const int g = goff[d] + t - lstart[d];
      const int b = g / per_k;
      cluster.map_shared_rank(dst, b)[g - b * per_k] = p;
    }
    cluster.sync();                        // every pair is in its new slot
    cur ^= 1;
  }
  const uint2* buf = pairs + cur * per_k;
  const size_t out = row * k + (size_t)rank * per_k;
  for (int e = tid; e < m; e += kClusterThreads) {
    const uint2 p = buf[e];
    out_v[out + e] = __uint_as_float(p.x);
    out_i[out + e] = (int)p.y;
  }
  cluster.sync();          // no block leaves while another reads its counts
}

using ClusterKernel = void (*)(const float*, int, int, int, int, int, float*,
                               int*);

constexpr int kMaxDevices = 64;
// The cluster route's most dynamic shared memory: merge mode's two buffers
// of kClusterRun pairs and its warps' counters (144 KB).
constexpr int kClusterSmem =
    2 * kClusterRun * (int)(sizeof(float) + sizeof(int)) +
    kClusterWarps * kBins * (int)sizeof(int);

// Dynamic shared memory for the longest sort: 128 KB, above the 48 KB a
// kernel gets without asking.
template <typename Kernel>
cudaError_t allow_sort_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSort * (int)(sizeof(float) + sizeof(int)));
}

template <typename Kernel>
cudaError_t allow_cluster_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem);
}

// Raise the dynamic shared-memory limit of every variant, once per device.
cudaError_t configure() {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (configured[dev]) return cudaSuccess;
  const cudaError_t errs[] = {
      allow_sort_smem(bitonic_sort_kernel),
      allow_sort_smem(radix_select_kernel<4, true, false>),
      allow_sort_smem(radix_select_kernel<8, true, false>),
      allow_sort_smem(radix_select_kernel<16, true, false>),
      allow_sort_smem(radix_select_kernel<32, true, false>),
      allow_sort_smem(radix_select_kernel<32, false, false>),
      allow_sort_smem(run_sort_kernel),
      allow_cluster_smem(cluster_topk_kernel<16, false>),
      allow_cluster_smem(cluster_topk_kernel<32, false>),
      allow_cluster_smem(cluster_topk_kernel<16, true>),
      allow_cluster_smem(cluster_topk_kernel<32, true>)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  configured[dev] = true;
  return cudaSuccess;
}

// Whether a cluster of cfg's shape can be resident at all (C blocks of
// cfg's shared memory on C free SMs of one GPC): a launch the card refuses
// never runs.  Asked once a (device, variant, C), and again only for more
// shared memory than was found to fit.
cudaError_t check_cluster(ClusterKernel kernel, int variant,
                          const cudaLaunchConfig_t& cfg, int cluster) {
  static size_t fits[kMaxDevices][4][kMaxCluster + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  size_t& ok = fits[dev][variant][cluster];
  if (cfg.dynamicSmemBytes <= ok) return cudaSuccess;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  ok = cfg.dynamicSmemBytes;
  return cudaSuccess;
}

bool power_of_two(int v) { return v > 0 && (v & (v - 1)) == 0; }

int round_up(int v, int step) { return (v + step - 1) / step * step; }

}  // namespace

// x: (rows, n) float32; writes (rows, k) values and int32 column indices.
// mode 0 (sort): threads <= 1024, sort_len the power of two >= n, n <=
// 16384.  mode 1 (select): `items` keys a thread (4, 8, 16 or 32, and 32
// for a row longer than items * threads), threads a multiple of 32 up to
// 512, sort_len the power of two >= k, k <= 16384, n <= 2^30.  The wrapper
// (_topk_plan) picks these.  Returns the CUDA error code of the launch (0 =
// success).
extern "C" int pqt_topk(const float* x, int rows, int n, int k, int mode,
                        int items, int threads, int sort_len, float* out_v,
                        int* out_i, void* stream) {
  if (rows < 1 || k < 1 || k > n || !power_of_two(sort_len) ||
      sort_len > kMaxSort)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)sort_len * (sizeof(float) + sizeof(int));
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    if (n > sort_len || threads < 1 || threads > 1024)
      return (int)cudaErrorInvalidValue;
    bitonic_sort_kernel<<<rows, threads, smem, s>>>(x, n, sort_len, k, out_v,
                                                    out_i);
    return (int)cudaGetLastError();
  }
  if (mode != 1 || k > sort_len || n > kMaxSelectRow || threads % 32 ||
      threads < 32 || threads > kSelectThreads)
    return (int)cudaErrorInvalidValue;
  const bool resident = (long long)items * threads >= n;
  switch (resident ? items : -items) {
    case 4:
      radix_select_kernel<4, true, false><<<rows, threads, smem, s>>>(
          x, n, k, sort_len, out_v, out_i);
      break;
    case 8:
      radix_select_kernel<8, true, false><<<rows, threads, smem, s>>>(
          x, n, k, sort_len, out_v, out_i);
      break;
    case 16:
      radix_select_kernel<16, true, false><<<rows, threads, smem, s>>>(
          x, n, k, sort_len, out_v, out_i);
      break;
    case 32:
      radix_select_kernel<32, true, false><<<rows, threads, smem, s>>>(
          x, n, k, sort_len, out_v, out_i);
      break;
    case -32:
      radix_select_kernel<32, false, false><<<rows, threads, smem, s>>>(
          x, n, k, sort_len, out_v, out_i);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Merge mode (k > 16384, or a whole row of more than 16384): x (rows, n)
// float32 -> (rows, k) values and int32 indices, like the other modes.
// len: pairs of a scratch row, a power of two >= max(k, 16384), <= 2^20;
// select_threads: the select's block (a multiple of 32 up to 512), used
// when k < n.  v0/i0 and v1/i1: two scratch buffers of rows x len pairs the
// caller allocates (the runs, and the merge passes' ping-pong).  Returns the
// CUDA error code of the first launch that failed (0 = success).
extern "C" int pqt_topk_merge(const float* x, int rows, int n, int k,
                              int select_threads, int len, float* v0,
                              int* i0, float* v1, int* i1, float* out_v,
                              int* out_i, void* stream) {
  if (rows < 1 || k < 1 || k > n || n > kMaxSelectRow ||
      !power_of_two(len) || len < kRun || len > kMaxMerge || len < k ||
      select_threads % 32 || select_threads < 32 ||
      select_threads > kSelectThreads)
    return (int)cudaErrorInvalidValue;
  const int runs = len / kRun;
  if ((long long)rows * (len / kMergeTile) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t run_smem = (size_t)kRun * (sizeof(float) + sizeof(int));
  if (k < n) {
    radix_select_kernel<32, false, true><<<rows, select_threads, 0, s>>>(
        x, n, k, len, v0, i0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    run_sort_kernel<<<rows * runs, kRunThreads, run_smem, s>>>(
        v0, i0, len, k, runs, len, v0, i0, k, out_v, out_i);
  } else {
    run_sort_kernel<<<rows * runs, kRunThreads, run_smem, s>>>(
        x, nullptr, n, n, runs, len, v0, i0, k, out_v, out_i);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  float* cv = v0;
  int* ci = i0;
  float* nv = v1;
  int* ni = i1;
  for (int width = kRun; width < len; width *= 2) {
    const bool final = 2 * width == len;
    merge_pass_kernel<<<rows * (len / kMergeTile), kMergeThreads, 0, s>>>(
        cv, ci, len, width, final ? out_v : nv, final ? out_i : ni, k, final);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    float* tv = cv;
    int* ti = ci;
    cv = nv;
    ci = ni;
    nv = tv;
    ni = ti;
  }
  return 0;
}

// Cluster route (select mode when merge == 0, merge mode otherwise): x
// (rows, n) float32 -> (rows, k) values and int32 indices, like the other
// modes, one cluster of `cluster` blocks (2 to 8) a row.  threads: 512;
// items: keys a thread holds (16 or 32), with ceil(n / cluster) rounded up
// to a multiple of 512 at most items x 512.  sort_len: select, the power of
// two >= min(n, cluster x k), at most 16384 (the candidates block 0
// sorts); merge, the pairs a block holds, ceil(k / cluster) rounded up to a
// multiple of 512, at most 8192.  Returns the CUDA
// error code (0 = success; cudaErrorInvalidConfiguration when no cluster
// of that shape fits the card).
extern "C" int pqt_topk_cluster(const float* x, int rows, int n, int k,
                                int cluster, int items, int threads,
                                int sort_len, int merge, float* out_v,
                                int* out_i, void* stream) {
  if (rows < 1 || k < 1 || k > n || cluster < 2 || cluster > kMaxCluster ||
      threads != kClusterThreads || (items != 16 && items != 32) ||
      (long long)rows * cluster > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int slice = round_up((n + cluster - 1) / cluster, threads);
  if (slice > items * threads) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  if (merge) {
    if (sort_len != round_up((k + cluster - 1) / cluster, threads) ||
        sort_len > kClusterRun)
      return (int)cudaErrorInvalidValue;
    smem = (size_t)sort_len * 2 * (sizeof(float) + sizeof(int)) +
           (size_t)kClusterWarps * kBins * sizeof(int);
  } else {
    if (!power_of_two(sort_len) || sort_len < min(n, cluster * k) ||
        sort_len > kMaxSort)
      return (int)cudaErrorInvalidValue;
    smem = (size_t)sort_len * (sizeof(float) + sizeof(int));
  }
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  const ClusterKernel kernel =
      merge ? (items == 16 ? cluster_topk_kernel<16, true>
                           : cluster_topk_kernel<32, true>)
            : (items == 16 ? cluster_topk_kernel<16, false>
                           : cluster_topk_kernel<32, false>);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = check_cluster(kernel, 2 * (merge != 0) + (items == 32), cfg,
                      cluster);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, x, n, k, slice, merge ? sort_len : 0,
                           sort_len, out_v, out_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
