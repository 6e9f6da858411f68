// Kernel C: the line re-rank of candidates read from the payload by position.
//
//   ids[b, k]   = payload[pos[b, k], 0]
//   dists[b, k] = valid[b, k] ? t3 + sum_j (1 - lam_j) * q[b, j, A_j]
//                                           + lam_j * q[b, j, B_j] : +inf
//
// with t3 the float bits of word 1 of the row and (A_j, B_j, lam_j) the
// line codes of line part j.  Two layouts of the line parts:
//
// * compact (c1 <= 16): word 2 + j/2 holds line part j in its (j % 2)-th
//   16-bit half as A | B << 4 | lam_u8 << 8, lam = lam_u8 * 8/256 - 4;
// * wide (c1 <= 256): word 2 + j is one uint32 per line part,
//   A | B << 8 | lam_u16 << 16, lam = lam_u16 * 8/65536 - 4 (8-bit lambdas
//   sit in the high byte of lam_u16; exact in float32).
//
// Replaces the TPU kernel pqt_tpu/ops/pallas/rerank.py:rerank_fused and, in
// front of it, the payload-row gather (kernel H,
// benchmarks/micro_gather2.py:pallas_dma_gather) that every line re-rank
// ran first: the JAX package gathers the candidates' rows into a (B, K, W)
// array and the Pallas kernel reads it back, transposed to (B, W, K) with
// the tables lane-padded to 128, because Mosaic gathers only along lanes.
// Here each candidate's row is read once, through its CSR position, and
// only its id and distance are written.  The Pallas kernel's contract
// (rows already gathered) is the same kernel over the rows as a payload of
// B * K rows with identity positions (pos == nullptr).
//
// What bounds it on the H100: bytes.  A candidate moves its row (40 bytes at
// SIFT1M, 72 at SIFT1B's lp 32 compact, 136 wide), its position (4) and
// validity flag (1) in and its id and distance (8) out, against about
// 4 * lp flops; the rows are random reads at row grain, so only the loads
// in flight hide their latency.  The query's (lp, c1) table is 1-2 KB
// compact and up to 32 KB wide at c1 = 256 (64 KB at lp 64), read from
// shared memory with random indices.  The design:
//
//   * a block serves a run of tiles of one query, 256 candidates a tile,
//     and copies the query's table into shared memory once (16-byte
//     cp.async where the table is aligned, completing with the first
//     tile's rows), not once per 256 candidates; the number
//     of blocks a query comes from `_rerank_plan`
//     (pqt_tpu_torch/ops/cuda/rerank.py) so that the grid fills the SMs
//     once;
//   * the rows of a tile are staged into shared memory with cp.async,
//     double-buffered: while a tile is decoded, the next tile's rows are in
//     flight.  Thread i loads the position of row i of a tile (coalesced)
//     two tiles ahead and keeps it; the tile's positions go to shared
//     memory, and the block then copies the tile's rows in units of the
//     widest of 16, 8 or 4 bytes that divides the row and the payload's
//     address (kernel H's rule: 8 bytes for the 40-, 72- and 136-byte
//     rows), consecutive threads on consecutive units, so a row is one run
//     of coalesced loads and every thread has about W * 4 / unit loads in
//     flight a tile;
//   * one thread decodes one row from shared memory: words in pairs where W
//     is even (8-byte loads; a row stride of W / 2 8-byte words, odd for
//     every SIFT shape, is free of bank conflicts), else one at a time.  The
//     per-row arithmetic is the earlier kernel's: acc = t3, then each term
//     (1 - lam) * qa + lam * qb added in ascending j, each rounded as its
//     compiled code rounded it (`line_term`), so the distances are
//     bit-for-bit what it gave.  A stride pad of the table (c1 + 1 floats)
//     cannot remove the table's bank conflicts: every lane of a warp reads
//     line part j at the same time, so a pad moves all its addresses by
//     the same amount;
//   * no table cap: up to 227 KB of shared memory a block is taken through
//     the opt-in dynamic limit.  A table that does not fit beside the row
//     buffers is read from global memory (L1 and L2), with the same sums;
//     rows too long to double-buffer 256 of (W > 112 words) are read by
//     each thread straight from global memory;
//   * the row is read whatever `valid` says (an invalid slot's id is the
//     id of the row read, as in the JAX package); an invalid slot's
//     distance is +inf.  A position outside [0, n_rows) reads nothing: id
//     0 and distance +inf, as the JAX package pads a slab window that runs
//     past a payload shorter than a slab;
//   * candidate, tile and row indices are 32-bit; only the byte address of
//     a row (pos * W * 4) and the query's output offset (b * K) are 64-bit.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;          // candidates a tile, one a thread
constexpr int kSmemMax = 232448;       // 227 KB: a block's opt-in limit
constexpr int kMaxDevices = 64;

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <bool TSMEM>
__device__ __forceinline__ float tab(const float* qt, int i) {
  return TSMEM ? qt[i] : __ldg(qt + i);
}

// Line part j's term (1 - lam) * qa + lam * qb, rounded as the earlier
// kernel's compiled code rounded it: (1 - lam) * qa, then lam * qb fused
// onto it.  Spelled out, so that no contraction choice of the compiler can
// change a distance's last bit.
__device__ __forceinline__ float line_term(float lam, float qa, float qb) {
  return __fmaf_rn(lam, qb, __fmul_rn(1.0f - lam, qa));
}

// Adds the terms of payload word m (m >= 2) to acc, in ascending j.
template <bool COMPACT, bool TSMEM>
__device__ __forceinline__ void add_word(unsigned w, int m, int lp, int c1,
                                         const float* qt, float& acc) {
  if (COMPACT) {
    const int j0 = 2 * (m - 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h;
      if (j >= lp) break;
      const unsigned half = (w >> (16 * h)) & 0xFFFFu;
      const unsigned a = half & 0xFu;
      const unsigned bb = (half >> 4) & 0xFu;
      const float lam = (float)((half >> 8) & 0xFFu) * 0.03125f - 4.0f;
      acc = __fadd_rn(acc, line_term(lam, tab<TSMEM>(qt, j * c1 + a),
                                     tab<TSMEM>(qt, j * c1 + bb)));
    }
  } else {
    const int j = m - 2;
    const unsigned a = w & 0xFFu;
    const unsigned bb = (w >> 8) & 0xFFu;
    const float lam = (float)(w >> 16) * (1.0f / 8192.0f) - 4.0f;
    acc = __fadd_rn(acc, line_term(lam, tab<TSMEM>(qt, j * c1 + a),
                                   tab<TSMEM>(qt, j * c1 + bb)));
  }
}

// The distance of one row (acc = t3, then the terms in ascending j); `row`
// is in shared memory (STAGED) or global memory.
template <bool COMPACT, bool TSMEM, bool STAGED>
__device__ __forceinline__ float line_dist(const int* row, int W, int lp,
                                           int c1, const float* qt) {
  float acc;
  if (STAGED && (W & 1) == 0) {
    const uint2* r2 = reinterpret_cast<const uint2*>(row);
    acc = __int_as_float((int)r2[0].y);
    for (int m = 1; m < W / 2; ++m) {
      const uint2 w = r2[m];
      add_word<COMPACT, TSMEM>(w.x, 2 * m, lp, c1, qt, acc);
      add_word<COMPACT, TSMEM>(w.y, 2 * m + 1, lp, c1, qt, acc);
    }
  } else {
    acc = __int_as_float(STAGED ? row[1] : __ldg(row + 1));
    for (int m = 2; m < W; ++m)
      add_word<COMPACT, TSMEM>(
          (unsigned)(STAGED ? row[m] : __ldg(row + m)), m, lp, c1, qt, acc);
  }
  return acc;
}

template <bool COMPACT, bool TSMEM, bool STAGED>
__device__ __forceinline__ void decode(const int* row, int p, int n_rows,
                                       int k, int K, long long out0, int W,
                                       int lp, int c1, const float* qt,
                                       const unsigned char* valid, int* ids,
                                       float* dists) {
  if (k >= K) return;
  const bool inside = (unsigned)p < (unsigned)n_rows;
  const bool live = inside && (valid == nullptr || valid[out0 + k]);
  ids[out0 + k] = inside ? (STAGED ? row[0] : __ldg(row)) : 0;
  dists[out0 + k] = live ? line_dist<COMPACT, TSMEM, STAGED>(row, W, lp, c1,
                                                            qt)
                         : __int_as_float(0x7f800000);   // +inf
}

// Position of candidate k of the block's query: pos[b, k], or b * K + k
// (identity positions, pos == nullptr); -1 past the last candidate.
__device__ __forceinline__ int position(const int* pb, long long out0, int k,
                                        int K) {
  if (k >= K) return -1;
  return pb ? __ldg(pb + k) : (int)(out0 + k);
}

// Issues the copies of one tile's rows (positions in spos; rows outside
// the payload or past K are not read) into `dst`, W ints a row.
template <int UNIT>
__device__ __forceinline__ void copy_tile(const int* payload, int n_rows,
                                          int W, const int* spos, int* dst,
                                          int r, int u, int upr, int step_r,
                                          int step_u) {
  const char* src = reinterpret_cast<const char*>(payload);
  char* out = reinterpret_cast<char*>(dst);
  for (int i = 0; i < upr; ++i) {
    const int p = spos[r];
    if ((unsigned)p < (unsigned)n_rows)
      cp_async<UNIT>(out + (r * W * 4 + u * UNIT),
                     src + ((long long)p * W * 4 + u * UNIT));
    r += step_r;
    u += step_u;
    if (u >= upr) {
      u -= upr;
      ++r;
    }
  }
}

// Issues the copies of the query's (lp, c1) floats into the block's
// shared-memory table, 16 bytes a copy where the table is aligned: they
// complete with the first tile's rows, so no thread waits for them first.
__device__ __forceinline__ void copy_table(const float* qb, int nq,
                                           float* qs) {
  if (((size_t)qb & 15) == 0 && (nq & 3) == 0) {
    for (int t = threadIdx.x; t < nq / 4; t += kThreads)
      cp_async<16>(qs + 4 * t, qb + 4 * t);
  } else {
    for (int t = threadIdx.x; t < nq; t += kThreads)
      cp_async<4>(qs + t, qb + t);
  }
}

// STAGED: rows double-buffered through shared memory by cp.async in units
// of UNIT bytes; otherwise each thread reads its row from global memory.
// TSMEM: the query table in shared memory, else read from global memory.
template <bool COMPACT, bool STAGED, bool TSMEM, int UNIT>
__global__ void __launch_bounds__(kThreads)
gather_rerank_kernel(const int* __restrict__ payload, int n_rows, int W,
                     const int* __restrict__ pos,
                     const unsigned char* __restrict__ valid, int K,
                     int chunks, int per_chunk, const float* __restrict__ q,
                     int lp, int c1, int* __restrict__ ids,
                     float* __restrict__ dists) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / chunks;
  const int chunk = blockIdx.x - b * chunks;
  const int tid = threadIdx.x;
  const int n_tiles = (K + kThreads - 1) / kThreads;
  const int t0 = chunk * per_chunk;
  const int t1 = min(t0 + per_chunk, n_tiles);
  const int nq = lp * c1;
  const long long out0 = (long long)b * K;
  const int* pb = pos ? pos + out0 : nullptr;

  int* rows = reinterpret_cast<int*>(smem);               // [2][256][W]
  int* spos = rows + (STAGED ? 2 * kThreads * W : 0);      // [2][256]
  float* qs = reinterpret_cast<float*>(spos + (STAGED ? 2 * kThreads : 0));
  const float* qb = q + (long long)b * nq;
  if (TSMEM) copy_table(qb, nq, qs);
  const float* qt = TSMEM ? qs : qb;

  if (!STAGED) {
    if (TSMEM) {
      cp_async_wait_all();
      __syncthreads();
    }
    for (int t = t0; t < t1; ++t) {
      const int k = t * kThreads + tid;
      const int p = position(pb, out0, k, K);
      const int* row = payload + (long long)((unsigned)p < (unsigned)n_rows
                                                 ? p : 0) * W;
      decode<COMPACT, TSMEM, false>(row, p, n_rows, k, K, out0, W, lp, c1,
                                    qt, valid, ids, dists);
    }
    return;
  }

  // thread tid copies units tid, tid + 256, ... of a tile: unit f is unit
  // f % upr of row f / upr, walked without a division
  const int upr = W * 4 / UNIT;
  const int r0 = tid / upr, u0 = tid - (tid / upr) * upr;
  const int step_r = kThreads / upr, step_u = kThreads - step_r * upr;

  // tile t's rows and positions sit in buffer (t - t0) & 1
  int p_cur = position(pb, out0, t0 * kThreads + tid, K);
  int p_next = t0 + 1 < t1 ? position(pb, out0, (t0 + 1) * kThreads + tid, K)
                           : -1;
  spos[tid] = p_cur;
  __syncthreads();                    // the tile's positions
  copy_tile<UNIT>(payload, n_rows, W, spos, rows, r0, u0, upr, step_r,
                  step_u);
  cp_async_commit();                  // the table and tile t0's rows
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    // the other buffer's positions were last read by the copies of tile
    // t - 1, issued before the last barrier
    if (t + 1 < t1) spos[(buf ^ 1) * kThreads + tid] = p_next;
    // every thread is past the decode of tile t - 1 (its row buffer is
    // free) and has written tile t + 1's positions
    __syncthreads();
    if (t + 1 < t1)
      copy_tile<UNIT>(payload, n_rows, W, spos + (buf ^ 1) * kThreads,
                      rows + (buf ^ 1) * kThreads * W, r0, u0, upr, step_r,
                      step_u);
    cp_async_commit();
    const int p_after =
        t + 2 < t1 ? position(pb, out0, (t + 2) * kThreads + tid, K) : -1;
    cp_async_wait_one();              // this thread's copies of tile t
    __syncthreads();                  // everyone's
    decode<COMPACT, TSMEM, true>(rows + (buf * kThreads + tid) * W, p_cur,
                                 n_rows, t * kThreads + tid, K, out0, W, lp,
                                 c1, qt, valid, ids, dists);
    p_cur = p_next;
    p_next = p_after;
  }
}

template <bool COMPACT, bool STAGED, bool TSMEM, int UNIT>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(
      gather_rerank_kernel<COMPACT, STAGED, TSMEM, UNIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

template <bool COMPACT>
cudaError_t allow_layout() {
  const cudaError_t errs[] = {
      allow_smem<COMPACT, true, true, 16>(),
      allow_smem<COMPACT, true, true, 8>(),
      allow_smem<COMPACT, true, true, 4>(),
      allow_smem<COMPACT, true, false, 16>(),
      allow_smem<COMPACT, true, false, 8>(),
      allow_smem<COMPACT, true, false, 4>(),
      allow_smem<COMPACT, false, true, 4>(),
      allow_smem<COMPACT, false, false, 4>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

// Raise the dynamic shared-memory limit of every variant, once per device.
cudaError_t configure() {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (configured[dev]) return cudaSuccess;
  err = allow_layout<true>();
  if (err == cudaSuccess) err = allow_layout<false>();
  if (err == cudaSuccess) configured[dev] = true;
  return err;
}

template <bool COMPACT, bool STAGED, bool TSMEM, int UNIT>
void launch(int blocks, int smem, cudaStream_t s, const int* payload,
            int n_rows, int W, const int* pos, const unsigned char* valid,
            int K, int chunks, int per_chunk, const float* q, int lp, int c1,
            int* ids, float* dists) {
  gather_rerank_kernel<COMPACT, STAGED, TSMEM, UNIT>
      <<<blocks, kThreads, smem, s>>>(payload, n_rows, W, pos, valid, K,
                                      chunks, per_chunk, q, lp, c1, ids,
                                      dists);
}

template <bool COMPACT, bool STAGED, bool TSMEM>
cudaError_t by_unit(int unit, int blocks, int smem, cudaStream_t s,
                    const int* payload, int n_rows, int W, const int* pos,
                    const unsigned char* valid, int K, int chunks,
                    int per_chunk, const float* q, int lp, int c1, int* ids,
                    float* dists) {
  if constexpr (!STAGED) {       // rows read as words: no copy unit
    launch<COMPACT, false, TSMEM, 4>(blocks, smem, s, payload, n_rows, W,
                                     pos, valid, K, chunks, per_chunk, q, lp,
                                     c1, ids, dists);
    return cudaGetLastError();
  }
  switch (unit) {
    case 16:
      launch<COMPACT, STAGED, TSMEM, 16>(blocks, smem, s, payload, n_rows, W,
                                         pos, valid, K, chunks, per_chunk, q,
                                         lp, c1, ids, dists);
      break;
    case 8:
      launch<COMPACT, STAGED, TSMEM, 8>(blocks, smem, s, payload, n_rows, W,
                                        pos, valid, K, chunks, per_chunk, q,
                                        lp, c1, ids, dists);
      break;
    case 4:
      launch<COMPACT, STAGED, TSMEM, 4>(blocks, smem, s, payload, n_rows, W,
                                        pos, valid, K, chunks, per_chunk, q,
                                        lp, c1, ids, dists);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool COMPACT>
cudaError_t by_mode(int staged, int table_smem, int unit, int blocks,
                    int smem, cudaStream_t s, const int* payload, int n_rows,
                    int W, const int* pos, const unsigned char* valid, int K,
                    int chunks, int per_chunk, const float* q, int lp, int c1,
                    int* ids, float* dists) {
  if (staged && table_smem)
    return by_unit<COMPACT, true, true>(unit, blocks, smem, s, payload,
                                        n_rows, W, pos, valid, K, chunks,
                                        per_chunk, q, lp, c1, ids, dists);
  if (staged)
    return by_unit<COMPACT, true, false>(unit, blocks, smem, s, payload,
                                         n_rows, W, pos, valid, K, chunks,
                                         per_chunk, q, lp, c1, ids, dists);
  if (table_smem)
    return by_unit<COMPACT, false, true>(unit, blocks, smem, s, payload,
                                         n_rows, W, pos, valid, K, chunks,
                                         per_chunk, q, lp, c1, ids, dists);
  return by_unit<COMPACT, false, false>(unit, blocks, smem, s, payload,
                                        n_rows, W, pos, valid, K, chunks,
                                        per_chunk, q, lp, c1, ids, dists);
}

}  // namespace

// payload: (n_rows, W) int32; pos: (B, K) int32 rows of the payload, or
// nullptr for positions b * K + k; valid: (B, K) bytes (bool), or nullptr
// for all valid; q: (B, lp, c1) float32; ids: (B, K) int32; dists: (B, K)
// float32.  compact: the 16-bit layout (W = 2 + ceil(lp / 2), c1 <= 16),
// else the wide one (W = 2 + lp, c1 <= 256).  The launch shape comes from
// the plan: staged rows (unit bytes a copy), the table in shared memory or
// not, `smem` bytes of dynamic shared memory, `chunks` blocks a query of
// `per_chunk` tiles each.  Returns the CUDA error code (0 = success).
extern "C" int pqt_gather_rerank(const int* payload, int n_rows, int W,
                                 const int* pos, const unsigned char* valid,
                                 int B, int K, const float* q, int lp, int c1,
                                 int compact, int staged, int table_smem,
                                 int unit, int smem, int chunks,
                                 int per_chunk, int* ids, float* dists,
                                 void* stream) {
  const int n_tiles = (K + kThreads - 1) / kThreads;
  if (B <= 0 || K <= 0 || n_rows < 0 || lp <= 0 || c1 <= 0 ||
      W != 2 + (compact ? (lp + 1) / 2 : lp) || c1 > (compact ? 16 : 256) ||
      smem < 0 || smem > kSmemMax || chunks <= 0 || per_chunk <= 0 ||
      (long long)chunks * per_chunk < n_tiles ||
      (long long)(chunks - 1) * per_chunk >= n_tiles ||
      (long long)B * chunks > INT_MAX ||
      (pos == nullptr && (long long)B * K > n_rows))
    return (int)cudaErrorInvalidValue;
  // the shared memory the kernel's layout takes: [2][256][W] rows and
  // [2][256] positions when staged, then the table when it is shared
  const long long need =
      (staged ? (2LL * kThreads * W + 2 * kThreads) * 4 : 0) +
      (table_smem ? (long long)lp * c1 * 4 : 0);
  if (smem < need) return (int)cudaErrorInvalidValue;
  if (staged && (unit < 4 || (W * 4) % unit || (size_t)payload % unit))
    return (int)cudaErrorMisalignedAddress;
  const cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = B * chunks;
  return (int)(compact
                   ? by_mode<true>(staged, table_smem, unit, blocks, smem, s,
                                   payload, n_rows, W, pos, valid, K, chunks,
                                   per_chunk, q, lp, c1, ids, dists)
                   : by_mode<false>(staged, table_smem, unit, blocks, smem,
                                    s, payload, n_rows, W, pos, valid, K,
                                    chunks, per_chunk, q, lp, c1, ids,
                                    dists));
}
