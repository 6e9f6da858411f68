// The exact re-rank's distances: out[b, k] = sum_j (float(tab[pos[b, k], j])
// - q[b, j])^2, with tab (n_rows, dim) uint8 or float32, pos (B, K) int32 and
// q (B, dim) float32.
//
// Replaces, on the exact re-rank, two TPU kernels and the elementwise passes
// XLA fused between them: benchmarks/micro_gather2.py:pallas_dma_gather
// (kernel H, the raw rows of the candidates) and
// pqt_tpu/ops/pallas/primitives.py:segmented_reduce (kernel D, the row
// sums), with the float copy, the difference and the square in between.  In
// the JAX package the computation is one fused expression
// (pqt_tpu/models/query.py: vecs.astype(f32) - queries[:, None, :], squared
// and summed); run as five launches it wrote and read the gathered rows
// three more times, as float32, four times their bytes.
//
// What bounds it on the H100: bytes.  Each candidate row is read once and
// one float is written for it, against 2 * dim operations a row; at SIFT
// width (128 uint8) that is 128 bytes in and 4 out a row, plus the position.
// The rows are random at row grain, so only the number of loads in flight
// hides the latency.  The design:
//
//   * a group of G lanes owns one row: the row is cut into units of the
//     widest of 16, 8, 4, 2 or 1 bytes that divides it and to which the
//     table is aligned (16 bytes at dim 128, so 8 lanes of one load each);
//     G is the units a row has, as a power of two from 4 to 32, and a lane
//     takes units lane, lane + G, ... when a row has more than 32 (dim 960);
//   * the groups of a block serve rows of one query, so each lane keeps its
//     slice of the query (the elements of its first two units) in registers
//     for every row it visits; units past those read the query from memory;
//   * each group has kRows rows in flight: their positions and then all
//     their units are loaded before any is summed, so a lane has at least
//     four 16-byte loads outstanding; every lane of a group loads the same
//     position, one transaction a row;
//   * a lane sums its units' elements in order, the group then adds its
//     lanes' sums in a shuffle tree, and lane 0 writes;
//   * row and lane indices are 32-bit; only the byte address of a row,
//     pos * row_bytes, is computed in 64 bits.
//
// Sum order: with uint8 rows and integer-valued queries at dim 128 every
// term is an integer of at most 255^2 = 65025 and every partial sum is
// below 128 * 65025 = 8,323,200 < 2^24, so the float32 result is exact in
// any order and equals the plain version to the bit.  For other queries, or
// for dim 960 where the sums pass 2^24, it differs from it by the order of
// the additions only (relative 1e-5).
//
// A position outside [0, n_rows) reads nothing and yields NaN; callers map
// an invalid slot to row 0 first and mask its distance themselves.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;        // rows a group has in flight

template <typename T, typename V>
union Unit {
  V v;
  T e[sizeof(V) / sizeof(T)];
};

template <typename T, typename V, int G, int UPL>
__global__ void __launch_bounds__(kThreads)
gather_sqdist_kernel(const V* __restrict__ tab, long long n_rows, int units,
                     const int* __restrict__ pos, int k, int chunks,
                     const float* __restrict__ q, int dim,
                     float* __restrict__ out) {
  constexpr int E = sizeof(V) / sizeof(T);   // elements in a unit
  constexpr int kGroups = kThreads / G;
  const float kNaN = __int_as_float(0x7fc00000);
  const int b = blockIdx.x / chunks;
  const int chunk = blockIdx.x - b * chunks;
  const int lane = threadIdx.x & (G - 1);
  const int group = threadIdx.x / G;
  const float* qb = q + (long long)b * dim;

  // this lane's slice of the query, kept for every row it visits
  float qr[UPL][E];
#pragma unroll
  for (int i = 0; i < UPL; ++i) {
    const int u = lane + i * G;
#pragma unroll
    for (int j = 0; j < E; ++j) qr[i][j] = u < units ? qb[u * E + j] : 0.0f;
  }

  const int first = chunk * (kGroups * kRows) + group;
  const int* pb = pos + (long long)b * k;
  int p[kRows];
  bool ok[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kk = first + r * kGroups;
    p[r] = kk < k ? __ldg(pb + kk) : -1;
    ok[r] = p[r] >= 0 && p[r] < n_rows;
  }
  Unit<T, V> x[kRows][UPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const V* row = tab + (long long)(ok[r] ? p[r] : 0) * units;
#pragma unroll
    for (int i = 0; i < UPL; ++i) {
      const int u = lane + i * G;
      if (ok[r] && u < units) {
        x[r][i].v = __ldg(row + u);
      } else {
        x[r][i].v = V{};
      }
    }
  }
  float s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    s[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < UPL; ++i) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float d = (float)x[r][i].e[j] - qr[i][j];
        s[r] += d * d;
      }
    }
  }
  // units past the register slice (rows of more than UPL * G units)
  for (int u = lane + UPL * G; u < units; u += G) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!ok[r]) continue;
      Unit<T, V> y;
      y.v = __ldg(tab + (long long)p[r] * units + u);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float d = (float)y.e[j] - __ldg(qb + u * E + j);
        s[r] += d * d;
      }
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
      const int kk = first + r * kGroups;
      if (kk < k) out[(long long)b * k + kk] = ok[r] ? s[r] : kNaN;
    }
  }
}

template <typename T, typename V, int G, int UPL>
int launch(const void* tab, long long n_rows, int row_bytes, const int* pos,
           int b, int k, const float* q, int dim, float* out,
           cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const int chunks = (k + kGroups * kRows - 1) / (kGroups * kRows);
  const long long blocks = (long long)b * chunks;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  gather_sqdist_kernel<T, V, G, UPL><<<(unsigned)blocks, kThreads, 0,
                                       stream>>>(
      static_cast<const V*>(tab), n_rows, row_bytes / (int)sizeof(V), pos, k,
      chunks, q, dim, out);
  return (int)cudaGetLastError();
}

// G from the units a row has: a power of two from 4 to 32; past 32 units
// each lane keeps two units' query slice in registers (UPL = 2).
template <typename T, typename V>
int by_units(const void* tab, long long n_rows, int row_bytes, const int* pos,
             int b, int k, const float* q, int dim, float* out,
             cudaStream_t s) {
  const int units = row_bytes / (int)sizeof(V);
  if (units <= 4)
    return launch<T, V, 4, 1>(tab, n_rows, row_bytes, pos, b, k, q, dim, out,
                              s);
  if (units <= 8)
    return launch<T, V, 8, 1>(tab, n_rows, row_bytes, pos, b, k, q, dim, out,
                              s);
  if (units <= 16)
    return launch<T, V, 16, 1>(tab, n_rows, row_bytes, pos, b, k, q, dim, out,
                               s);
  if (units <= 32)
    return launch<T, V, 32, 1>(tab, n_rows, row_bytes, pos, b, k, q, dim, out,
                               s);
  return launch<T, V, 32, 2>(tab, n_rows, row_bytes, pos, b, k, q, dim, out,
                             s);
}

bool fits(const void* tab, int row_bytes, int v) {
  return row_bytes % v == 0 && (size_t)tab % v == 0;
}

template <typename T>
int by_unit(const void* tab, long long n_rows, int row_bytes, const int* pos,
            int b, int k, const float* q, int dim, float* out,
            cudaStream_t s) {
  if (fits(tab, row_bytes, 16))
    return by_units<T, uint4>(tab, n_rows, row_bytes, pos, b, k, q, dim, out,
                              s);
  if (fits(tab, row_bytes, 8))
    return by_units<T, uint2>(tab, n_rows, row_bytes, pos, b, k, q, dim, out,
                              s);
  if (fits(tab, row_bytes, 4))
    return by_units<T, unsigned int>(tab, n_rows, row_bytes, pos, b, k, q,
                                     dim, out, s);
  if constexpr (sizeof(T) == 1) {
    if (fits(tab, row_bytes, 2))
      return by_units<T, unsigned short>(tab, n_rows, row_bytes, pos, b, k, q,
                                         dim, out, s);
    return by_units<T, unsigned char>(tab, n_rows, row_bytes, pos, b, k, q,
                                      dim, out, s);
  }
  return (int)cudaErrorMisalignedAddress;   // a float table off 4 bytes
}

}  // namespace

// tab: (n_rows, dim) of elem_bytes-byte elements (1: uint8, 4: float32),
// contiguous; pos: (b, k) int32; q: (b, dim) float32; out: (b, k) float32.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int pqt_gather_sqdist(const void* tab, long long n_rows, int dim,
                                 int elem_bytes, const int* pos, int b, int k,
                                 const float* q, float* out, void* stream) {
  if (b <= 0 || k <= 0 || dim <= 0 || n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1)
    return by_unit<unsigned char>(tab, n_rows, dim, pos, b, k, q, dim, out,
                                  s);
  if (elem_bytes == 4)
    return by_unit<float>(tab, n_rows, dim * 4, pos, b, k, q, dim, out, s);
  return (int)cudaErrorInvalidValue;
}
