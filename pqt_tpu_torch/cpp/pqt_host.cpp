// Native host runtime of pqt_tpu_torch: the CSR assembly of the out-of-core
// database build, in one stable counting sort, the row moves around it, and
// the TexMex readers' header strip and uint8 widening.
//
// The port's own copy of the JAX package's host runtime (the entry points
// the out-of-core build and the dataset readers need: build_csr,
// gather_rows, place_positions, scatter_rows, strip_xvecs, u8_to_f32), so
// that the port depends on nothing of that package.
// NumPy's argsort is O(n log n) on one core and its fancy indexing is
// single-threaded; at 1e8+ rows both dominate the merge, so these run
// natively, the row moves with OpenMP.  io/native.py builds this file with
// g++ at first use and keeps a NumPy plain version of every entry point.

#include <atomic>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Stable counting sort by bin id.
//   bin_ids: n int32 values in [0, hash_size)
//   counts:  hash_size int32 (out)
//   prefix:  hash_size int32 exclusive prefix (out)
//   order:   n int32, the CSR permutation: order[csr_pos] = input index (out)
// Returns 0 on success, -1 on an out-of-range id.
int pqt_build_csr(const int32_t* bin_ids, int64_t n, int64_t hash_size,
                  int32_t* counts, int32_t* prefix, int32_t* order) {
  std::memset(counts, 0, hash_size * sizeof(int32_t));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t b = bin_ids[i];
    if (b < 0 || b >= hash_size) return -1;
    counts[b]++;
  }
  int64_t run = 0;
  for (int64_t b = 0; b < hash_size; ++b) {
    prefix[b] = (int32_t)run;
    run += counts[b];
  }
  // placement in input order against per-bin cursors: stable
  int32_t* cursor = new int32_t[hash_size];
  std::memcpy(cursor, prefix, hash_size * sizeof(int32_t));
  for (int64_t i = 0; i < n; ++i) order[cursor[bin_ids[i]]++] = (int32_t)i;
  delete[] cursor;
  return 0;
}

// Row gather: out[i] = src[order[i]] for rows of row_bytes bytes.
void pqt_gather_rows(const uint8_t* src, const int32_t* order, int64_t n,
                     int64_t row_bytes, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    std::memcpy(out + i * row_bytes, src + (int64_t)order[i] * row_bytes,
                row_bytes);
}

// Placement of one merge chunk: pos[i] = cursor[bins[i]]++, in input order
// (so rows of one bin keep their input order), one linear pass.
//   bins: n int32 local bin ids; cursor: next position of each bin (int64,
//   advanced in place); pos: n int64 (out).
void pqt_place_positions(const int32_t* bins, int64_t n, int64_t* cursor,
                         int64_t* pos) {
  for (int64_t i = 0; i < n; ++i) pos[i] = cursor[bins[i]]++;
}

// Row scatter: dst[pos[i]] = src[i] for rows of row_bytes bytes.  The
// positions are distinct, so rows write disjoint ranges.
void pqt_scatter_rows(const uint8_t* src, const int64_t* pos, int64_t n,
                      int64_t row_bytes, uint8_t* dst) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    std::memcpy(dst + pos[i] * row_bytes, src + i * row_bytes, row_bytes);
}

// Strip the TexMex per-row headers: n rows of an .fvecs/.bvecs/.ivecs file,
// each an int32 dim followed by dim elements of elem_bytes, into a dense
// (n, dim) array.  Returns 0, or -1 when a row's dim is not `dim`.
int pqt_strip_xvecs(const uint8_t* src, int64_t n, int64_t dim,
                    int64_t elem_bytes, uint8_t* out) {
  const int64_t row_in = 4 + dim * elem_bytes;
  const int64_t row_out = dim * elem_bytes;
  std::atomic<int> bad{0};
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int32_t d;
    std::memcpy(&d, src + i * row_in, 4);
    if (d != dim) {
      bad.store(1);
      continue;
    }
    std::memcpy(out + i * row_out, src + i * row_in + 4, row_out);
  }
  return bad.load() ? -1 : 0;
}

// uint8 -> float32 widening of n values.
void pqt_u8_to_f32(const uint8_t* src, int64_t n, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) out[i] = (float)src[i];
}

int pqt_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
