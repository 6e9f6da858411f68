// Kernel E/F/G: table lookup out[i] = table[idx[i]] over a flat index array.
//
// Replaces three TPU kernels that compute this one function and differ only
// in how Mosaic indexes the table it holds in VMEM:
// benchmarks/micro_gather.py:pallas_gather (flat index),
// benchmarks/micro_gather2.py:pallas_lut_2d ((idx / 128, idx % 128)) and
// pallas_lut_onehot (take_along_axis).  Mosaic has no general vector gather
// from VMEM, so none of them lowered for a table the size of the query's
// occupancy tables (pqt_tpu/models/query.py:_probe_bins records why).  On
// Hopper any address is a plain load, so one kernel is the counterpart of
// all three.
//
// Uses in the port: the bin occupancy counts[bins] and CSR starts
// prefix[bins] of the parts pipeline (2^20 int32 slots, 4 MB each, at the
// bench config), and the pair-occupancy table pair_occ (p/2 x 65536 uint8)
// of the pair filter in both pipelines.
//
// One thread per output element, in a grid-stride loop: the index and
// output accesses are coalesced, the table access is a random read through
// the read-only path (__ldg), which keeps a 4 MB table resident in the
// 50 MB L2 across a batch's lookups.  Staging a small table (pair_occ's 64
// KB per pair) in shared memory is later work.  An index outside [0, H)
// reads nothing and yields 0; callers pass in-range indices.
//
// What bounds it on the H100: bytes -- the indices read and the outputs
// written once, and each distinct table element the indices touch read
// once.  There is no arithmetic to speak of.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <typename T>
__global__ void lut_kernel(const T* __restrict__ table, long long H,
                           const int* __restrict__ idx, long long n,
                           T* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int j = idx[i];
    out[i] = (j >= 0 && j < H) ? __ldg(table + j) : T(0);
  }
}

template <typename T>
int launch(const void* table, long long H, const int* idx, long long n,
           void* out, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lut_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), H, idx, n, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// table: (H,) elements of elem_bytes (1: uint8, 4: int32) bytes; idx: (n,)
// int32; out: (n,) of the table's type.  Returns the CUDA error code of the
// launch (0 = success).
extern "C" int pqt_lut_gather(const void* table, long long H, int elem_bytes,
                              const int* idx, long long n, void* out,
                              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_bytes) {
    case 1: return launch<unsigned char>(table, H, idx, n, out, s);
    case 4: return launch<int>(table, H, idx, n, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
