// Stage marks: a one-thread kernel that does nothing, launched where a
// stage of the port's work starts (pqt_tpu_torch/utils/tracing.py).  The
// stage's id is the kernel's template argument, so a profiler's trace names
// the stage in the kernel's name, `pqt_stage_mark_kernel<3>()`, and orders
// it among the stage's kernels on the device's timeline; tracing.STAGES maps
// each id to its stage's name.
//
// A mark launched while a stream is captured into a CUDA graph becomes one
// kernel node.  `pqt_graph_marks` finds those nodes in a captured graph by
// their kernel function, and `pqt_graph_node_set_enabled` turns one on or
// off in the graph's executable: a disabled node runs as an empty node, so a
// replay with tracing off runs no mark and the graph is never captured
// again.  A change applies to the executable's later launches only.
//
// The launch takes the caller's stream, allocates nothing and does not
// synchronise.

#include <cuda_runtime.h>

#include <cstddef>
#include <vector>

template <int Id>
__global__ void pqt_stage_mark_kernel() {}

namespace {

constexpr int kStages = 13;     // len(tracing.STAGES)

const void* const kMarks[kStages] = {
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<0>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<1>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<2>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<3>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<4>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<5>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<6>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<7>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<8>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<9>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<10>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<11>),
    reinterpret_cast<const void*>(pqt_stage_mark_kernel<12>),
};

int mark_id(const void* func) {
  for (int i = 0; i < kStages; ++i)
    if (kMarks[i] == func) return i;
  return -1;
}

}  // namespace

extern "C" {

// Launch stage `id`'s mark on `stream`.
int pqt_stage_mark(int id, void* stream) {
  if (id < 0 || id >= kStages) return cudaErrorInvalidValue;
  cudaError_t err = cudaLaunchKernel(kMarks[id], dim3(1), dim3(1), nullptr,
                                     0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The mark nodes of `graph` (a cudaGraph_t): up to `cap` of them written to
// `nodes`, their stage ids to `ids`, in the graph's node order; `*count` is
// how many the graph holds.  Nodes whose parameters cannot be read are not
// marks (their kernels come from other libraries) and are passed over.
int pqt_graph_marks(void* graph, void** nodes, int* ids, int cap,
                    int* count) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> all(n);
  if (n > 0) {
    err = cudaGraphGetNodes(g, all.data(), &n);
    if (err != cudaSuccess) return err;
  }
  int found = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(all[i], &type) != cudaSuccess ||
        type != cudaGraphNodeTypeKernel) {
      cudaGetLastError();
      continue;
    }
    cudaKernelNodeParams p;
    if (cudaGraphKernelNodeGetParams(all[i], &p) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    const int id = mark_id(p.func);
    if (id < 0) continue;
    if (found < cap) {
      nodes[found] = all[i];
      ids[found] = id;
    }
    ++found;
  }
  *count = found;
  return cudaSuccess;
}

// Enable (on != 0) or disable a node of `graph_exec`'s graph.
int pqt_graph_node_set_enabled(void* graph_exec, void* node, int on) {
  return cudaGraphNodeSetEnabled(static_cast<cudaGraphExec_t>(graph_exec),
                                 static_cast<cudaGraphNode_t>(node),
                                 on ? 1u : 0u);
}

// Whether a node of `graph_exec`'s graph is enabled, in `*on`.
int pqt_graph_node_get_enabled(void* graph_exec, void* node, int* on) {
  unsigned int v = 0;
  cudaError_t err = cudaGraphNodeGetEnabled(
      static_cast<cudaGraphExec_t>(graph_exec),
      static_cast<cudaGraphNode_t>(node), &v);
  *on = static_cast<int>(v);
  return err;
}

}  // extern "C"
