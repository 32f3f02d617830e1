// lvt_tpu's jax.lax.cond in a captured CUDA graph: an IF node whose body
// runs only when a device predicate is set (CUDA 12.4 or later), with no
// host sync. Not a TPU kernel: lvt_tpu's one cond (local BA on its
// schedule, lvt_tpu/core/step.py:323) is an XLA conditional.
//
// core/graphs.py::cond captures the branch as a graph of its own (a
// torch.cuda.CUDAGraph kept un-instantiated, in the step graph's memory
// pool, on a stream of its own), then calls lvt_if_node on the stream that
// is capturing the step. That appends to the step's graph, after the
// stream's current dependencies:
//   1. set_if_kernel, which copies the predicate (a bool in device memory)
//      into the node's conditional handle at every replay;
//   2. the IF node, whose body graph holds the branch's graph as one child
//      graph node (a copy of it, made here);
// and makes the node the stream's only dependency, so the work captured
// after it runs after the branch, taken or not.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// The number of nodes of each type (cudaGraphNodeType, below n_types) in
// a graph, for the message of a body the IF node refuses.
extern "C" int lvt_graph_node_counts(void* graph_ptr, int* counts,
                                     int n_types) {
  cudaGraph_t graph = static_cast<cudaGraph_t>(graph_ptr);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; i < n && err == cudaSuccess; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err == cudaSuccess && static_cast<int>(type) < n_types)
      ++counts[static_cast<int>(type)];
  }
  delete[] nodes;
  return err;
}

static int if_node(cudaStream_t stream, const void* pred, cudaGraph_t branch,
                   int* stage);

// Returns the first failing call's error and its step in *stage (1 the
// capture's state, 2 the handle, 3 the predicate kernel, 4 the node, 5 the
// body, 6 the stream's dependencies); a failure leaves no error pending
// for the next launch to report.
extern "C" int lvt_if_node(void* stream_ptr, const void* pred,
                           void* branch_ptr, int* stage) {
  int err = if_node(static_cast<cudaStream_t>(stream_ptr), pred,
                    static_cast<cudaGraph_t>(branch_ptr), stage);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

static int if_node(cudaStream_t stream, const void* pred, cudaGraph_t branch,
                   int* stage) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  *stage = 1;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr,
                                             &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  *stage = 2;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  *stage = 3;
  set_if_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the kernel is now the stream's dependency
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  *stage = 4;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  *stage = 5;
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                   nullptr, 0, branch);
  if (err != cudaSuccess) return err;
  *stage = 6;
  return cudaStreamUpdateCaptureDependencies(
      stream, &node, 1, cudaStreamSetCaptureDependencies);
}
