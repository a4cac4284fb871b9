// Kernel X: the loop control of the fused Newton solve as CUDA-graph
// conditional nodes.
//
// Replaces the control flow of stark_tpu/solver/fused.py: the Newton
// `lax.while_loop` (:593), its `lax.cond`s (the broad and pair rebuilds, the
// initial-state test and the Newton-Schulz refresh, :291, :304, :313, :408),
// the [inv] and [bt] `lax.while_loop`s (:479, :516) and PCG's
// (stark_tpu/solver/pcg.py:99). XLA compiles those into one device program;
// here the solve is captured once into a CUDA graph whose loops are WHILE
// conditional nodes and whose conditionals are IF nodes, so that a replay
// runs a whole time step without the host.
//
// Two parts:
//   * `stk_graph_set_cond_kernel`, one thread, reads a 0-d device predicate
//     (uint8) and sets a conditional handle from it. It runs before each
//     node (a WHILE node tests its handle before the first body, as
//     lax.while_loop tests its condition) and at the end of each WHILE body.
//   * host entry points that, while a stream captures, add a WHILE or IF
//     node after the stream's capture dependencies, point the stream past
//     the node, and begin capturing a second stream into the node's body
//     graph; `stk_graph_end_body` ends that capture. This follows PyTorch's
//     CUDAGraph::begin_capture_to_if_node, which offers IF nodes only.
//
// Bound: latency. The setter moves one byte; a node costs the device's
// conditional-node scheduling. Nothing here is worth more than one thread.
#include "stk_common.cuh"

#if CUDART_VERSION < 12040
#error "kernel X needs CUDA 12.4 or later (graph conditional nodes)"
#endif

__global__ void stk_graph_set_cond_kernel(cudaGraphConditionalHandle handle,
                                          const unsigned char* pred) {
  cudaGraphSetConditional(handle, pred[0] ? 1u : 0u);
}

STK_API int stk_graph_set_cond(unsigned long long handle, const void* pred,
                               cudaStream_t stream) {
  stk_graph_set_cond_kernel<<<1, 1, 0, stream>>>(
      (cudaGraphConditionalHandle)handle, (const unsigned char*)pred);
  return stk_launch_status();
}

static cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                                const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                           nullptr, n);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n);
#endif
  if (e != cudaSuccess) return e;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureInvalidated;
}

// kind 0: IF, 1: WHILE. `pred` is the node's first value; the body writes
// the WHILE's next one through stk_graph_set_cond. Returns a cudaError_t;
// the handle is written to *handle_out.
STK_API int stk_graph_begin_body(cudaStream_t stream, cudaStream_t body_stream,
                                 int kind, const void* pred,
                                 unsigned long long* handle_out) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e = capture_info(stream, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  stk_graph_set_cond_kernel<<<1, 1, 0, stream>>>(handle,
                                                 (const unsigned char*)pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the dependencies now end at the setter
  e = capture_info(stream, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamBeginCaptureToGraph(body_stream, params.conditional.phGraph_out[0],
                                    nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  *handle_out = (unsigned long long)handle;
  return 0;
}

STK_API int stk_graph_end_body(cudaStream_t body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(body_stream, &body);
}
