// A while loop on the device: a conditional WHILE node of a CUDA graph,
// placed into the stream capture that torch.cuda.graph runs.
//
// The counterpart of jax.lax.while_loop in the JAX package's solvers
// (sph_project_tpu/solvers/dfsph.py:427 and :494, pcisph.py:126,
// iisph.py:163, viscosity_cg.py:147), which keep a solver's iterations on
// the TPU with no host read. PyTorch's graph capture has no conditional
// node, so ops/graph_loop.py places one with these functions:
//
//   sph_while_begin, on the stream being captured: creates the node's
//     handle, launches the condition kernel once (the loop-entry test), adds
//     the WHILE node at the stream's capture dependencies, moves the
//     stream's dependencies onto it, and begins capturing a side stream into
//     the node's body graph;
//   sph_while_cond, at the end of the body on the side stream: the
//     condition kernel again, the test that decides the next iteration;
//   sph_while_end: ends the side stream's capture.
//
// The condition kernel is one thread: it reads the loop's flag (a device
// int32 that the body's own kernels computed: a solver's tolerance test),
// sets the node's condition from it (cudaGraphSetConditional) and counts
// the iterations it lets through in a device int64, which the launch
// accounting of ops/graph_loop.py reads after the replays. Bound: latency
// (one 4-byte read, one 8-byte read and write); what it saves is the host
// round trip of a read per iteration.
//
// Needs CUDA 12.4 or later (conditional nodes, and the memcpy and memset
// nodes of PyTorch's copies and reductions inside a body graph).

#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION < 12040
#error "graph_loop.cu needs CUDA 12.4 or later (conditional WHILE nodes)"
#endif

__global__ void while_cond_kernel(cudaGraphConditionalHandle handle,
                                  const int* flag, unsigned long long* count) {
  const unsigned int go = *flag != 0;
  cudaGraphSetConditional(handle, go);
  if (go) *count += 1ull;
}

static cudaError_t launch_cond(unsigned long long handle, const int* flag,
                               unsigned long long* count, cudaStream_t s) {
  while_cond_kernel<<<1, 1, 0, s>>>((cudaGraphConditionalHandle)handle, flag,
                                    count);
  return cudaGetLastError();
}

// The capture's graph and its current dependencies, with their edge data.
static cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                                const cudaGraphNode_t** deps,
                                const cudaGraphEdgeData** edges, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                             edges, n);
#else
  *edges = nullptr;  // CUDA 12: the default edges, which PyTorch's capture has
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureImplicit;
}

// Returns a CUDA error code (0 = the node is placed and the body's capture
// begun); the node's handle in *handle_out.
extern "C" int sph_while_begin(void* stream, void* body_stream, const int* flag,
                               unsigned long long* count,
                               unsigned long long* handle_out) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  const cudaGraphEdgeData* edges;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &edges, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  err = launch_cond(handle, flag, count, s);
  if (err != cudaSuccess) return (int)err;
  // the dependencies now end at the condition kernel just captured
  err = capture_info(s, &graph, &deps, &edges, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, edges, n, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
  if (err != cudaSuccess) return (int)err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream,
                                      params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return (int)err;
  *handle_out = (unsigned long long)handle;
  return 0;
}

extern "C" int sph_while_cond(unsigned long long handle, const int* flag,
                              unsigned long long* count, void* stream) {
  return (int)launch_cond(handle, flag, count, (cudaStream_t)stream);
}

extern "C" int sph_while_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}
