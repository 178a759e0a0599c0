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
//
// The same library stamps the step's spans on the device (ops/graph_loop.py
// Trace), for a step captured with tracing on:
//
//   sph_stamp: the stamp kernel, one thread, launched at a span's open and
//     close and at the end of each iteration of a WHILE node: it reads the
//     device's nanosecond timer (%globaltimer) first, then appends one event
//     (the replay index, the span and its kind; the time) to a device table
//     whose cursor, drop count and replay index live in a second buffer,
//     both allocated before the capture. A full table counts the event as
//     dropped instead. The step's opening stamp advances the replay index.
//     Bound: latency (a launch and a few 8-byte writes, about as long as a
//     launch in a graph).
//   sph_clock_anchor: one reading of the device timer between two readings
//     of the host's CLOCK_MONOTONIC (Python's time.perf_counter_ns): a
//     kernel spins on a word of mapped host memory, the host takes its time
//     and releases it, the kernel reads the timer and answers, the host
//     takes its time again. The device's reading lies between the two; the
//     tightest of several readings maps the device timer onto the host's.
//   sph_stamp_runs: how many stamp kernels have run (a card test holds a
//     replay of a capture made with tracing off to none).

#include <cuda_runtime.h>
#include <stdint.h>
#include <time.h>

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

// ---- stamps ----------------------------------------------------------------

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// stamp kernels run so far, on this device
__device__ unsigned long long g_stamp_runs = 0;

// meta: [0] the table's cursor, [1] events dropped, [2] the replay index.
// table: (cap, 2) words, (replay << 20 | code, ns) an event; code is the
// span's id << 2 | its kind (ops/graph_loop.py).
__global__ void stamp_kernel(unsigned long long* meta, unsigned long long* table,
                             unsigned long long cap, unsigned long long code, int begin) {
  const unsigned long long t = global_ns();
  g_stamp_runs += 1ull;
  if (begin) meta[2] += 1ull;
  const unsigned long long k = meta[0];
  if (k < cap) {
    table[2 * k] = (meta[2] << 20) | code;
    table[2 * k + 1] = t;
    meta[0] = k + 1ull;
  } else {
    meta[1] += 1ull;
  }
}

extern "C" int sph_stamp(void* stream, unsigned long long* meta, unsigned long long* table,
                         unsigned long long cap, unsigned long long code, int begin) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(meta, table, cap, code, begin);
  return (int)cudaGetLastError();
}

extern "C" int sph_stamp_runs(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp_runs, sizeof(*out));
}

// ---- the clock anchor --------------------------------------------------------

// h, host memory mapped into the device: [0] go (host), [1] started, [2] the
// device's time, [3] done, [4] the timer's step (device)
__global__ void anchor_kernel(volatile unsigned long long* h, unsigned long long timeout_ns) {
  // the timer's step: the least change between readings, taken before the
  // host is told that the kernel runs
  // (every wait is bounded in reads as well as in time, should the timer stop)
  const unsigned long long a = global_ns();
  unsigned long long b = a, c;
  for (int k = 0; k < (1 << 20) && b == a; ++k) b = global_ns();
  c = b;
  for (int k = 0; k < (1 << 20) && c == b; ++k) c = global_ns();
  h[4] = c - b;
  h[1] = 1ull;
  __threadfence_system();
  const unsigned long long t0 = global_ns();
  for (int k = 0; k < (1 << 24) && h[0] == 0ull && global_ns() - t0 < timeout_ns; ++k) {
  }
  h[2] = global_ns();
  __threadfence_system();
  h[3] = 1ull;
}

static long long host_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (long long)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

static volatile unsigned long long* g_anchor_host = nullptr;
static unsigned long long* g_anchor_dev = nullptr;

// One anchor on an idle stream: out = (host ns before the release, device
// ns, host ns after the answer, the timer's step in ns). Returns a CUDA
// error code, or -1 if the kernel did not start or answer within a second
// (the kernel gives up by itself after 0.1 s).
extern "C" int sph_clock_anchor(void* stream, long long* out) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (g_anchor_host == nullptr) {
    void* p = nullptr;
    err = cudaHostAlloc(&p, 8 * sizeof(unsigned long long),
                        cudaHostAllocMapped | cudaHostAllocPortable);
    if (err != cudaSuccess) return (int)err;
    void* d = nullptr;
    err = cudaHostGetDevicePointer(&d, p, 0);
    if (err != cudaSuccess) return (int)err;
    g_anchor_host = (volatile unsigned long long*)p;
    g_anchor_dev = (unsigned long long*)d;
  }
  volatile unsigned long long* h = g_anchor_host;
  for (int k = 0; k < 8; ++k) h[k] = 0ull;
  __sync_synchronize();
  anchor_kernel<<<1, 1, 0, s>>>(g_anchor_dev, 100000000ull);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long t_start = host_ns();
  bool late = false;
  while (h[1] == 0ull) {
    if (host_ns() - t_start > 1000000000LL) {
      late = true;
      break;
    }
  }
  const long long t_w = host_ns();
  h[0] = 1ull;
  __sync_synchronize();
  while (!late && h[3] == 0ull) {
    if (host_ns() - t_w > 1000000000LL) late = true;
  }
  const long long t_r = host_ns();
  err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return (int)err;
  if (late || h[3] == 0ull) return -1;
  out[0] = t_w;
  out[1] = (long long)h[2];
  out[2] = t_r;
  out[3] = (long long)h[4];
  return 0;
}
