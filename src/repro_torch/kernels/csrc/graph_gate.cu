// A conditional IF node in a CUDA graph under capture, bound to Python with
// ctypes: the device-side counterpart of the reference's lax.cond on a
// traced predicate (src/repro/models/transformer.py, denoise_cached).
//
//   gate_if_begin(capture_stream, pred, body_stream)
//       on capture_stream (capturing a graph G): one kernel that copies the
//       device bool *pred into a conditional handle of G, then an IF node
//       of G on that handle after everything captured so far; the capture
//       of capture_stream continues after the node, and body_stream starts
//       capturing (relaxed mode) into the node's body graph.
//   gate_if_end(body_stream)
//       ends the body's capture.
//
// Work issued on body_stream between the two calls runs, at each launch
// of G, only where *pred is true at that point of the launch; work issued
// on capture_stream after gate_if_begin runs after the node either way. A
// replay decides on the device and reads nothing back to the host.
//
// Conditional nodes need CUDA 12.4 or later in the toolkit and the
// driver. The runtime calls that take edge data changed their signatures
// in CUDA 13; both forms are spelled out below.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, n);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess : cudaErrorIllegalState;
}

}  // namespace

extern "C" int gate_if_begin(void* capture_stream, const void* pred,
                             void* body_stream) {
  cudaStream_t s = (cudaStream_t)capture_stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, s>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(s, &graph, &deps, &n);  // the set kernel's node
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body_stream, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int gate_if_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}
