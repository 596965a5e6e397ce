// The device-mode rescue ladder as one CUDA graph, for Hopper (sm_90a):
// the gate kernel, which sets an IF conditional node's condition from
// any(failed) of the ladder state, and the C entry points that build such a
// graph node by node (child graphs, gate kernels, IF nodes), instantiate it
// and launch it.
//
// Replaces the reference's on-device round gate, lax.cond(any(failed)) in
// repro/core/windowing.py:align_pairs_rescued (an XLA conditional, no
// Pallas kernel).  The port's eager ladder reads the same any(failed) on
// the host (core/windowing.py any_failed), one sync a later rung; a
// session's device-mode executable (serve/graphs.py GraphedStep) instead
// launches one graph a dispatch: rung 0's captures, then rung 1's gates and
// one IF node whose body holds rung 1's captures and, nested after them,
// rung 2's gates and IF node, and so on, so the card decides which rungs
// run and the host never waits.  The gate's plain PyTorch version is
// ladder_gate_plain in repro_torch/kernels/ladder_graph.py.
//
// Bound on the H100: latency.  A gate reads one byte a lane (1,024 B for a
// 1,024-lane dispatch) and writes one word; what it costs is a launch
// inside the graph and one block's reduction (__syncthreads_or).
//
// The C entry points return a cudaError_t as int; none synchronises.  Node
// arguments `after` chain a node behind one other (null: a root).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GATE_THREADS = 256;

// out[0] = any(failed[0 .. n-1]) for one shard; where `conditional`, a
// failed lane also sets the IF node's condition `handle` to 1.  The handle
// is created with cudaGraphCondAssignDefault and default 0, so every launch
// of its graph starts it at 0 and the gates of all shards only raise it:
// the gate is global, the any over every shard, as in the reference.
__global__ void ladder_gate_kernel(const uint8_t* __restrict__ failed, int n,
                                   int32_t* __restrict__ out,
                                   cudaGraphConditionalHandle handle,
                                   int conditional) {
  int any = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) any |= failed[i];
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    out[0] = any ? 1 : 0;
    if (any && conditional) cudaGraphSetConditional(handle, 1u);
  }
}

int deps_of(void* after, cudaGraphNode_t* deps) {
  deps[0] = static_cast<cudaGraphNode_t>(after);
  return after ? 1 : 0;
}

}  // namespace

extern "C" {

// The gate kernel alone, on `stream`, setting no condition: out[0] =
// any(failed) (chip_smoke.py holds it against its plain version).
int genasm_ladder_gate_launch(const void* failed, int n, void* out,
                              void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  ladder_gate_kernel<<<1, GATE_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(failed), n, static_cast<int32_t*>(out), 0,
      0);
  return static_cast<int>(cudaGetLastError());
}

int genasm_graph_create(void** graph) {
  cudaGraph_t g = nullptr;
  const cudaError_t err = cudaGraphCreate(&g, 0);
  *graph = g;
  return static_cast<int>(err);
}

int genasm_graph_destroy(void* graph) {
  return static_cast<int>(cudaGraphDestroy(static_cast<cudaGraph_t>(graph)));
}

// A child-graph node of `child` (cloned into `graph`: the child may be
// destroyed after, but the memory its nodes address must outlive every
// launch).
int genasm_graph_add_child(void* graph, void* after, void* child,
                           void** node) {
  cudaGraphNode_t deps[1], n = nullptr;
  const cudaError_t err = cudaGraphAddChildGraphNode(
      &n, static_cast<cudaGraph_t>(graph), deps, deps_of(after, deps),
      static_cast<cudaGraph_t>(child));
  *node = n;
  return static_cast<int>(err);
}

// A conditional handle of `graph` (the top graph or a body), 0 at the start
// of every launch of that graph.
int genasm_graph_conditional(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h = 0;
  const cudaError_t err = cudaGraphConditionalHandleCreate(
      &h, static_cast<cudaGraph_t>(graph), 0, cudaGraphCondAssignDefault);
  *handle = h;
  return static_cast<int>(err);
}

// A gate kernel node: one shard's any(failed) into out[0] and, if set,
// the condition `handle` to 1.
int genasm_graph_add_gate(void* graph, void* after, const void* failed,
                          int n, void* out, unsigned long long handle,
                          void** node) {
  const uint8_t* f = static_cast<const uint8_t*>(failed);
  int32_t* o = static_cast<int32_t*>(out);
  cudaGraphConditionalHandle h = handle;
  int conditional = 1;
  void* args[] = {&f, &n, &o, &h, &conditional};
  cudaKernelNodeParams p{};
  p.func = reinterpret_cast<void*>(ladder_gate_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(GATE_THREADS);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  cudaGraphNode_t deps[1], k = nullptr;
  const cudaError_t err = cudaGraphAddKernelNode(
      &k, static_cast<cudaGraph_t>(graph), deps, deps_of(after, deps), &p);
  *node = k;
  return static_cast<int>(err);
}

// An IF conditional node on `handle`; its body graph (owned by the node)
// runs at a launch where the condition is non-zero when the node is
// reached.
int genasm_graph_add_if(void* graph, void* after, unsigned long long handle,
                        void** node, void** body) {
  cudaGraphNodeParams p{};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t deps[1], n = nullptr;
  const cudaError_t err = cudaGraphAddNode(
      &n, static_cast<cudaGraph_t>(graph), deps, deps_of(after, deps), &p);
  *node = n;
  *body = err == cudaSuccess ? p.conditional.phGraph_out[0] : nullptr;
  return static_cast<int>(err);
}

int genasm_graph_instantiate(void* graph, void** exec) {
  cudaGraphExec_t e = nullptr;
  const cudaError_t err =
      cudaGraphInstantiate(&e, static_cast<cudaGraph_t>(graph), 0);
  *exec = e;
  return static_cast<int>(err);
}

// Upload an instantiated graph's work to the device on `stream`, so that
// its first launch costs what every later one does (a first launch would
// upload it: 52-162 ms of host time for 6k-95k nodes on an H100).
int genasm_graph_upload(void* exec, void* stream) {
  return static_cast<int>(cudaGraphUpload(
      static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

int genasm_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(
      static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

int genasm_graph_exec_destroy(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

// cudaMemGetInfo's free bytes of the current device into *free_bytes, also
// while this thread captures a graph: the call runs in relaxed capture
// mode, as PyTorch's allocator runs its cudaMalloc during a capture (the
// wide family sizes a captured launch's scratch by it).
int genasm_mem_free(void* free_bytes) {
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  cudaError_t err = cudaThreadExchangeStreamCaptureMode(&mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t free = 0, total = 0;
  err = cudaMemGetInfo(&free, &total);
  const cudaError_t back = cudaThreadExchangeStreamCaptureMode(&mode);
  *static_cast<unsigned long long*>(free_bytes) = free;
  return static_cast<int>(err != cudaSuccess ? err : back);
}

}  // extern "C"
