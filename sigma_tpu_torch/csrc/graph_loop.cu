// A solve loop's replay unit as one CUDA graph whose bodies each sit
// under a conditional if-node.
//
// Replaces no TPU kernel: it is the port's counterpart of the compiled
// ``lax.while_loop``s (and the stationary iteration's ``fori_loop``) of
// ``sigma_tpu/solvers/krylov.py``, whose ``cond`` XLA evaluates on the
// device.  The Python side
// (``sigma_tpu_torch/solvers/graphed.py``) captures with
// ``torch.cuda.graph`` a head, the bodies and a tail (the status the host
// reads); each capture is a graph in PyTorch's memory pool for the loop.
// This file links them: head -> one (set-predicate kernel -> if-node
// holding a body as a child graph) a body -> tail, and instantiates the
// result.  A block of iterations (CG, BiCG-stab, MINRES, CGLS, block CG,
// ...) lists the even and the odd iteration (which ping-pong between two
// buffer sets) in turn, all on the loop's predicate; a GMRES or FGMRES
// restart cycle lists its m Arnoldi steps,
// the first on the cycle's predicate and the others on the one the step
// before wrote, then the cycle's end on the cycle's predicate.
//
// Each if-node's handle is set by a one-thread kernel from its predicate
// in device memory, which an earlier body (or the head) wrote; a false
// predicate skips the body, and every later body on it, so the iteration
// count is exact.  The host reads the status once a replay.
//
// Bound: launch latency.  The set-predicate kernel reads one byte; a
// skipped if-node costs its kernel and the node's own scheduling.
//
// Every entry returns a cudaError_t (0 on success) and synchronises
// nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void set_predicate_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                            cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, dep, nullptr, 1, params);
#else
  return cudaGraphAddNode(node, graph, dep, 1, params);
#endif
}

// Append `child` (cloned) to `graph` after `*last` (none when null); the
// new node becomes `*last`.
cudaError_t append_child(cudaGraph_t graph, cudaGraphNode_t* last, cudaGraph_t child) {
  cudaGraphNode_t node;
  cudaError_t err =
      cudaGraphAddChildGraphNode(&node, graph, *last ? last : nullptr, *last ? 1 : 0, child);
  if (err == cudaSuccess) *last = node;
  return err;
}

cudaError_t link(cudaGraph_t graph, cudaGraph_t head, const cudaGraph_t* bodies,
                 const bool* const* preds, int64_t nodes, cudaGraph_t tail) {
  cudaGraphNode_t last = nullptr;
  cudaError_t err = append_child(graph, &last, head);
  for (int64_t j = 0; j < nodes && err == cudaSuccess; ++j) {
    const bool* pred = preds[j];
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) break;
    cudaKernelNodeParams kp = {};
    void* args[] = {&handle, &pred};
    kp.func = reinterpret_cast<void*>(set_predicate_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t setter;
    err = cudaGraphAddKernelNode(&setter, graph, &last, 1, &kp);
    if (err != cudaSuccess) break;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    err = add_conditional(&last, graph, &setter, &cp);
    if (err != cudaSuccess) break;
    cudaGraphNode_t inner = nullptr;
    err = append_child(cp.conditional.phGraph_out[0], &inner, bodies[j]);
  }
  if (err == cudaSuccess) err = append_child(graph, &last, tail);
  return err;
}

}  // namespace

// Link the captured graphs on `device`: `head`, then `nodes` bodies, the
// j-th `bodies[j]` under an if-node on the predicate `preds[j]` (a device
// bool), then `tail`; instantiate the result.  `*exec` receives the
// executable graph (null on failure).
extern "C" int sigma_loop_graph(int device, const void* head, const void* const* bodies,
                                const void* const* preds, int64_t nodes, const void* tail,
                                void** exec) {
  *exec = nullptr;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaGraph_t graph;
  err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return err;
  err = link(graph, (cudaGraph_t)head, (const cudaGraph_t*)bodies, (const bool* const*)preds,
             nodes, (cudaGraph_t)tail);
  cudaGraphExec_t out = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&out, graph, 0);
  cudaGraphDestroy(graph);  // the executable graph keeps its own copy
  if (err == cudaSuccess) *exec = out;
  return err;
}

// Launch the linked graph on `stream`.
extern "C" int sigma_loop_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

extern "C" int sigma_loop_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

// The CUDA runtime's name for an error code.
extern "C" const char* sigma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
