// The plans' graph slots (step_graph.cuh) and what the build reports of
// them; and the WHILE graphs of the plans that loop on the device
// (ops/launch_plan.py::GraphPlan: the GMM's EM, losses/gmm.py).
//
// A WHILE graph is the counterpart of jax.lax.while_loop: a parent graph
// holding an entry graph, then a conditional WHILE node whose body is a
// graph PyTorch recorded (one EM iteration).  come_while_flag, the last
// kernel of the entry and of the body, sets the node's condition from the
// device state: go on while some flag of go[0:n] is set and *it <
// *max_iter.  So the card runs every iteration of a fit from one launch,
// and the host reads nothing until the loop is over.  Conditional nodes
// need CUDA 12.4 or later; with an older toolkit the entries return
// cudaErrorNotSupported.

#include "step_graph.cuh"

// No `using namespace come`: the header's unnamed namespace inside `come`
// (sgns_common.cuh) and this file's unnamed namespace would then make
// nvcc's generated kernel stubs ambiguous.
using come::StepGraph;

#if CUDART_VERSION >= 12040
#define COME_WHILE 1
#else
#define COME_WHILE 0
#endif

namespace {

#if COME_WHILE
__global__ void while_flag_kernel(const bool* go, int n, const int* it,
                                  const int* max_iter,
                                  cudaGraphConditionalHandle handle) {
  bool any = false;
  for (int r = 0; r < n; ++r) any = any || go[r];
  cudaGraphSetConditional(handle, (any && *it < *max_iter) ? 1u : 0u);
}
#endif

struct WhileGraph {
  cudaGraph_t parent = nullptr;
  cudaGraphExec_t exec = nullptr;
  unsigned long long handle = 0;
};

}  // namespace

// A new WHILE graph on the current device: an empty parent graph and its
// condition handle (written to *handle, for come_while_flag; 0 at each
// launch until the entry sets it).  Null on failure.
extern "C" void* come_while_graph_new(unsigned long long* handle) {
#if COME_WHILE
  WhileGraph* w = new WhileGraph();
  cudaGraphConditionalHandle h;
  if (cudaGraphCreate(&w->parent, 0) != cudaSuccess ||
      cudaGraphConditionalHandleCreate(&h, w->parent, 0,
                                       cudaGraphCondAssignDefault) !=
          cudaSuccess) {
    if (w->parent != nullptr) cudaGraphDestroy(w->parent);
    delete w;
    return nullptr;
  }
  w->handle = h;
  *handle = h;
  return w;
#else
  (void)handle;
  return nullptr;
#endif
}

// Sets the condition of `handle` from the device state (see the note at the
// top); one thread.  Only inside a graph of that handle (a capture).
extern "C" int come_while_flag(const bool* go, int n, const int* it,
                               const int* max_iter, unsigned long long handle,
                               void* stream) {
#if COME_WHILE
  while_flag_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(go, n, it, max_iter,
                                                       handle);
  return (int)cudaGetLastError();
#else
  return (int)cudaErrorNotSupported;
#endif
}

// Builds and instantiates the parent graph: `entry` (a cudaGraph_t) as a
// child graph, then the WHILE node with `body` (a cudaGraph_t) as its body's
// child graph.  Both graphs are cloned.  Returns 0 or the CUDA error.
extern "C" int come_while_graph_build(void* slot, void* entry, void* body) {
#if COME_WHILE
  WhileGraph* w = static_cast<WhileGraph*>(slot);
  cudaGraphNode_t first, loop, inner;
  cudaError_t e = cudaGraphAddChildGraphNode(&first, w->parent, nullptr, 0,
                                             (cudaGraph_t)entry);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = w->handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  e = cudaGraphAddNode(&loop, w->parent, &first, 1, &p);
  if (e != cudaSuccess) return (int)e;
  e = cudaGraphAddChildGraphNode(&inner, p.conditional.phGraph_out[0],
                                 nullptr, 0, (cudaGraph_t)body);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGraphInstantiate(&w->exec, w->parent, 0);
#else
  (void)slot, (void)entry, (void)body;
  return (int)cudaErrorNotSupported;
#endif
}

// Launches the WHILE graph on `stream`: the whole loop.
extern "C" int come_while_graph_launch(void* slot, void* stream) {
  WhileGraph* w = static_cast<WhileGraph*>(slot);
  if (w == nullptr || w->exec == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaGraphLaunch(w->exec, (cudaStream_t)stream);
}

// Frees a WHILE graph.  Returns 0 or the first CUDA error.
extern "C" int come_while_graph_free(void* slot) {
  WhileGraph* w = static_cast<WhileGraph*>(slot);
  if (w == nullptr) return 0;
  cudaError_t e = cudaSuccess;
  if (w->exec != nullptr) e = cudaGraphExecDestroy(w->exec);
  const cudaError_t e2 = cudaGraphDestroy(w->parent);
  delete w;
  return (int)(e != cudaSuccess ? e : e2);
}

// A new graph slot on the current device: its private recording stream and
// no instance yet.  Null if the stream cannot be made.
extern "C" void* come_step_graph_new() {
  StepGraph* p = new StepGraph();
  if (cudaStreamCreateWithFlags(&p->cap, cudaStreamNonBlocking) !=
      cudaSuccess) {
    delete p;
    return nullptr;
  }
  return p;
}

// Frees a slot's instance, its recording and its stream.  Returns 0 or the first CUDA error.
extern "C" int come_step_graph_free(void* slot) {
  StepGraph* p = static_cast<StepGraph*>(slot);
  if (p == nullptr) return 0;
  cudaError_t e = cudaSuccess;
  if (p->exec != nullptr) e = cudaGraphExecDestroy(p->exec);
  if (p->graph != nullptr) {
    const cudaError_t e1 = cudaGraphDestroy(p->graph);
    if (e == cudaSuccess) e = e1;
  }
  const cudaError_t e2 = cudaStreamDestroy(p->cap);
  delete p;
  return (int)(e != cudaSuccess ? e : e2);
}

// The band or star pass (sgns_common.cuh: PosRoute) that a walk or star
// step's recording in this slot launched; -1 before a recording.
extern "C" int come_step_graph_route(void* slot) {
  const StepGraph* p = static_cast<const StepGraph*>(slot);
  return p == nullptr ? -1 : p->route;
}

// The launches of pool pass `pass` (sgns_common.cuh: PoolPass) that a walk
// or star step's recording in this slot made; -1 for no slot or pass.
extern "C" int come_step_graph_pool(void* slot, int pass) {
  const StepGraph* p = static_cast<const StepGraph*>(slot);
  return p == nullptr || pass < 0 || pass >= come::POOL_PASSES
             ? -1
             : p->pool[pass];
}

// Launches a slot's instance once more on `stream` (the floor probe's
// replays).  Returns 0 or the CUDA error.
extern "C" int come_step_graph_launch(void* slot, void* stream) {
  StepGraph* p = static_cast<StepGraph*>(slot);
  if (p == nullptr || p->exec == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaGraphLaunch(p->exec, (cudaStream_t)stream);
}

// Whether the group loops launch under programmatic dependent launch
// (CUDA 12.3 or later), and the runtime version the library was built
// against (e.g. 12090).
extern "C" int come_pdl_enabled() { return COME_PDL; }
extern "C" int come_cudart_version() { return CUDART_VERSION; }
