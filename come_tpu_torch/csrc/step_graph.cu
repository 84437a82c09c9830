// The plans' graph slots (step_graph.cuh) and what the build reports of
// them.

#include "step_graph.cuh"

using namespace come;

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

// Frees a slot's instance and stream.  Returns 0 or the first CUDA error.
extern "C" int come_step_graph_free(void* slot) {
  StepGraph* p = static_cast<StepGraph*>(slot);
  if (p == nullptr) return 0;
  cudaError_t e = cudaSuccess;
  if (p->exec != nullptr) e = cudaGraphExecDestroy(p->exec);
  const cudaError_t e2 = cudaStreamDestroy(p->cap);
  delete p;
  return (int)(e != cudaSuccess ? e : e2);
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
