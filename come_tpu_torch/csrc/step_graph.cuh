// A macro step as one launch unit: the group loop recorded as a CUDA graph
// and replayed.
//
// The TPU runs a macro step as one pallas_call with a grid over the groups
// (pallas_walk_sgns.py:564, :611; pallas_star_sgns.py:282, :309).  The
// card's group loops (walk_sgns.cu, star_sgns.cu) keep the group order with
// stream-ordered launches, five a group at pool_refresh 1, and each launch
// left the card idle for about a microsecond between kernels (PERF.md §5).
// So each call of a C entry records its loop on a private stream
// (cudaStreamCaptureModeThreadLocal: the host corpus's feeder thread keeps
// using CUDA meanwhile) and replays the graph on the caller's stream.  One
// instance is kept per plan (ops/launch_plan.py: one plan per device,
// stream, mode and shape): the first step instantiates it, every later one
// applies its new recording to it with cudaGraphExecUpdate, so every
// value of the step (lr, the SR seed, the addresses of the tables, walks,
// draws and pools, which move every step on the row-sharded path) is the
// step's own and no step instantiates.  Inside the graph the kernels after
// the first start under programmatic dependent launch (sgns_common.cuh).
// Nothing here waits on the host: recording, update and launch only
// enqueue.  Any failure is returned as its CUDA error; the wrappers raise.

#pragma once

#include "sgns_common.cuh"

namespace come {

struct StepGraph {
  cudaStream_t cap = nullptr;      // the private stream a step is recorded on
  cudaGraphExec_t exec = nullptr;  // the instance, made by the plan's first step
  int mode = -1;                   // the C entry's mode, fixed at setup
  NegSetup neg;                    // the negative pass's sizing, found at setup
};

// Records `record(stream)` (which launches the step's kernels on the stream
// it is given and returns 0 or a CUDA error) into a graph, makes it the
// plan's instance (instantiate != 0: the plan's first step) or updates the
// instance with it, and launches the instance on `stream`.
template <typename Record>
static int replay_step(StepGraph* p, int instantiate, cudaStream_t stream,
                       Record record) {
  if (p == nullptr || p->cap == nullptr ||
      (instantiate != 0) == (p->exec != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaStreamBeginCapture(p->cap, cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  const int rc = record(p->cap);
  cudaGraph_t g = nullptr;
  e = cudaStreamEndCapture(p->cap, &g);  // whatever record returned
  if (rc != 0 || e != cudaSuccess) {
    if (g != nullptr) cudaGraphDestroy(g);
    return rc != 0 ? rc : (int)e;
  }
  if (instantiate) {
    e = cudaGraphInstantiate(&p->exec, g, 0);
  } else {
    cudaGraphExecUpdateResultInfo info;
    e = cudaGraphExecUpdate(p->exec, g, &info);
  }
  cudaGraphDestroy(g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGraphLaunch(p->exec, stream);
}

}  // namespace come
