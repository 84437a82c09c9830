// A step as one launch unit: its group or tile loop recorded once as a
// CUDA graph and replayed.
//
// The TPU runs a macro step as one pallas_call with a grid over the groups
// (pallas_walk_sgns.py:564, :611; pallas_star_sgns.py:282, :309), and a
// compiled program is never traced again.  The card's group loops
// (walk_sgns.cu, star_sgns.cu) and K6/K7's tile loop (sgns_fused.cu) keep
// their order with stream-ordered launches, so a plan records its loop
// once on a private stream (cudaStreamCaptureModeThreadLocal: the host
// corpus's feeder thread keeps using CUDA meanwhile) and instantiates it;
// a call then only sets the parameters of the graph's head kernel and
// launches the instance on the caller's stream.  The head kernel is the
// step's first node and the only one whose parameters change between
// calls: it copies the call's inputs into the plan's buffers (K6/K7 packs
// them) and writes lr, the SR seed and K6/K7's result pointer into the
// plan's argument block (sgns_common.cuh: StepArgs), which every later
// kernel reads after its wait.  Everything else a recording captures (the
// tables' addresses, negw, the plan's buffers and sizes) is the plan's;
// when a table moves (K3's working tables each epoch, the row-sharded
// path's compact tables each step) the plan records again and applies the
// recording to its instance with cudaGraphExecUpdate (ops/launch_plan.py
// counts it as an update).  Inside the graph the kernels after the first
// start under programmatic dependent launch (sgns_common.cuh).  Nothing
// here waits on the host: recording, update and launch only enqueue.  Any
// failure is returned as its CUDA error; the wrappers raise.

#pragma once

#include "sgns_common.cuh"

// The WHILE graphs (step_graph.cu): K6/K7's scan builds one as the GMM's
// EM does.
extern "C" int come_while_flag(const bool* go, int n, const int* it,
                               const int* max_iter, unsigned long long handle,
                               void* stream);
extern "C" int come_while_graph_build(void* slot, void* entry, void* body);
extern "C" int come_while_graph_launch(void* slot, void* stream);

namespace come {

struct StepGraph {
  cudaStream_t cap = nullptr;      // the private stream a step is recorded on
  cudaGraphExec_t exec = nullptr;  // the instance, made by the first recording
  cudaGraph_t graph = nullptr;     // that recording, kept: its head node
  cudaGraphNode_t head = nullptr;  // names the instance's head kernel
  cudaKernelNodeParams head_params = {};  // the head's function and shape
  int mode = -1;                   // the C entry's mode, fixed at setup
  NegSetup neg;                    // the negative pass's sizing, found at setup
  int route = -1;  // the band or star pass the recording launched (PosRoute)
  int pool[POOL_PASSES] = {};  // the pool passes it launched, by PoolPass
};

// What a call asks of a plan's recording (ops/launch_plan.py:
// LaunchPlan.begin): none (replay the instance), the first (instantiate)
// or a new one (a table moved: update the instance).
enum { RECORD_NONE = 0, RECORD_INSTANTIATE = 1, RECORD_UPDATE = 2 };

// Records `record(stream)` (which launches the step's kernels on the stream
// it is given and returns 0 or a CUDA error) into a graph and makes it the
// plan's instance (RECORD_INSTANTIATE, keeping the graph and, with `head`,
// its one root node, a kernel) or applies it to the instance
// (RECORD_UPDATE).
template <typename Record>
static int record_step(StepGraph* p, int how, Record record,
                       bool head = true) {
  if (p == nullptr || p->cap == nullptr ||
      (how != RECORD_INSTANTIATE && how != RECORD_UPDATE) ||
      (how == RECORD_INSTANTIATE) != (p->exec == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaStreamBeginCapture(p->cap, cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  for (int& n : p->pool) n = 0;  // the group loop counts this recording's
  const int rc = record(p->cap);
  cudaGraph_t g = nullptr;
  e = cudaStreamEndCapture(p->cap, &g);  // whatever record returned
  if (rc != 0 || e != cudaSuccess) {
    if (g != nullptr) cudaGraphDestroy(g);
    return rc != 0 ? rc : (int)e;
  }
  if (how == RECORD_UPDATE) {
    cudaGraphExecUpdateResultInfo info;
    e = cudaGraphExecUpdate(p->exec, g, &info);
    cudaGraphDestroy(g);
    return (int)e;
  }
  if (head) {
    size_t n = 0;
    e = cudaGraphGetRootNodes(g, nullptr, &n);
    if (e == cudaSuccess && n != 1) e = cudaErrorInvalidValue;
    if (e == cudaSuccess) e = cudaGraphGetRootNodes(g, &p->head, &n);
    if (e == cudaSuccess)
      e = cudaGraphKernelNodeGetParams(p->head, &p->head_params);
  }
  if (e == cudaSuccess) e = cudaGraphInstantiate(&p->exec, g, 0);
  if (e != cudaSuccess) {
    cudaGraphDestroy(g);
    p->exec = nullptr;
    p->head = nullptr;
    return (int)e;
  }
  p->graph = g;
  return 0;
}

// Launches the plan's instance on `stream` with its head kernel's
// parameters set to `args` (converted to the kernel's parameter types, as
// a launch converts them).  The instance keeps them for later launches;
// launches already enqueued keep theirs.
template <typename... P, typename... A>
static int replay_step(StepGraph* p, void (*)(P...), cudaStream_t stream,
                       A... args) {
  if (p == nullptr || p->exec == nullptr || p->head == nullptr)
    return (int)cudaErrorInvalidValue;
  return [&](P... a) -> int {
    void* params[] = {const_cast<void*>(static_cast<const void*>(&a))...};
    cudaKernelNodeParams kp = p->head_params;
    kp.kernelParams = params;
    kp.extra = nullptr;
    const cudaError_t e =
        cudaGraphExecKernelNodeSetParams(p->exec, p->head, &kp);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGraphLaunch(p->exec, stream);
  }(args...);
}

// One call of a plan: record as `how` says (RECORD_NONE: not at all), then
// replay with the head kernel `head`'s parameters `args`.
template <typename Record, typename... P, typename... A>
static int run_step(StepGraph* p, int how, cudaStream_t stream, Record record,
                    void (*head)(P...), A... args) {
  if (how != RECORD_NONE) {
    const int rc = record_step(p, how, record);
    if (rc != 0) return rc;
  }
  return replay_step(p, head, stream, args...);
}

// The head kernel of a walk or star step (walk_sgns.cu, star_sgns.cu): the
// call's input arrays (walks or star slots, window draws or meta, pools,
// K4's starts and draws) copied into the plan's buffers, lr and the SR seed
// into its argument block, and the step's (loss, pairs) zeroed.
constexpr int HEAD_ARRAYS = 4;
struct HeadIn {  // the call's: set on the head node at every call
  const int* src[HEAD_ARRAYS];
  float lr;
  unsigned seed;
};
struct HeadBufs {  // the plan's
  int* dst[HEAD_ARRAYS];
  int n[HEAD_ARRAYS];  // int32 elements of each array (0: none)
  StepArgs* args;
  double* stats;
};

// The step's first kernel, launched without PDL (the kernel after it reads
// what it writes before that kernel's wait, so it launches without PDL
// too).  grid HEAD_BLOCKS, block 256.
constexpr int HEAD_BLOCKS = 132;
static __global__ void step_head_kernel(HeadIn in, HeadBufs b) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    b.args->lr = in.lr;
    b.args->seed = in.seed;
    b.stats[0] = 0.0;
    b.stats[1] = 0.0;
  }
  const size_t step = (size_t)gridDim.x * blockDim.x;
#pragma unroll
  for (int a = 0; a < HEAD_ARRAYS; ++a)
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < (size_t)b.n[a]; i += step)
      b.dst[a][i] = in.src[a][i];
}

static cudaError_t launch_head(const HeadIn& in, const HeadBufs& b,
                               cudaStream_t stream) {
  return launch_kernel(step_head_kernel, dim3(HEAD_BLOCKS), dim3(256), 0,
                       stream, false, 0, in, b);
}

}  // namespace come
