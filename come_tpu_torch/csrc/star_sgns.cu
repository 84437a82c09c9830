// Star (fan-out) tied SGNS macro step (O2) for Hopper, f32 table.
//
// Replaces the Pallas kernel come_tpu/ops/pallas_star_sgns.py::_star_kernel
// as called by fused_star_sgns_step (K2), and its mxu_bf16=True mode (K2b:
// phi_bm and g_m rounded to bf16 at :135, :156, and the negative pass's
// operands, sgns_common.cuh; every sum f32).  Slots come in groups of 1024 (eight
// 128-slot rows of the star layout, sampling/stars.py); groups run in
// order, each reading the table as the previous group left it:
//   * at an R-block start the pool rows are staged and dneg is zeroed;
//   * slots a, b of one 128-slot row pair when they share a segment and
//     exactly one of them is the hub (meta = seg*2 + hub, -2 at pads);
//     for each such pair g = sigmoid(phi_a . phi_b) - 1 and the tied
//     update is dphi_a += g phi_b from both the source and the context
//     side (g is symmetric), n_a = number of partners;
//   * every slot scores the staged pool with weight negw * n_a
//     (sgns_common.cuh: NegativePass);
//   * one atomic read-modify-write per slot: emb[v] -= lr * dphi;
//   * at an R-block end the pool gradient is applied (atomic).
//
// What bounds it on the H100: as in walk_sgns.cu the negative pass
// (3 x 128 x KP x d multiply-adds per row) is compute and the gather and
// scatter are row traffic.  The star pass is small work (about 1000 pairs
// x 3 x d multiply-adds a group), so what bounds it is latency: it scores
// only the pairs the mask keeps, each once, spread over 128 CTAs a group
// that each own the segments whose hub lies in their 8-slot strip
// (star_pos.cuh: StarPosPass), instead of the TPU's dense [128, 128]
// block.  The negative pass is the walk kernel's (sgns_common.cuh: FFMA
// for K2, the tensor cores for K2b).  K2b's star pass rounds the staged
// rows and each pair's g as they are made, a few conversions per element.
// Past d 192 K2 and K2b hold their owned star rows whole where a row's 128
// rows fit (star_pos_wide_kernel: K2 to d 440, K2b to 880), else stage
// them one column slab of 128 at a time (star_pos_slab_kernel); the
// negative pass is its wide kernel
// (sgns_common.cuh: NEG_WHOLE).
// The group loop is recorded once as a CUDA graph that the card replays
// (step_graph.cuh), behind a head kernel that copies the call's slots,
// meta and pools into the plan's buffers, each kernel after the first two
// under programmatic dependent launch (sgns_common.cuh).

#include "sgns_common.cuh"
#include "star_pos.cuh"
#include "step_graph.cuh"

namespace come {

// emb[slots[t]] -= lr * (dphi[t] + dphin[t]) for slots with pairs (the
// others carry exactly zero updates): the positive and the negative part
// add once here, as the plain version adds them.  grid GROUP, block 128.
// PDL (sgns_common.cuh): lr (the head's) before the wait; then whether
// the slot has pairs (nt, the star pass's), dphi, dphin and the table.
static __global__ void star_scatter_kernel(float* emb, const int* slots,
                                           const float* dphi,
                                           const float* dphin,
                                           const float* nt, int d,
                                           const StepArgs* args) {
  const int t = blockIdx.x;
  const float lr = step_ld(&args->lr);
  pdl_wait();
  if (step_ld(nt + t) == 0.0f) return;
  const size_t dst = (size_t)step_ld(slots + t) * d, src = (size_t)t * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x)
    atomicAdd(&emb[dst + k],
              -lr * (step_ld(dphi + src + k) + step_ld(dphin + src + k)));
  pdl_trigger();
}

// The group loop of one step, launched on `stream` (the recording stream),
// after the head kernel: slots, meta and pools are the plan's copies.
// Every kernel after the first under PDL.  `launched` receives the route
// of the star pass it launched (PosRoute), and `pool_launched` counts the
// pool passes it launched (PoolPass).
template <bool BF16>
static int star_groups(const NegSetup& ns, float* emb, const int* slots,
                       const int* meta, const int* pools, double* stats,
                       float* cneg, float* dneg, float* dphi, float* nt,
                       const StepArgs* args, int d, int G, int KP, int R,
                       float negw, int* launched, int* pool_launched,
                       cudaStream_t stream) {
  StarPosPass<BF16> pos;
  pos.smem = StarPosPass<BF16>::smem_bytes(d);
  NegativePass<BF16, float> neg;
  static_cast<NegSetup&>(neg) = ns;
  float* dphin = dphi + (size_t)GROUP * d;  // the negative pass's part
  cudaError_t e;
  for (int g = 0; g < G; ++g) {
    const int* pool = pools + (size_t)(g / R) * KP;
    const int* sg = slots + (size_t)g * GROUP;
    if (g % R == 0) {
      e = neg.stage(emb, pool, cneg, dneg, d, KP, stream, g > 0,
                    pool_launched);
      if (e != cudaSuccess) return (int)e;
    }
    e = pos.launch(emb, sg, meta + (size_t)g * GROUP, d, dphi, dphin, nt,
                   stats, stream, true);
    if (e != cudaSuccess) return (int)e;
    *launched = pos.launched;
    e = neg.launch(emb, sg, nt, cneg, d, KP, negw, dphin, dneg, stats, stream,
                   true);
    if (e != cudaSuccess) return (int)e;
    e = launch_kernel(star_scatter_kernel, dim3(GROUP), dim3(128), 0, stream,
                      true, 0, emb, sg, dphi, dphin, nt, d, args);
    if (e != cudaSuccess) return (int)e;
    if (g % R == R - 1 || g == G - 1) {
      e = launch_kernel(apply_pool_kernel, dim3(KP), dim3(128), 0, stream,
                        true, 0, emb, pool, dneg, d, args, 0.0f);
      if (e != cudaSuccess) return (int)e;
      ++pool_launched[PASS_APPLY_POOL];
    }
  }
  return 0;
}

// One step in one mode: checks the shapes, sets the kernels up at the
// plan's first step (the star pass's shared-memory cap, the negative pass's
// sizing), records the step if `how` asks (the head kernel, then the group
// loop; step_graph.cuh) and replays it with this call's head parameters.
template <bool BF16>
static int star_step(StepGraph* p, int how, float* emb, const HeadIn& hin,
                     const HeadBufs& hb, double* stats, float* cneg,
                     float* dneg, float* dphi, float* nt, int d, int G,
                     int KP, int R, float negw, cudaStream_t stream) {
  if (p == nullptr || d < 1 || G < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  if (p->mode < 0) {
    StarPosPass<BF16> pos;
    cudaError_t e = pos.init(d);
    if (e != cudaSuccess) return (int)e;
    NegativePass<BF16, float> neg;
    e = neg.init(d, KP, GROUP);
    if (e != cudaSuccess) return (int)e;
    p->neg = neg;
    p->mode = BF16;
  } else if (p->mode != (int)BF16) {
    return (int)cudaErrorInvalidValue;  // a plan serves one mode
  }
  return run_step(
      p, how, stream,
      [&](cudaStream_t cap) -> int {
        const cudaError_t e = launch_head(hin, hb, cap);
        if (e != cudaSuccess) return (int)e;
        return star_groups<BF16>(p->neg, emb, hb.dst[0], hb.dst[1],
                                 hb.dst[2], stats, cneg, dneg, dphi, nt,
                                 hb.args, d, G, KP, R, negw, &p->route,
                                 p->pool, cap);
      },
      step_head_kernel, hin, hb);
}

}  // namespace come

using namespace come;

// One O2 macro step over G groups through the plan's graph slot `graph`
// (come_step_graph_new): `record` 1 records the step and instantiates the
// slot's graph (the plan's first step), 2 records it and updates the
// instance (the table moved), 0 replays it; every call sets the head
// kernel's parameters (the call's slots, meta and pools, lr) and launches
// the instance on `stream`.  All buffers are device pointers:
//   emb          [V, d] f32 (updated in place)
//   slots, meta  [G * 1024] i32 (meta -2 at pads)
//   pools        [ceil(G / R), KP] i32
//   stats        [2] f64 scratch: the step's (loss, pairs)
//   cneg, dneg   [KP, d] f32 scratch;  nt [1024] f32 scratch
//   dphi         [2, 1024, d] f32 scratch: the star pass's part of each
//                slot's update, then the negative pass's
//   slots_buf, meta_buf, pools_buf: the plan's copies of slots, meta and
//                pools, which the loop reads
//   args         the plan's argument block (sgns_common.cuh: StepArgs)
// bf16 != 0 selects K2b's rounding; a plan serves one mode and one
// (d, G, KP, R); its recording holds the table's address and negw.  Returns
// 0 or the first CUDA error code.  Enqueues only: it does not synchronise
// and allocates no device memory.
extern "C" int come_star_sgns_step(void* graph, int record, float* emb,
                                   const int* slots, const int* meta,
                                   const int* pools, double* stats,
                                   float* cneg, float* dneg, float* dphi,
                                   float* nt, int* slots_buf, int* meta_buf,
                                   int* pools_buf, void* args, int d, int G,
                                   int KP, int R, int bf16, float lr,
                                   float negw, void* stream_ptr) {
  StepGraph* p = static_cast<StepGraph*>(graph);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n = G * GROUP, np = (G + R - 1) / R * KP;
  const HeadIn hin{{slots, meta, pools, nullptr}, lr, 0u};
  const HeadBufs hb{{slots_buf, meta_buf, pools_buf, nullptr},
                    {n, n, np, 0}, static_cast<StepArgs*>(args), stats};
  return bf16 ? star_step<true>(p, record, emb, hin, hb, stats, cneg, dneg,
                                dphi, nt, d, G, KP, R, negw, stream)
              : star_step<false>(p, record, emb, hin, hb, stats, cneg, dneg,
                                 dphi, nt, d, G, KP, R, negw, stream);
}

// The star pass a star step of width d takes (sgns_common.cuh: PosRoute):
// 0 d <= 192 (star_pos_kernel), 1 whole rows (star_pos_wide_kernel), 2
// column slabs (star_pos_slab_kernel); bf16 != 0 for K2b (and P3).
extern "C" int come_star_pos_route(int d, int bf16) {
  return star_pos_route(d, bf16 != 0);
}
