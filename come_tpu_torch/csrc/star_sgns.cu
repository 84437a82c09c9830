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

#include "sgns_common.cuh"
#include "star_pos.cuh"

namespace come {

// emb[slots[t]] -= lr * (dphi[t] + dphin[t]) for slots with pairs (the
// others carry exactly zero updates): the positive and the negative part
// add once here, as the plain version adds them.  grid GROUP, block 128.
static __global__ void star_scatter_kernel(float* __restrict__ emb,
                                           const int* __restrict__ slots,
                                           const float* __restrict__ dphi,
                                           const float* __restrict__ dphin,
                                           const float* __restrict__ nt, int d,
                                           float lr) {
  const int t = blockIdx.x;
  if (nt[t] == 0.0f) return;
  const size_t dst = (size_t)slots[t] * d, src = (size_t)t * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x)
    atomicAdd(&emb[dst + k], -lr * (dphi[src + k] + dphin[src + k]));
}

template <bool BF16>
static int star_groups(float* emb, const int* slots, const int* meta,
                       const int* pools, double* stats, float* cneg,
                       float* dneg, float* dphi, float* nt, int d, int G,
                       int KP, int R, float lr, float negw,
                       cudaStream_t stream) {
  if (d > MAX_DIM || R < 1) return (int)cudaErrorInvalidValue;
  StarPosPass<BF16> pos;
  cudaError_t e = pos.init(d);
  if (e != cudaSuccess) return (int)e;
  NegativePass<BF16, float> neg;
  e = neg.init(d, KP, GROUP);
  if (e != cudaSuccess) return (int)e;
  float* dphin = dphi + (size_t)GROUP * d;  // the negative pass's part
  for (int g = 0; g < G; ++g) {
    const int* pool = pools + (size_t)(g / R) * KP;
    const int* sg = slots + (size_t)g * GROUP;
    if (g % R == 0) {
      stage_pool_kernel<<<KP, 128, 0, stream>>>(emb, pool, cneg, dneg, d);
      COME_CHECK_LAUNCH();
    }
    pos.launch(emb, sg, meta + (size_t)g * GROUP, d, dphi, dphin, nt, stats,
               stream);
    COME_CHECK_LAUNCH();
    neg.launch(emb, sg, nt, cneg, d, KP, negw, dphin, dneg, stats, stream);
    COME_CHECK_LAUNCH();
    star_scatter_kernel<<<GROUP, 128, 0, stream>>>(emb, sg, dphi, dphin, nt,
                                                   d, lr);
    COME_CHECK_LAUNCH();
    if (g % R == R - 1 || g == G - 1) {
      apply_pool_kernel<<<KP, 128, 0, stream>>>(emb, pool, dneg, d, lr);
      COME_CHECK_LAUNCH();
    }
  }
  return 0;
}

}  // namespace come

using namespace come;

// One O2 macro step over G groups.  All buffers are device pointers:
//   emb          [V, d] f32 (updated in place)
//   slots, meta  [G * 1024] i32 (meta -2 at pads)
//   pools        [ceil(G / R), KP] i32
//   stats        [2] f64, accumulates (loss, pairs)
//   cneg, dneg   [KP, d] f32 scratch;  nt [1024] f32 scratch
//   dphi         [2, 1024, d] f32 scratch: the star pass's part of each
//                slot's update, then the negative pass's
// bf16 != 0 selects K2b's rounding.
// Returns 0 or the first CUDA error code.  Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int come_star_sgns_step(float* emb, const int* slots,
                                   const int* meta, const int* pools,
                                   double* stats, float* cneg, float* dneg,
                                   float* dphi, float* nt, int d, int G, int KP,
                                   int R, int bf16, float lr, float negw,
                                   void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return bf16 ? star_groups<true>(emb, slots, meta, pools, stats, cneg, dneg,
                                  dphi, nt, d, G, KP, R, lr, negw, stream)
              : star_groups<false>(emb, slots, meta, pools, stats, cneg, dneg,
                                   dphi, nt, d, G, KP, R, lr, negw, stream);
}
