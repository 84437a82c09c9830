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
//     (sgns_common.cuh: negative_kernel);
//   * one atomic read-modify-write per slot: emb[v] -= lr * dphi;
//   * at an R-block end the pool gradient is applied (atomic).
//
// What bounds it on the H100: as in walk_sgns.cu the negative pass
// (3 x 128 x KP x d multiply-adds per row) is compute and the gather and
// scatter are row traffic; a slot has at most 32 partners (the layout's
// max_fanout), so this design scores only the pairs the mask keeps (warp
// per slot) instead of the TPU's dense [128, 128] block, and shares the
// tiled SIMT negative pass with the walk kernel.  K2b rounds the staged
// rows and each pair's g as they are made, a few conversions per element.

#include "sgns_common.cuh"

namespace come {

static inline size_t star_pos_smem_bytes(int d) {
  return sizeof(float) * (size_t)BLK * (d + 1);
}

// Positive pairs of one 128-slot row.  grid NBLK, block THREADS.
// Writes (overwrites) dphi and nt for the row's slots and adds the positive
// loss and the pair count to stats.  BF16 rounds the staged rows and g.
template <bool BF16>
static __global__ void __launch_bounds__(THREADS)
star_pos_kernel(const float* __restrict__ emb, const int* __restrict__ slots,
                const int* __restrict__ meta, int d,
                float* __restrict__ dphi, float* __restrict__ nt,
                double* __restrict__ stats) {
  extern __shared__ float smem[];
  __shared__ int ms[BLK];
  const int ds = d + 1;
  float* phi = smem;  // [BLK][ds]
  const int base = blockIdx.x * BLK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < BLK * d; idx += THREADS) {
    const int t = idx / d, k = idx - t * d;
    phi[t * ds + k] = mxu<BF16>(emb[(size_t)slots[base + t] * d + k]);
  }
  if (threadIdx.x < BLK) ms[threadIdx.x] = meta[base + threadIdx.x];
  __syncthreads();

  float loss = 0.0f, pairs = 0.0f;
  for (int a = warp; a < BLK; a += NWARPS) {
    const int ma = ms[a];
    float acc[KMAX];
#pragma unroll
    for (int m = 0; m < KMAX; ++m) acc[m] = 0.0f;
    int n = 0;
    for (int b = 0; b < BLK; ++b) {
      const int mb = ms[b];
      if ((mb >> 1) != (ma >> 1) || ((ma ^ mb) & 1) != 1) continue;
      float p = 0.0f;
#pragma unroll
      for (int m = 0; m < KMAX; ++m) {
        const int k = lane + 32 * m;
        if (k < d) p = fmaf(phi[a * ds + k], phi[b * ds + k], p);
      }
      const float s = warp_sum(p);
      // source + context side: g[a, b] = g[b, a], so twice the rounded g
      const float g2 = 2.0f * mxu<BF16>(sigmoid_f(s) - 1.0f);
      if (lane == 0) loss -= log_sigmoid_f(s);
#pragma unroll
      for (int m = 0; m < KMAX; ++m) {
        const int k = lane + 32 * m;
        if (k < d) acc[m] = fmaf(g2, phi[b * ds + k], acc[m]);
      }
      ++n;
    }
#pragma unroll
    for (int m = 0; m < KMAX; ++m) {
      const int k = lane + 32 * m;
      if (k < d) dphi[(size_t)(base + a) * d + k] = acc[m];
    }
    if (lane == 0) {
      nt[base + a] = (float)n;
      pairs += (float)n;
    }
  }
  block_add(loss, &stats[0]);
  block_add(pairs, &stats[1]);
}

// emb[slots[t]] -= lr * dphi[t] for slots with pairs (the others carry
// exactly zero updates).  grid GROUP, block 128.
static __global__ void star_scatter_kernel(float* __restrict__ emb,
                                           const int* __restrict__ slots,
                                           const float* __restrict__ dphi,
                                           const float* __restrict__ nt, int d,
                                           float lr) {
  const int t = blockIdx.x;
  if (nt[t] == 0.0f) return;
  const size_t dst = (size_t)slots[t] * d, src = (size_t)t * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x)
    atomicAdd(&emb[dst + k], -lr * dphi[src + k]);
}

template <bool BF16>
static int star_groups(float* emb, const int* slots, const int* meta,
                       const int* pools, double* stats, float* cneg,
                       float* dneg, float* dphi, float* nt, int d, int G,
                       int KP, int R, float lr, float negw,
                       cudaStream_t stream) {
  if (d > MAX_DIM || R < 1) return (int)cudaErrorInvalidValue;
  const size_t pos_smem = star_pos_smem_bytes(d);
  const size_t neg_smem = negative_smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      star_pos_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pos_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(negative_kernel<BF16, float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)neg_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 neg_grid(NBLK, (KP + KC - 1) / KC);
  for (int g = 0; g < G; ++g) {
    const int* pool = pools + (size_t)(g / R) * KP;
    const int* sg = slots + (size_t)g * GROUP;
    if (g % R == 0) {
      stage_pool_kernel<<<KP, 128, 0, stream>>>(emb, pool, cneg, dneg, d);
      COME_CHECK_LAUNCH();
    }
    star_pos_kernel<BF16><<<NBLK, THREADS, pos_smem, stream>>>(
        emb, sg, meta + (size_t)g * GROUP, d, dphi, nt, stats);
    COME_CHECK_LAUNCH();
    negative_kernel<BF16, float><<<neg_grid, THREADS, neg_smem, stream>>>(
        emb, sg, nt, cneg, d, KP, negw, dphi, dneg, stats);
    COME_CHECK_LAUNCH();
    star_scatter_kernel<<<GROUP, 128, 0, stream>>>(emb, sg, dphi, nt, d, lr);
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
//   cneg, dneg   [KP, d] f32 scratch;  dphi [1024, d], nt [1024] f32 scratch
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
