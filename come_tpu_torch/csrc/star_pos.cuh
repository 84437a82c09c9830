// The star kernel's positive pass (K2, K2b), shared by star_sgns.cu and the
// section probe star_probe.cu (P3).  See star_sgns.cu for the semantics.

#pragma once

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

}  // namespace come
