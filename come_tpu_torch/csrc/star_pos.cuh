// The star kernel's positive pass (K2, K2b), shared by star_sgns.cu and the
// section probe star_probe.cu (P3).  See star_sgns.cu for the semantics.
//
// It relies on what sampling/stars.py::build_star_layout guarantees of each
// 128-slot row (the layout every caller passes):
//   * a segment is a contiguous run of slots inside one row, with one
//     segment id (meta >> 1), and segment ids are row-local: two segments
//     of a row never share one, so a segment ends where the id changes;
//   * the hub sits at the segment's first slot (meta seg * 2 + 1), its
//     leaves after it (meta seg * 2);
//   * a segment has at most max_fanout leaves (32 by default, 127 at most
//     in a row);
//   * pads carry meta -2 (segment -1), anywhere in a row.
// So the pairs the TPU's dense mask keeps (same segment, exactly one hub:
// pallas_star_sgns.py:144-146) are (hub, leaf) for each leaf, once each.
//
// Work split: the 128 slots of a row are cut into strips of STAR_STRIP
// slots, one CTA each (STAR_NSTRIP x 8 = 128 CTAs a group).  A CTA owns the
// segments whose hub lies in its strip.  It stages their rows, the strip's
// first hub to the end of its last segment (at most the rest of the row),
// with 16-byte loads; scores each (hub, leaf) pair once (8 lanes a pair)
// and uses its g for both ends; and writes every slot of its segments
// without atomics: a leaf's dphi is g2 phi_hub and n = 1, its hub's the
// sum of g2 phi_leaf over the leaves in slot order and n = the leaf count
// (bit for bit the per-slot sums of the earlier warp-per-slot design, given
// the same scores).  The pads of its strip it writes as zeros.  So every
// slot has one writer, and no chain of dependent dot products is longer
// than one segment's leaves.

#pragma once

#include "sgns_common.cuh"

namespace come {

constexpr int STAR_STRIP = 8;                  // slots a star CTA owns hubs in
constexpr int STAR_NSTRIP = BLK / STAR_STRIP;  // star CTAs per row
constexpr int STAR_THREADS = BLK;              // one thread per slot of the row

// Staged rows: d rounded up to a float4, + 4 floats of stride.
static __host__ __device__ inline int star_stride(int d) {
  return ((d + 3) & ~3) + 4;
}

static inline size_t star_pos_smem_bytes(int d) {
  return sizeof(float) * (size_t)BLK * star_stride(d);
}

// Positive pairs of the segments whose hub lies in strip blockIdx.x of row
// blockIdx.y (slots base + t of emb[slots[base + t]], meta meta[base + t]).
// grid (STAR_NSTRIP, rows), block STAR_THREADS.  Writes (overwrites) dphi
// and nt for the slots of those segments and for the strip's pads, zeroes
// their rows of dphin unless it is null (the negative pass then adds to
// it), and adds their positive loss (-log sigmoid(s) once per ordered pair)
// and pair count to stats.  BF16 rounds the staged rows and g.
template <bool BF16>
static __global__ void __launch_bounds__(STAR_THREADS)
star_pos_kernel(const float* __restrict__ emb, const int* __restrict__ slots,
                const int* __restrict__ meta, int d,
                float* __restrict__ dphi, float* __restrict__ dphin,
                float* __restrict__ nt, double* __restrict__ stats) {
  extern __shared__ float4 star_smem[];
  float* phi = reinterpret_cast<float*>(star_smem);  // [BLK][ds]: slot lo + r
  __shared__ int ms[BLK], ids[BLK], hub[BLK];  // meta, row, segment start
  __shared__ float gl[BLK];                    // g2 of the leaf at lo + r
  __shared__ unsigned first[BLK / 32], last[BLK / 32];  // segment bounds
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int base = blockIdx.y * BLK, s0 = blockIdx.x * STAR_STRIP;
  const int ds = star_stride(d), dp = ds - 4, n4 = dp / 4;

  const int m = meta[base + t];
  ms[t] = m;
  ids[t] = slots[base + t];
  __syncthreads();
  const bool real = m >= 0;
  const unsigned fb = __ballot_sync(
      0xffffffffu, real && (t == 0 || (ms[t - 1] >> 1) != (m >> 1)));
  const unsigned lb = __ballot_sync(
      0xffffffffu, real && (t == BLK - 1 || (ms[t + 1] >> 1) != (m >> 1)));
  if (lane == 0) {
    first[warp] = fb;
    last[warp] = lb;
  }
  __syncthreads();
  // the start (hub) of t's segment: the last first slot at or before t
  int h = -1;
  for (int w = warp; w >= 0 && real; --w) {
    const unsigned bits = w == warp ? first[w] & ((2u << lane) - 1u) : first[w];
    if (bits) {
      h = 32 * w + 31 - __clz(bits);
      break;
    }
  }
  hub[t] = h;

  // the strip's pads: zeros
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int idx = t; idx < STAR_STRIP * n4; idx += STAR_THREADS) {
    const int a = s0 + idx / n4;
    if (ms[a] >= 0) continue;
    store4(dphi + (size_t)(base + a) * d, d, 4 * (idx % n4), zero);
    if (dphin) store4(dphin + (size_t)(base + a) * d, d, 4 * (idx % n4), zero);
  }
  if (t < STAR_STRIP && ms[s0 + t] < 0) nt[base + s0 + t] = 0.0f;
  const unsigned own =
      (first[s0 >> 5] >> (s0 & 31)) & ((1u << STAR_STRIP) - 1u);
  if (!own) return;  // no hub in the strip (uniform over the CTA)
  // the owned segments span [lo, hi): the strip's first hub to the end of
  // its last segment
  const int lo = s0 + __ffs(own) - 1, top = s0 + 31 - __clz(own);
  int hi = BLK;
  for (int w = top >> 5; w < BLK / 32; ++w) {
    const unsigned bits = w == top >> 5 ? last[w] & (~0u << (top & 31)) : last[w];
    if (bits) {
      hi = 32 * w + __ffs(bits);
      break;
    }
  }
  const int nr = hi - lo;
  stage_rows<STAR_THREADS, 8, float>(
      nr, d, dp, [&](int i) { return emb + (size_t)ids[lo + i] * d; },
      [&](int i, int c, float4 v) {
        *reinterpret_cast<float4*>(phi + i * ds + c) =
            make_float4(mxu<BF16>(v.x), mxu<BF16>(v.y), mxu<BF16>(v.z),
                        mxu<BF16>(v.w));
      });
  __syncthreads();

  // each (hub, leaf) pair once, 8 lanes a pair: g2 = 2 g (source and
  // context side: g[a, b] = g[b, a]) and twice its loss
  const int lane8 = t & 7;
  float loss = 0.0f;
  for (int r0 = 0; r0 < nr; r0 += STAR_THREADS / 8) {
    const int r = r0 + (t >> 3), u = lo + r;
    const bool leaf = r < nr && ms[u] >= 0 && hub[u] != u;
    float s = 0.0f;
    if (leaf) {
      const float4* a = reinterpret_cast<const float4*>(phi + r * ds);
      const float4* b = reinterpret_cast<const float4*>(phi + (hub[u] - lo) * ds);
      for (int q = lane8; q < n4; q += 8) {
        const float4 x = a[q], y = b[q];
        s = fmaf(x.x, y.x, s);
        s = fmaf(x.y, y.y, s);
        s = fmaf(x.z, y.z, s);
        s = fmaf(x.w, y.w, s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (leaf && lane8 == 0) {
      gl[r] = 2.0f * mxu<BF16>(sigmoid_f(s) - 1.0f);
      loss -= 2.0f * log_sigmoid_f(s);
    }
  }
  __syncthreads();

  // dphi of each owned slot, 4 elements a thread: a leaf's g2 phi_hub, a
  // hub's sum over its leaves in slot order
  for (int idx = t; idx < nr * n4; idx += STAR_THREADS) {
    const int r = idx / n4, c = 4 * (idx - r * n4), u = lo + r;
    if (ms[u] < 0) continue;  // a pad: written above
    float4 acc = zero;
    if (hub[u] != u) {
      fma4(gl[r], *reinterpret_cast<const float4*>(phi + (hub[u] - lo) * ds + c),
           acc);
    } else {
      for (int v = u + 1; v < hi && hub[v] == u; ++v)
        fma4(gl[v - lo], *reinterpret_cast<const float4*>(phi + (v - lo) * ds + c),
             acc);
    }
    store4(dphi + (size_t)(base + u) * d, d, c, acc);
    if (dphin) store4(dphin + (size_t)(base + u) * d, d, c, zero);
  }
  // n: 1 for a leaf, the leaf count for a hub
  float pairs = 0.0f;
  for (int r = t; r < nr; r += STAR_THREADS) {
    const int u = lo + r;
    if (ms[u] < 0) continue;
    float n = 1.0f;
    if (hub[u] == u) {
      n = 0.0f;
      for (int v = u + 1; v < hi && hub[v] == u; ++v) n += 1.0f;
    }
    nt[base + u] = n;
    pairs += n;
  }
  block_add<STAR_THREADS>(loss, &stats[0]);
  block_add<STAR_THREADS>(pairs, &stats[1]);
}

// The star pass of one instance: init() once per call (checks d, sets the
// kernel's shared memory), then launch() once per group of 8 rows.
template <bool BF16>
struct StarPosPass {
  size_t smem = 0;

  cudaError_t init(int d) {
    if (d < 1 || d > MAX_DIM) return cudaErrorInvalidValue;
    smem = star_pos_smem_bytes(d);
    return cudaFuncSetAttribute(star_pos_kernel<BF16>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }

  void launch(const float* emb, const int* slots, const int* meta, int d,
              float* dphi, float* dphin, float* nt, double* stats,
              cudaStream_t stream) const {
    star_pos_kernel<BF16><<<dim3(STAR_NSTRIP, NBLK), STAR_THREADS, smem,
                            stream>>>(emb, slots, meta, d, dphi, dphin, nt,
                                      stats);
  }
};

}  // namespace come
