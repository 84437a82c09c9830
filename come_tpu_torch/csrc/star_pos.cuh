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
// Past MAX_DIM the same split holds the owned rows whole where a row's
// 128 rows fit (star_pos_wide_kernel, f32 to d 440, bf16 to d 880) and
// stages them in column slabs past that (star_pos_slab_kernel).
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

// A 128-slot row of the layout as the star passes read it: each slot's
// meta and table row, the start (hub) of its segment (-1 at pads), and the
// segments' first and last slots as bit masks.
struct StarRow {
  int ms[BLK], ids[BLK], hub[BLK];
  unsigned first[BLK / 32], last[BLK / 32];
};

// Reads the row at `base` of the stream into `r` and finds its segments
// and hubs (before the PDL wait: these are step inputs).  All STAR_THREADS
// threads call.
static __device__ __forceinline__ void read_row(StarRow& r,
                                                const int* slots,
                                                const int* meta, int base) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int m = step_ld(meta + base + t);
  r.ms[t] = m;
  r.ids[t] = step_ld(slots + base + t);
  __syncthreads();
  const bool real = m >= 0;
  const unsigned fb = __ballot_sync(
      0xffffffffu, real && (t == 0 || (r.ms[t - 1] >> 1) != (m >> 1)));
  const unsigned lb = __ballot_sync(
      0xffffffffu, real && (t == BLK - 1 || (r.ms[t + 1] >> 1) != (m >> 1)));
  if (lane == 0) {
    r.first[warp] = fb;
    r.last[warp] = lb;
  }
  __syncthreads();
  // the start (hub) of t's segment: the last first slot at or before t
  int h = -1;
  for (int w = warp; w >= 0 && real; --w) {
    const unsigned bits =
        w == warp ? r.first[w] & ((2u << lane) - 1u) : r.first[w];
    if (bits) {
      h = 32 * w + 31 - __clz(bits);
      break;
    }
  }
  r.hub[t] = h;
}

// The segments whose hub lies in the strip at s0 span [lo, hi): the
// strip's first hub to the end of its last segment.  False when no hub
// lies in the strip (uniform over the CTA).
static __device__ __forceinline__ bool owned_range(const StarRow& r, int s0,
                                                   int& lo, int& hi) {
  const unsigned own =
      (r.first[s0 >> 5] >> (s0 & 31)) & ((1u << STAR_STRIP) - 1u);
  if (!own) return false;
  const int top = s0 + 31 - __clz(own);
  lo = s0 + __ffs(own) - 1;
  hi = BLK;
  for (int w = top >> 5; w < BLK / 32; ++w) {
    const unsigned bits =
        w == top >> 5 ? r.last[w] & (~0u << (top & 31)) : r.last[w];
    if (bits) {
      hi = 32 * w + __ffs(bits);
      break;
    }
  }
  return true;
}

// n of the owned slots [lo, hi) (1 for a leaf, the leaf count for a hub)
// into nt, then the trigger, and the loss and pair count added to stats.
// All STAR_THREADS threads call.
static __device__ __forceinline__ void finish_star(const StarRow& r,
                                                   int base, int lo, int hi,
                                                   float loss, float* nt,
                                                   double* stats) {
  float pairs = 0.0f;
  for (int i = threadIdx.x; i < hi - lo; i += STAR_THREADS) {
    const int u = lo + i;
    if (r.ms[u] < 0) continue;
    float n = 1.0f;
    if (r.hub[u] == u) {
      n = 0.0f;
      for (int v = u + 1; v < hi && r.hub[v] == u; ++v) n += 1.0f;
    }
    nt[base + u] = n;
    pairs += n;
  }
  pdl_trigger();
  block_add<STAR_THREADS>(loss, &stats[0]);
  block_add<STAR_THREADS>(pairs, &stats[1]);
}

// Positive pairs of the segments whose hub lies in strip blockIdx.x of row
// blockIdx.y (slots base + t of emb[slots[base + t]], meta meta[base + t]).
// grid (STAR_NSTRIP, rows), block STAR_THREADS.  Writes (overwrites) dphi
// and nt for the slots of those segments and for the strip's pads, zeroes
// their rows of dphin unless it is null (the negative pass then adds to
// it), and adds their positive loss (-log sigmoid(s) once per ordered pair)
// and pair count to stats.  BF16 rounds the staged rows and g.  PDL
// (sgns_common.cuh): the row's meta and slots, its segment bounds and hubs
// are found before the wait; the pads' zeros (rows the last scatter reads),
// the table (the last scatter's) and every write after it.
template <bool BF16>
static __global__ void __launch_bounds__(STAR_THREADS)
star_pos_kernel(const float* emb, const int* slots, const int* meta, int d,
                float* __restrict__ dphi, float* __restrict__ dphin,
                float* __restrict__ nt, double* __restrict__ stats) {
  extern __shared__ float4 star_smem[];
  float* phi = reinterpret_cast<float*>(star_smem);  // [BLK][ds]: slot lo + r
  __shared__ StarRow row;
  __shared__ float gl[BLK];  // g2 of the leaf at lo + r
  const int* ms = row.ms;
  const int* ids = row.ids;
  const int* hub = row.hub;
  const int t = threadIdx.x;
  const int base = blockIdx.y * BLK, s0 = blockIdx.x * STAR_STRIP;
  const int ds = star_stride(d), dp = ds - 4, n4 = dp / 4;

  read_row(row, slots, meta, base);
  pdl_wait();

  // the strip's pads: zeros
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int idx = t; idx < STAR_STRIP * n4; idx += STAR_THREADS) {
    const int a = s0 + idx / n4;
    if (ms[a] >= 0) continue;
    store4(dphi + (size_t)(base + a) * d, d, 4 * (idx % n4), zero);
    if (dphin) store4(dphin + (size_t)(base + a) * d, d, 4 * (idx % n4), zero);
  }
  if (t < STAR_STRIP && ms[s0 + t] < 0) nt[base + s0 + t] = 0.0f;
  int lo, hi;
  if (!owned_range(row, s0, lo, hi)) return;  // no hub in the strip
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
  finish_star(row, base, lo, hi, loss, nt, stats);
}

static inline size_t star_pos_slab_smem_bytes() {
  return sizeof(float) * ((size_t)BLK * SLAB_STRIDE + BLK);
}

// Sized for the widest owned range, a whole row (a fat hub at a strip's
// last slot owns the rest of the row).
static inline size_t star_pos_wide_smem_bytes(int d, bool bf16) {
  return 16 + (size_t)(bf16 ? 2 : 4) * BLK * pos_wide_stride(d, bf16);
}

// Which star pass a step of width d takes (sgns_common.cuh: PosRoute).
static inline int star_pos_route(int d, bool bf16) {
  if (d <= MAX_DIM) return POS_ROWS;
  return star_pos_wide_smem_bytes(d, bf16) <= POS_WIDE_SMEM ? POS_WHOLE
                                                            : POS_SLAB;
}

// star_pos_kernel past MAX_DIM with the owned rows held whole for the pass
// (where a whole row's 128 rows fit POS_WIDE_SMEM: f32 up to d 440, 133 KB
// at d 256; bf16 up to d 880, 68 KB at 256): one sweep, which scores each
// (hub, leaf) pair once, forms g2 and the loss at once, then writes every
// owned slot's dphi (and zeroed dphin).  K2b holds its rows as bf16 (each
// element rounded to nearest even as mxu<BF16> rounds it), loaded and
// rounded by stage_rows (8 loads in flight a thread); K2's f32 rows arrive
// by one cp.async.bulk a row onto an mbarrier (4-byte cp.async where d % 4
// != 0), issued right after the wait, while the strip's pads are written.
// The segments, hubs and owned range are found before the wait.  Scoring:
// 8 lanes a pair, a lane's 16-byte pieces in column order; the updates: a
// thread owns one 16-byte piece of one slot's dphi (4 or 8 columns).  Grid,
// outputs and PDL as star_pos_kernel.
template <bool BF16>
static __global__ void __launch_bounds__(STAR_THREADS)
star_pos_wide_kernel(const float* emb, const int* slots, const int* meta,
                     int d, float* __restrict__ dphi,
                     float* __restrict__ dphin, float* __restrict__ nt,
                     double* __restrict__ stats) {
  using E = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int V = 16 / sizeof(E);  // elements of a 16-byte piece
  extern __shared__ float4 star_smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(star_smem);
  E* phi = reinterpret_cast<E*>(star_smem + 1);  // [BLK][S]: slot lo + r
  __shared__ StarRow row;
  __shared__ float gl[BLK];  // g2 of the leaf at lo + r
  const int* ms = row.ms;
  const int* ids = row.ids;
  const int* hub = row.hub;
  const int t = threadIdx.x;
  const int base = blockIdx.y * BLK, s0 = blockIdx.x * STAR_STRIP;
  const int S = pos_wide_stride(d, BF16);
  const int dp = (d + V - 1) / V * V, nq = dp / V;  // pieces a row
  const bool vec = d % 4 == 0;

  read_row(row, slots, meta, base);
  int lo = 0, hi = 0;
  const bool own = owned_range(row, s0, lo, hi);
  const int nr = hi - lo;
  if (!BF16 && own) {  // the columns past d of every held row: zeros
    for (int idx = t; idx < nr * (dp - d); idx += STAR_THREADS)
      phi[idx / (dp - d) * S + d + idx % (dp - d)] = E(0.0f);
    if (t == 0) mbar_init(bar, vec ? 1 : STAR_THREADS);
    fence_async_smem();
  }
  __syncthreads();
  pdl_wait();
  auto src = [&](int i) { return emb + (size_t)ids[lo + i] * d; };
  if (!BF16 && own) copy_rows<STAR_THREADS>(phi, S, nr, d, src, bar, vec);

  // the strip's pads: zeros
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int n4 = (d + 3) / 4;
  for (int idx = t; idx < STAR_STRIP * n4; idx += STAR_THREADS) {
    const int a = s0 + idx / n4;
    if (ms[a] >= 0) continue;
    store4(dphi + (size_t)(base + a) * d, d, 4 * (idx % n4), zero, vec);
    if (dphin)
      store4(dphin + (size_t)(base + a) * d, d, 4 * (idx % n4), zero, vec);
  }
  if (t < STAR_STRIP && ms[s0 + t] < 0) nt[base + s0 + t] = 0.0f;
  if (!own) return;  // no hub in the strip
  if constexpr (BF16) {
    stage_rows<STAR_THREADS, 8, float>(
        nr, d, dp, src, [&](int i, int c, float4 v) {
          put_bf16(phi + i * S + c, v);
        });
  } else {
    mbar_wait(bar, 0);
  }
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
      const E* a = phi + r * S;
      const E* b = phi + (hub[u] - lo) * S;
      for (int q = lane8; q < nq; q += 8) {
        float x[V], y[V];
        unpack16(a + V * q, x);
        unpack16(b + V * q, y);
#pragma unroll
        for (int k = 0; k < V; ++k) s = fmaf(x[k], y[k], s);
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

  // dphi of each owned slot, one 16-byte piece of held row a thread: a
  // leaf's g2 phi_hub, a hub's sum over its leaves in slot order
  for (int idx = t; idx < nr * nq; idx += STAR_THREADS) {
    const int r = idx / nq, c = V * (idx - r * nq), u = lo + r;
    if (ms[u] < 0) continue;  // a pad: its strip writes it
    float acc[V], v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    if (hub[u] != u) {
      unpack16(phi + (hub[u] - lo) * S + c, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = fmaf(gl[r], v[k], acc[k]);
    } else {
      for (int w = u + 1; w < hi && hub[w] == u; ++w) {
        unpack16(phi + (w - lo) * S + c, v);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(gl[w - lo], v[k], acc[k]);
      }
    }
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      if (c + 4 * h >= d) break;
      store4(dphi + (size_t)(base + u) * d, d, c + 4 * h,
             make_float4(acc[4 * h], acc[4 * h + 1], acc[4 * h + 2],
                         acc[4 * h + 3]),
             vec);
      if (dphin)
        store4(dphin + (size_t)(base + u) * d, d, c + 4 * h, zero, vec);
    }
  }
  finish_star(row, base, lo, hi, loss, nt, stats);
}

// The route past MAX_DIM where a row's whole rows do not fit
// (star_pos_route): star_pos_kernel for any d (K2, and K2b with BF16: the
// staged slab rows and g2 rounded as there, each score the f32 sum of the
// rounded products, its slabs' parts added in column order), its rows
// staged one column slab at a time (sgns_common.cuh: SLAB): the segments, hubs, pads and
// owned range are found as there; sweep A stages each slab of the owned
// rows and adds every (hub, leaf) pair's slab part of its score to sc[r]
// (the same 8 lanes own a leaf in every slab); g2 and the loss follow from
// the sums; sweep B re-stages each slab and writes its columns of every
// owned slot's dphi (and zeroed dphin).  Shared memory: 128 rows of SLAB
// columns, 68 KB.  Grid, outputs and PDL as star_pos_kernel.
template <bool BF16>
static __global__ void __launch_bounds__(STAR_THREADS)
star_pos_slab_kernel(const float* emb, const int* slots, const int* meta,
                     int d,
                     float* __restrict__ dphi, float* __restrict__ dphin,
                     float* __restrict__ nt, double* __restrict__ stats) {
  extern __shared__ float4 star_smem[];
  constexpr int ds = SLAB_STRIDE;
  float* phi = reinterpret_cast<float*>(star_smem);  // [BLK][ds]: a slab
  float* sc = phi + BLK * ds;                        // [BLK] leaf scores
  __shared__ StarRow row;
  __shared__ float gl[BLK];  // g2 of the leaf at lo + r
  const int* ms = row.ms;
  const int* ids = row.ids;
  const int* hub = row.hub;
  const int t = threadIdx.x;
  const int base = blockIdx.y * BLK, s0 = blockIdx.x * STAR_STRIP;
  const bool vec = d % 4 == 0;

  read_row(row, slots, meta, base);
  pdl_wait();

  // the strip's pads: zeros
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int idx = t; idx < STAR_STRIP * d; idx += STAR_THREADS) {
    const int a = s0 + idx / d;
    if (ms[a] >= 0) continue;
    const size_t o = (size_t)(base + a) * d + idx % d;
    dphi[o] = 0.0f;
    if (dphin) dphin[o] = 0.0f;
  }
  if (t < STAR_STRIP && ms[s0 + t] < 0) nt[base + s0 + t] = 0.0f;
  int lo, hi;
  if (!owned_range(row, s0, lo, hi)) return;  // no hub in the strip
  const int nr = hi - lo, lane8 = t & 7, ns = n_slabs(d);
  auto stage = [&](const Slab& sl) {
    stage_rows<STAR_THREADS, 8, float>(
        nr, sl.w, sl.wp,
        [&](int i) { return emb + (size_t)ids[lo + i] * d + sl.s0; },
        [&](int i, int c, float4 v) {
          *reinterpret_cast<float4*>(phi + i * ds + c) =
              make_float4(mxu<BF16>(v.x), mxu<BF16>(v.y), mxu<BF16>(v.z),
                          mxu<BF16>(v.w));
        },
        vec);
  };

  // sweep A: each (hub, leaf) pair's score, summed over the slabs
  for (int n = 0; n < ns; ++n) {
    const Slab sl(n, d);
    __syncthreads();  // the last slab's reads
    stage(sl);
    __syncthreads();
    for (int r0 = 0; r0 < nr; r0 += STAR_THREADS / 8) {
      const int r = r0 + (t >> 3), u = lo + r;
      const bool leaf = r < nr && ms[u] >= 0 && hub[u] != u;
      float v = 0.0f;
      if (leaf) {
        const float4* a = reinterpret_cast<const float4*>(phi + r * ds);
        const float4* b =
            reinterpret_cast<const float4*>(phi + (hub[u] - lo) * ds);
        for (int q = lane8; q < sl.wp / 4; q += 8) {
          const float4 x = a[q], y = b[q];
          v = fmaf(x.x, y.x, v);
          v = fmaf(x.y, y.y, v);
          v = fmaf(x.z, y.z, v);
          v = fmaf(x.w, y.w, v);
        }
      }
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (leaf && lane8 == 0) sc[r] = n ? sc[r] + v : v;
    }
  }
  __syncthreads();  // every leaf's sum
  // g2 = 2 g and twice the loss, from the sums
  float loss = 0.0f;
  for (int r = t; r < nr; r += STAR_THREADS) {
    const int u = lo + r;
    if (ms[u] < 0 || hub[u] == u) continue;
    gl[r] = 2.0f * mxu<BF16>(sigmoid_f(sc[r]) - 1.0f);
    loss -= 2.0f * log_sigmoid_f(sc[r]);
  }

  // sweep B: dphi of each owned slot, one slab at a time
  for (int n = 0; n < ns; ++n) {
    const Slab sl(n, d);
    __syncthreads();  // gl written; the last slab's reads
    stage(sl);
    __syncthreads();
    const int n4 = sl.wp / 4;
    for (int idx = t; idx < nr * n4; idx += STAR_THREADS) {
      const int r = idx / n4, c = 4 * (idx - r * n4), u = lo + r;
      if (ms[u] < 0) continue;  // a pad: written above
      float4 acc = zero;
      if (hub[u] != u) {
        fma4(gl[r],
             *reinterpret_cast<const float4*>(phi + (hub[u] - lo) * ds + c),
             acc);
      } else {
        for (int v = u + 1; v < hi && hub[v] == u; ++v)
          fma4(gl[v - lo],
               *reinterpret_cast<const float4*>(phi + (v - lo) * ds + c), acc);
      }
      const size_t o = (size_t)(base + u) * d + sl.s0;
      store4(dphi + o, sl.w, c, acc, vec);
      if (dphin) store4(dphin + o, sl.w, c, zero, vec);
    }
  }
  finish_star(row, base, lo, hi, loss, nt, stats);
}

// The star pass of one instance: init() (checks d, sets the route's
// kernel's shared-memory cap to what its widest plan needs: MAX_DIM's,
// POS_WIDE_SMEM or a slab's, so a plan of another width never lowers it),
// then launch() once per group of 8 rows.
namespace {  // internal linkage (sgns_common.cuh: NegativePass)

template <bool BF16>
struct StarPosPass {
  size_t smem = 0;
  int launched = -1;  // the route of the kernel launch() last launched

  static size_t smem_bytes(int d) {
    const int route = star_pos_route(d, BF16);
    return route == POS_ROWS    ? star_pos_smem_bytes(d)
           : route == POS_WHOLE ? star_pos_wide_smem_bytes(d, BF16)
                                : star_pos_slab_smem_bytes();
  }

  cudaError_t init(int d) {
    if (d < 1) return cudaErrorInvalidValue;
    smem = smem_bytes(d);
    const int route = star_pos_route(d, BF16);
    if (route == POS_WHOLE)
      return cudaFuncSetAttribute(star_pos_wide_kernel<BF16>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)POS_WIDE_SMEM);
    if (route == POS_SLAB)
      return cudaFuncSetAttribute(star_pos_slab_kernel<BF16>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    return cudaFuncSetAttribute(star_pos_kernel<BF16>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)star_pos_smem_bytes(MAX_DIM));
  }

  // Launches the pass on `stream` (with PDL when `pdl`) and notes its
  // route in `launched`; returns the launch's error.
  cudaError_t launch(const float* emb, const int* slots, const int* meta,
                     int d, float* dphi, float* dphin, float* nt,
                     double* stats, cudaStream_t stream, bool pdl = false) {
    const int route = star_pos_route(d, BF16);
    auto* kernel = route == POS_ROWS    ? star_pos_kernel<BF16>
                   : route == POS_WHOLE ? star_pos_wide_kernel<BF16>
                                        : star_pos_slab_kernel<BF16>;
    const cudaError_t e = launch_kernel(
        kernel, dim3(STAR_NSTRIP, NBLK), dim3(STAR_THREADS), smem, stream,
        pdl, 0, emb, slots, meta, d, dphi, dphin, nt, stats);
    if (e == cudaSuccess) launched = route;
    return e;
  }
};

}  // namespace

}  // namespace come
