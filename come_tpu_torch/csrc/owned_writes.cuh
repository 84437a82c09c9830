// The slot and pool writes by owned rows, shared by the walk steps
// (walk_sgns.cu: K1, K1b, K3, K4, K5) and the star steps (star_sgns.cu: K2,
// K2b).  Every .cu is its own translation unit (ops/build.py), so the
// kernels here are `static`: each unit that includes this has its own copy.
//
//   * slot_chains_kernel: once a step, each group's real slots sorted by
//     (row, slot) into the chains the slot writes follow.  A walk slot is
//     real where its position is below L; a star slot where its meta is not
//     PAD_META (the layout's pads carry node 0, sampling/stars.py, and must
//     be in no chain, or row 0 would get a chain of every pad);
//   * fold_chains_kernel: once a step, which rows a block's last group
//     writes through both its real slots and its block's pool;
//   * F32Owner, f32_owner: what a team of a warp owns in a group's f32
//     writes (a distinct row of the real slots, or of the pool's draws);
//   * f32_write: a walk owner's two rows (slot sums in f64, then the
//     pool's draws); star_write: a star owner's one row (each slot's update
//     rounded in f32 in slot order, then the pool's draws).

#pragma once

#include <climits>

#include "sgns_common.cuh"

namespace come {

// The meta of a star layout's pad slot (sampling/stars.py: PAD_META).
constexpr int PAD_META = -2;
// The sort key's id half of a slot in no chain: above every row id.
constexpr unsigned NO_ROW = 0xffffffffu;

// The slot chains, once a step.  The slot writes (K3's, the f32 walk
// ones and the star ones) apply a row's slots in slot order (below), so
// each row of a group needs its slots sorted.  A group's slots do not
// depend on the tables, so the chains of every group of a step are known
// at its head: one CTA a group sorts its slots by (id, t) in shared memory
// (a bitonic network over GROUP 64-bit keys), a slot in no chain keyed
// (NO_ROW, t) so that those sort last, and writes order[i] = the slot at
// sorted place i (-1 past the group's real slots) and info[t] = (i, n):
// t's place and, at a row's first slot, its n slots (0 at the others and
// at slots in no chain).  A slot is real where `meta` is null (a walk) and
// its position t % BLK is below L, or where meta[t] != PAD_META (a star
// layout).  A row's count comes from a binary search for the end of its
// run, so a hub that fills the group costs no serial scan.  It is the
// plain version's sort (ops/scatter_pass.py: slot_chains_reference,
// star_chains_reference).  It runs right after pool_chains_kernel under
// PDL and does all its work before its wait: it reads the slots and meta
// (the head's, or K4's generation, two or more kernels before it:
// complete) and writes its chains, which no kernel before it in the step
// touches, so its sort runs beside the pools' sort.  It waits only to
// exit.  ~1024 keys a group in 55 passes; the 128 groups of a
// synthetic-10m step sort side by side.  grid: the step's groups, block
// SLOT_CHAIN_THREADS.
constexpr int SLOT_CHAIN_THREADS = GROUP / 2;  // one compare a thread

static __global__ void __launch_bounds__(SLOT_CHAIN_THREADS)
slot_chains_kernel(const int* walks, const int* meta, int L, int* info,
                   int* order) {
  __shared__ unsigned long long keys[GROUP];
  const int t0 = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * GROUP;
  for (int s = t0; s < GROUP; s += SLOT_CHAIN_THREADS) {
    const bool real = meta == nullptr ? s % BLK < L
                                      : step_ld(meta + base + s) != PAD_META;
    const unsigned id = real ? (unsigned)step_ld(walks + base + s) : NO_ROW;
    keys[s] = (unsigned long long)id << 32 | (unsigned)s;
  }
  __syncthreads();
  for (int size = 2; size <= GROUP; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const int i = 2 * t0 - (t0 & (stride - 1)), j = i + stride;
      const unsigned long long x = keys[i], y = keys[j];
      if ((x > y) == ((i & size) == 0)) {
        keys[i] = y;
        keys[j] = x;
      }
      __syncthreads();
    }
  }
  int* inf = info + base * 2;
  int* ord = order + base;
  for (int i = t0; i < GROUP; i += SLOT_CHAIN_THREADS) {
    const unsigned id = (unsigned)(keys[i] >> 32);
    const int t = (int)(keys[i] & 0xffffffffu);
    if (id == NO_ROW) {  // the slots in no chain sort last, one each
      ord[i] = -1;
      inf[2 * t] = 0;
      inf[2 * t + 1] = 0;
      continue;
    }
    ord[i] = t;
    int cnt = 0;
    if (i == 0 || (unsigned)(keys[i - 1] >> 32) != id) {
      int lo = i + 1, hi = GROUP;  // the first place past the row's run
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((unsigned)(keys[mid] >> 32) == id)
          lo = mid + 1;
        else
          hi = mid;
      }
      cnt = lo - i;
    }
    inf[2 * t] = i;
    inf[2 * t + 1] = cnt;
  }
  pdl_wait();
  pdl_trigger();
}

// slot_chains_kernel's launch on `stream` (with PDL when `pdl`): the chains
// of G groups of slots (walks of L real positions, or with `meta` a star
// layout's) into `sc` (slot_info, slot_order).
static cudaError_t launch_slot_chains(const int* walks, const int* meta,
                                      int G, int L, int* sc,
                                      cudaStream_t stream, bool pdl) {
  return launch_kernel(slot_chains_kernel, dim3(G), dim3(SLOT_CHAIN_THREADS),
                       0, stream, pdl, 0, walks, meta, L, sc,
                       sc + (size_t)2 * G * GROUP);
}

// Where group g's info [GROUP][2] and order [GROUP] lie in slot chains `sc`
// of G groups (after the pools' chains in a plan's `chains`).
static inline const int* slot_info(const int* sc, int g) {
  return sc + (size_t)2 * g * GROUP;
}
static inline const int* slot_order(const int* sc, int g, int G) {
  return sc + (size_t)2 * G * GROUP + (size_t)g * GROUP;
}

// ------------------------------------------- the f32 slot and pool writes
//
// The walk steps' f32 slot writes (K1, K1b, K4 and K5:
// pallas_walk_sgns.py:369-400, the slot fori_loop of _walk_kernel, f32 at
// :395-397: emb_in[v] += dphi[t], emb_out[v] += dctx[t] for each real slot
// t, v = walks[t]; K5 writes dctx[t] at walks[t], where the band pass
// stores a pair's ctx gradient at the partner's slot, :374-375), the star
// steps' (K2, K2b: pallas_star_sgns.py:186-195, emb[v] = emb[v] + dphi[t]
// slot by slot on the one tied table) and, at an R-block end, the pool
// write (pallas_walk_sgns.py:405-425 and pallas_star_sgns.py:197-204
// _apply_pool: table[pool[k]] -= lr * dneg[k] for k in order).  A walk
// revisits nodes, a star layout repeats its hubs and leaves, and a pool
// draws a row many times, so each distinct row of the group gets one
// owner, a team of a warp:
//   * the team of the row's first real slot (slot_chains_kernel's info)
//     applies the row's slots in slot order (order[i], ...,
//     order[i + n - 1]).  A walk owner (f32_write) sums the terms
//     __fmul_rn(__fadd_rn(dphi[t], dphin[t]), -lr) and
//     __fmul_rn(dctx[t], -lr) in f64 and adds each sum to its row with one
//     rounding: per-term f32 adds would round each at the running sum's
//     magnitude, which on a hub's row is far larger (chip_smoke.py's hot
//     row).  A star owner (star_write) adds each slot's term to its row
//     rounded in f32, x = __fadd_rn(x, term), as the TPU's read-modify-
//     write does;
//   * at a block end the same launch has a team for each pool draw k
//     besides, and the pool's rows are written too: each row's draws in
//     draw order, y = __fadd_rn(y, __fmul_rn(dneg[k], -lr)), as the TPU's
//     loop and the plain versions apply them.  A row that is also among
//     the group's real slots belongs to its slot owner, which applies its
//     slots first, then its draws; a row drawn only by the pool belongs to
//     the team of its first draw (pool_chains_kernel's info).  Which is
//     which, fold_chains_kernel finds once a step for every block (a lookup
//     of each chain in the other's), so each team reads it with one load.
// An owner loads its rows once, holds them in registers while it applies
// its terms, and stores each once, with plain stores and no atomics, so a
// row's bits do not depend on the order in which the card runs the teams:
// the plain versions (ops/walk_sgns.py::walk_scatter_f32_reference,
// ops/scatter_pass.py::star_scatter_reference) write the same bits from
// the same updates.  A team takes a row in float4 pieces where d % 4 == 0
// (E 4: one piece a lane up to d 128, a warp striding wider rows), else one
// element a lane (E 1).  The grid is the group's real positions' teams (a
// walk's NBLK * L, a star group's GROUP), then (block end) KP draws' teams;
// a team at a slot in no chain owns nothing.  Before its wait a team reads
// its slot's or draw's place and count, its row, the first batches of its
// chain and its fold chains (the chains, slots and pools are two or more
// kernels before it: complete) and lr; after it, its rows and the update
// pieces, a batch of SCATTER_F32_U slots' loads in flight at once and the
// next batch's issued before this one's adds, so a hub's long chain keeps
// its loads ahead of its dependent adds.  It is bound by latency, not
// bytes: it reads the real slots' update rows (KP dneg rows at a block
// end) and moves the distinct rows in and out (K1 at d 128: 0.67 us a
// group at 3.35 TB/s).  lr from the argument block `args`, or, without one
// (the C entry that runs a kernel alone), from `lr_in`.
constexpr int SCATTER_F32_THREADS = 128;  // four teams of a warp
// Slots a batch: 2 (112-134 registers a thread at E 4) read 0.7-1.4 us
// less a block end of K1, K1b and K5 than 4 (188-206), whose CTAs fit
// fewer beside the pass before them; 1 no better (PERF.md §6).
constexpr int SCATTER_F32_U = 2;

// Elements j..j+E-1 of an f32 row, and back (E 4: one 16-byte access).
template <int E>
static __device__ __forceinline__ void load_f32(const float* p,
                                                float (&x)[E]) {
  if constexpr (E == 4) {
    const float4 v = step_ld(reinterpret_cast<const float4*>(p));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    x[0] = step_ld(p);
  }
}

template <int E>
static __device__ __forceinline__ void store_f32(float* p,
                                                 const float (&x)[E]) {
  if constexpr (E == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    p[0] = x[0];
}

// A batch's loads: elements j..j+E-1 of dphi, dphin and (CTX: a walk's)
// dctx (a, b, c) of slots cs[0..U) (-1: none), all in flight together.
template <int E, int U = SCATTER_F32_U, bool CTX = true>
struct F32Batch {
  int cs[U];
  float a[U][E], b[U][E], c[U][CTX ? E : 1];

  __device__ __forceinline__ void load(const float* dphi, const float* dphin,
                                       const float* dctx, int d, int j) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (cs[i] < 0) continue;
      const size_t o = (size_t)cs[i] * d + j;
      load_f32<E>(dphi + o, a[i]);
      load_f32<E>(dphin + o, b[i]);
      if constexpr (CTX) load_f32<E>(dctx + o, c[i]);
    }
  }

  // The batch's terms added, in slot order, to the f64 sums x (node row)
  // and y (ctx row): a walk owner's.
  __device__ __forceinline__ void add(double (&x)[E], double (&y)[E],
                                      float lr) const {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (cs[i] < 0) break;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x[e] += (double)__fmul_rn(__fadd_rn(a[i][e], b[i][e]), -lr);
        y[e] += (double)__fmul_rn(c[i][e], -lr);
      }
    }
  }

  // The batch's terms added, in slot order, to the row x, each rounded in
  // f32: a star owner's.
  __device__ __forceinline__ void rmw(float (&x)[E], float lr) const {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (cs[i] < 0) break;
#pragma unroll
      for (int e = 0; e < E; ++e)
        x[e] = __fadd_rn(x[e], __fmul_rn(__fadd_rn(a[i][e], b[i][e]), -lr));
    }
  }
};

// The first place p of the n ascending ids (shared memory) that holds v,
// or -1.
static __device__ __forceinline__ int find_id(const int* ids, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && ids[lo] == v ? lo : -1;
}

// The fold chains, once a step: which rows of a block's pool the block's
// last group also writes through its real slots.  One CTA a block b (its
// last group g = min(b R + R - 1, G - 1)) stages the pool's ids in chain
// order (pool[porder[j]], ascending) and the group's real slots' ids in
// chain order (walks[order[i]], ascending; INT_MAX past the real slots) in
// shared memory and writes fold_slot[g][t] = the place in the pool's chain
// of the first draw of real slot t's row, or -1 where the pool does not
// draw it (-1 at slots in no chain: a walk's positions from L, a star
// layout's pads, meta PAD_META), and fold_draw[b][k] = 1 where draw k's
// row is among the group's real slots, else 0.  So the block-end scatters'
// teams look their ownership up instead of searching the other chain
// before their wait, which the negative pass before them leaves on the
// critical path (its CTAs fill the card).  It is the plain version's
// lookup (ops/scatter_pass.py::fold_chains_reference).  PDL: launched right
// after slot_chains_kernel; the pools and their chains (two or more kernels
// before it: complete) before its wait, the slot chains after it.  grid:
// the step's blocks, block FOLD_THREADS, dynamic shared memory
// fold_chain_smem(KP).
constexpr int FOLD_THREADS = 512;

static inline size_t fold_chain_smem(int KP) {
  return sizeof(int) * (size_t)(KP + GROUP);
}

static __global__ void __launch_bounds__(FOLD_THREADS)
fold_chains_kernel(const int* walks, const int* meta, const int* order,
                   const int* pools, const int* porder, int L, int KP, int G,
                   int R, int* fold_slot, int* fold_draw) {
  extern __shared__ int fold_ids[];
  int* pids = fold_ids;       // [KP] the pool's ids in chain order
  int* sids = fold_ids + KP;  // [GROUP] the real slots' ids likewise
  const int b = blockIdx.x, g = min(b * R + R - 1, G - 1);
  const int* pool = pools + (size_t)b * KP;
  const int* po = porder + (size_t)b * KP;
  const int* ord = order + (size_t)g * GROUP;
  const int* wg = walks + (size_t)g * GROUP;
  for (int j = threadIdx.x; j < KP; j += FOLD_THREADS)
    pids[j] = step_ld(pool + step_ld(po + j));
  pdl_wait();
  for (int i = threadIdx.x; i < GROUP; i += FOLD_THREADS) {
    const int t = step_ld(ord + i);
    sids[i] = t >= 0 ? step_ld(wg + t) : INT_MAX;
  }
  __syncthreads();
  int* fs = fold_slot + (size_t)g * GROUP;
  for (int i = threadIdx.x; i < GROUP; i += FOLD_THREADS) {
    const int t = step_ld(ord + i);
    if (t >= 0) fs[t] = find_id(pids, KP, sids[i]);
  }
  for (int t = threadIdx.x; t < GROUP; t += FOLD_THREADS)
    if (meta == nullptr ? t % BLK >= L
                        : step_ld(meta + (size_t)g * GROUP + t) == PAD_META)
      fs[t] = -1;
  int* fd = fold_draw + (size_t)b * KP;
  for (int j = threadIdx.x; j < KP; j += FOLD_THREADS)
    fd[step_ld(po + j)] = find_id(sids, GROUP, pids[j]) >= 0;
  pdl_trigger();
}

// fold_chains_kernel's launch on `stream` (with PDL when `pdl`): the fold
// chains of the blocks of a step of G groups, R a block, into `fold`
// (fold_slot [G][GROUP], then fold_draw [ceil(G / R)][KP]), from its slots
// (walks of L real positions, or with `meta` a star layout), its pools
// [ceil(G / R)][KP], their chains `pc` and the slot chains `sc`.
static cudaError_t launch_fold_chains(const int* walks, const int* meta,
                                      const int* sc, const int* pools,
                                      const int* pc, int G, int L, int KP,
                                      int R, int* fold, cudaStream_t stream,
                                      bool pdl) {
  const int n_pools = (G + R - 1) / R;
  return launch_kernel(fold_chains_kernel, dim3(n_pools), dim3(FOLD_THREADS),
                       fold_chain_smem(KP), stream, pdl, 0, walks, meta,
                       slot_order(sc, 0, G), pools,
                       pool_chain_order(pc, 0, n_pools, KP), L, KP, G, R,
                       fold, fold + (size_t)G * GROUP);
}

// pool_chains_kernel's and fold_chains_kernel's shared-memory caps, for
// pools of KP ids (KP past POOL_CHAIN_MAX is refused).
static cudaError_t fold_setup(int KP) {
  const cudaError_t e = chains_setup(KP);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fold_chains_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)fold_chain_smem(POOL_CHAIN_MAX));
}

// What a team owns, found before its wait: the row v, its n slots
// (chain ch, the first 2 U of them in `first`) and its pn pool draws
// (chain pch, the first APPLY_U in `pfirst`); n and pn 0 where it owns
// nothing.
template <int U = SCATTER_F32_U>
struct F32Owner {
  int v = 0, n = 0, pn = 0;
  const int* ch = nullptr;
  const int* pch = nullptr;
  int first[2 * U];
  int pfirst[APPLY_U];
};

// Team i's ownership in group `walks`' scatter (slot chains info, order of
// L real positions a walk; a star group's teams take L = BLK, one a slot,
// and its pads own nothing: info gives them no slots); with FOLD, the pool
// `pool` of KP draws too (its chains pinfo, porder, and the group's fold
// chains fold_slot, fold_draw): teams past the real positions' take the
// draws.
template <bool FOLD, int U = SCATTER_F32_U>
static __device__ __forceinline__ F32Owner<U> f32_owner(
    int i, const int* walks, const int* info, const int* order, int L,
    const int* pool, const int* pinfo, const int* porder, int KP,
    const int* fold_slot, const int* fold_draw) {
  F32Owner<U> o;
  const int n_real = NBLK * L;
  if (i < n_real) {
    const int t = i / L * BLK + i % L;
    const int2 in = step_ld(reinterpret_cast<const int2*>(info) + t);
    if (in.y > 0) {  // else an earlier slot of the row owns it
      o.v = step_ld(walks + t), o.n = in.y, o.ch = order + in.x;
#pragma unroll
      for (int u = 0; u < 2 * U; ++u)
        o.first[u] = u == 0 ? t : u < in.y ? step_ld(order + in.x + u) : -1;
      const int at = FOLD ? step_ld(fold_slot + t) : -1;
      if (at >= 0) {  // the pool draws the row: its draws too
        const int k0 = step_ld(porder + at);
        o.pn = step_ld(reinterpret_cast<const int2*>(pinfo) + k0).y;
        o.pch = porder + at;
      }
    }
  } else if (FOLD && i < n_real + KP) {
    const int k = i - n_real;
    const int2 in = step_ld(reinterpret_cast<const int2*>(pinfo) + k);
    // else an earlier draw of the row owns it, or its slot owner does
    if (in.y > 0 && !step_ld(fold_draw + k))
      o.v = step_ld(pool + k), o.pn = in.y, o.pch = porder + in.x;
  }
#pragma unroll
  for (int u = 0; u < APPLY_U; ++u)
    o.pfirst[u] = u < o.pn ? step_ld(o.pch + u) : -1;
  return o;
}

// An owner's pool draws in draw order on elements j..j+E-1 of its row y,
// APPLY_U loads in flight: y = __fadd_rn(y, __fmul_rn(dneg[k], -lr)).
template <int E, int U = SCATTER_F32_U>
static __device__ __forceinline__ void f32_draws(const F32Owner<U>& o,
                                                 const float* dneg, int d,
                                                 int j, float lr,
                                                 float (&y)[E]) {
  int cs[APPLY_U];
#pragma unroll
  for (int i = 0; i < APPLY_U; ++i) cs[i] = o.pfirst[i];
  for (int i0 = 0; i0 < o.pn; i0 += APPLY_U) {
    if (i0 > 0) {
#pragma unroll
      for (int i = 0; i < APPLY_U; ++i)
        cs[i] = i0 + i < o.pn ? step_ld(o.pch + i0 + i) : -1;
    }
    float u[APPLY_U][E];
#pragma unroll
    for (int i = 0; i < APPLY_U; ++i)
      if (cs[i] >= 0) load_f32<E>(dneg + (size_t)cs[i] * d + j, u[i]);
#pragma unroll
    for (int i = 0; i < APPLY_U; ++i) {
      if (cs[i] < 0) break;
#pragma unroll
      for (int e = 0; e < E; ++e)
        y[e] = __fadd_rn(y[e], __fmul_rn(u[i][e], -lr));
    }
  }
}

// A walk owner's rows, after the wait: its pieces p = lane, lane + 32, ...
// of E elements; the node and ctx rows through its slots (each batch of U
// slots added once the next batch's loads and the slot numbers of the one
// after it are in flight), then the ctx row through its draws in order.
template <int E, int U = SCATTER_F32_U>
static __device__ __forceinline__ void f32_write(
    const F32Owner<U>& o, float* emb_in, float* emb_out, const float* dphi,
    const float* dphin, const float* dctx, const float* dneg, int d,
    float lr) {
  float* row_in = emb_in + (size_t)o.v * d;
  float* row_out = emb_out + (size_t)o.v * d;
  for (int p = threadIdx.x & 31; p * E < d; p += 32) {
    const int j = p * E;
    float y[E];
    load_f32<E>(row_out + j, y);
    if (o.n > 0) {
      F32Batch<E> cur, next;
#pragma unroll
      for (int i = 0; i < U; ++i)
        cur.cs[i] = o.first[i], next.cs[i] = o.first[U + i];
      cur.load(dphi, dphin, dctx, d, j);
      float x[E];
      load_f32<E>(row_in + j, x);
      double sx[E], sy[E];
#pragma unroll
      for (int e = 0; e < E; ++e) sx[e] = sy[e] = 0.0;
      for (int i0 = 0; i0 < o.n; i0 += U) {
        if (next.cs[0] >= 0) next.load(dphi, dphin, dctx, d, j);
        int after[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int k = i0 + 2 * U + i;
          after[i] = k < o.n ? step_ld(o.ch + k) : -1;
        }
        cur.add(sx, sy, lr);
        cur = next;
#pragma unroll
        for (int i = 0; i < U; ++i) next.cs[i] = after[i];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x[e] = (float)((double)x[e] + sx[e]);
        y[e] = (float)((double)y[e] + sy[e]);
      }
      store_f32<E>(row_in + j, x);
    }
    f32_draws<E>(o, dneg, d, j, lr, y);
    store_f32<E>(row_out + j, y);
  }
}

// A star owner's row of the tied table `emb`, after the wait: its pieces
// p = lane, lane + 32, ... of E elements through its slots in slot order,
// x = __fadd_rn(x, __fmul_rn(__fadd_rn(dphi[t], dphin[t]), -lr)) (each
// batch of U slots applied once the next batch's loads and the slot
// numbers of the one after it are in flight), then through its draws in
// draw order.
template <int E, int U = SCATTER_F32_U>
static __device__ __forceinline__ void star_write(const F32Owner<U>& o,
                                                  float* emb,
                                                  const float* dphi,
                                                  const float* dphin,
                                                  const float* dneg, int d,
                                                  float lr) {
  float* row = emb + (size_t)o.v * d;
  for (int p = threadIdx.x & 31; p * E < d; p += 32) {
    const int j = p * E;
    float x[E];
    if (o.n > 0) {
      F32Batch<E, U, false> cur, next;
#pragma unroll
      for (int i = 0; i < U; ++i)
        cur.cs[i] = o.first[i], next.cs[i] = o.first[U + i];
      cur.load(dphi, dphin, nullptr, d, j);
      load_f32<E>(row + j, x);
      for (int i0 = 0; i0 < o.n; i0 += U) {
        if (next.cs[0] >= 0) next.load(dphi, dphin, nullptr, d, j);
        int after[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int k = i0 + 2 * U + i;
          after[i] = k < o.n ? step_ld(o.ch + k) : -1;
        }
        cur.rmw(x, lr);
        cur = next;
#pragma unroll
        for (int i = 0; i < U; ++i) next.cs[i] = after[i];
      }
    } else {
      load_f32<E>(row + j, x);
    }
    f32_draws<E>(o, dneg, d, j, lr, x);
    store_f32<E>(row + j, x);
  }
}

}  // namespace come
