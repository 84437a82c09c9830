// Walk-banded SGNS macro step (O1, and O2 in paired mode) for Hopper.
//
// Replaces the Pallas kernel come_tpu/ops/pallas_walk_sgns.py::_walk_kernel
// as called by fused_walk_sgns_step and fused_walk_sgns_gen_step, in the
// modes the TPU kernel has:
//   * K1   the banded skip-gram step (walks given);
//   * K1b  K1 with mxu_bf16=True: every product operand rounded to bf16
//          (phi_m, ctx_blk_m, g_blk_m at :266, :311, :333, and the
//          negative pass's, sgns_common.cuh), f32 sums;
//   * K5   paired=True (:290-303): slots 2i, 2i+1 are one edge and each
//          slot's only context is its partner t^1, n_t = 1.  The TPU's
//          paired positive pass is elementwise f32 even with mxu_bf16, so
//          PAIRED rounds only in the negative pass;
//   * K4   GEN_WALKS (:157-208): the walks are generated from the CSR and
//          an input bit matrix, then the group loop runs on them;
//   * K3   TABLES_BF16/SR (:60-88, :129, :219-253, :377-419, :531-553):
//          bf16 [V, d] tables.  Rows are widened exactly to f32 where they
//          are read; the arithmetic is K1b's (mxu_t is bf16 whenever the
//          tables are, :129), so the phi/ctx/pool roundings are no-ops and
//          g is rounded as in K1b.  Each real slot writes its row once:
//          new = f32(old) + (-lr * d), written as (bits(new) + r) >> 16,
//          r the low 16 bits of the slot's draw for the node table and the
//          high 16 for the ctx table (SR), or r = 0 (truncation, the TPU's
//          interpret path).  The pool's write at the block end is rounded
//          the same way.  Duplicate rows in a group take one rounded RMW
//          per occurrence in slot order, as the TPU's sequential slot loop
//          does: one owner a row applies them (walk_scatter_bf16_kernel, on
//          the chains slot_chains_kernel sorts once a step), no atomics.
//          The draws are a counter hash (sgns_common.cuh: mix32), not the
//          TPU's PRNG, so the plain version rounds alike.  The TPU's u32
//          row-pair packing exists only for VMEM indexing and is not
//          ported.
// Semantics are the TPU kernel's, group by group in order: for each group
// of 8 walks (1024 slots, walk j at slots j*128 .. j*128+L-1) the rows are
// read from the tables as the previous group left them, and
//   * at an R-block start the pool rows are staged and dneg is zeroed;
//   * centre t trains contexts u of its own walk with 0 < |u-t| <= wrow[t]
//     (u, t < L): g = sigmoid(phi_t . ctx_u) - 1, dphi_t += g ctx_u,
//     dctx_u += g phi_t, n_t = number of such u;
//   * every slot scores the staged pool with weight negw * n_t
//     (sgns_common.cuh: NegativePass);
//   * each slot adds -lr*dphi to node_emb[v] and -lr*dctx to ctx_emb[v];
//     one owner a row sums the row's slots in f64 in slot order and adds
//     the sum once (walk_scatter_kernel), which rounds no worse than the
//     TPU's sequential read-modify-writes;
//   * at an R-block end the pool gradient is applied, a row's draws in
//     draw order by one owner, in the block end's scatter launch
//     (block_end_scatter_kernel; K3: apply_pool_bf16_kernel).
// The window draws come in as `wrow` (the TPU drew them in-kernel), so the
// kernel, its plain PyTorch version and the numpy oracle see the same ones.
//
// What bounds it on the H100: the negative pass (3 x 128 x KP x d
// multiply-adds per walk, sgns_common.cuh) is compute; the gathers and the
// scatter are row traffic (halved by K3's bf16 rows); walk generation is 79
// dependent CSR loads per walk.  The positive band, which the TPU computes
// as dense masked [S, CB] tiles on its MXU (pallas_walk_sgns.py:305-341),
// is small work (about 1024 x 2W x 3 x d multiply-adds a group, 8 M at d
// 128, W 10), so what bounds it is latency: a group's band is spread over
// the card and no chain of dependent dot products is long.  Each walk is
// cut into strips of STRIP = 8 centres, one CTA each (128 CTAs a group),
// which stages only its rows and a halo of W rows each side (about 30 KB at
// d 128, W 10, so several CTAs share an SM), scores the pairs of its band
// in parallel (8 lanes per pair), recomputes the g of the halo centres
// whose window reaches its slots instead of exchanging them, and writes its
// slots' dphi and dctx itself, without atomics.  The staged range never
// passes the walk (at most 128 rows: 217 KB at d 192), so no window is cut.
// Past d 192 the band pass holds the strip's whole rows for the pass where
// they fit (walk_pos_wide_kernel: one sweep, rows by asynchronous copies,
// bf16 rows in the rounding modes; W 10 at d 256 and any bf16 strip there),
// and stages them one column slab of 128 at a time where they do not
// (walk_pos_slab_kernel; sgns_common.cuh: SLAB, POS_WIDE_SMEM); the
// negative pass is its wide kernel (sgns_common.cuh: NEG_WHOLE).
// The negative pass runs on the tensor cores in the bf16 modes
// (sgns_common.cuh).  Groups keep their order with stream-ordered launches;
// the host makes one call per macro step and the loop over groups runs
// here, recorded once as a CUDA graph that the card replays
// (step_graph.cuh), behind a head kernel that copies the call's walks,
// window draws and pools (K4: starts and draws) into the plan's buffers,
// each kernel after the first two under programmatic dependent launch.  The
// walks do not depend on the tables, so one launch generates every group's
// walks (one thread per walk) before the group loop, which is what the
// TPU's per-group generation computes.

#include <type_traits>

#include "sgns_common.cuh"
#include "owned_writes.cuh"
#include "step_graph.cuh"

namespace come {

constexpr int STRIP = 8;              // centres per band CTA
constexpr int NSTRIP = BLK / STRIP;   // band CTAs per walk

// Rows a strip stages: its centres and W more on each side, inside the walk.
static __host__ __device__ inline int walk_pos_rows(int L, int W) {
  return min(L, STRIP + 2 * W);
}

// Staged rows hold d rounded up to a float4, + 4 floats of stride.
static __host__ __device__ inline int walk_pos_stride(int d) {
  return ((d + 3) & ~3) + 4;
}

static inline size_t walk_pos_smem_bytes(int d, int L, int W) {
  const size_t R = walk_pos_rows(L, W);
  return sizeof(float) * (2 * R * walk_pos_stride(d) + 2 * STRIP * R) +
         sizeof(int) * (2 * R + 2 * STRIP * R);
}

// The band passes' common steps (walk_pos_kernel, walk_pos_wide_kernel,
// walk_pos_slab_kernel).

// A strip past L: exact zeros for its slots' dphi, dctx, dphin and nt,
// written after the wait.
static __device__ __forceinline__ void zero_strip(int base, int t0, int d,
                                                  float* dphi, float* dctx,
                                                  float* dphin, float* nt) {
  pdl_wait();
  for (int idx = threadIdx.x; idx < STRIP * d; idx += THREADS) {
    const size_t o = (size_t)(base + t0) * d + idx;
    dphi[o] = 0.0f;
    dctx[o] = 0.0f;
    dphin[o] = 0.0f;
  }
  if (threadIdx.x < STRIP) nt[base + t0 + threadIdx.x] = 0.0f;
  pdl_trigger();
}

// The pairs a strip of centres [t0, t1) scores among its R staged rows
// from lo, as r_t << 16 | r_u into plist: (centre in the strip, any staged
// u), then (staged centre outside the strip, u in the strip), each with u
// in t's window wr[r_t] (PAIRED: u = t ^ 1); a warp appends its pairs with
// one shared atomic to *npairs (0 before the call).  All threads call.
template <bool PAIRED>
static __device__ __forceinline__ void list_pairs(int t0, int t1, int lo,
                                                  int R, const int* wr,
                                                  int* plist, int* npairs) {
  const int lane = threadIdx.x & 31, no = t1 - t0;
  for (int c0 = 0; c0 < 2 * no * R; c0 += THREADS) {
    const int c = c0 + threadIdx.x;
    int rt = 0, ru = 0;
    bool ok = false;
    if (c < no * R) {
      rt = t0 - lo + c / R;
      ru = c % R;
      ok = true;
    } else if (c < 2 * no * R) {
      rt = (c - no * R) / no;
      ru = t0 - lo + (c - no * R) % no;
      ok = lo + rt < t0 || lo + rt >= t1;  // own centres are counted above
    }
    const int t = lo + rt, u = lo + ru;
    ok = ok && (PAIRED ? u == (t ^ 1) : (u != t && abs(u - t) <= wr[rt]));
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(npairs, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (ok) plist[at + __popc(m & ((1u << lane) - 1))] = rt << 16 | ru;
  }
}

// n_t of the strip's centres (the contexts in t's window inside the walk;
// PAIRED: its partner) into nt, then the trigger, and the strip's loss and
// pair count added to stats.  All threads call.
template <bool PAIRED>
static __device__ __forceinline__ void finish_strip(int base, int t0, int t1,
                                                    int lo, int L,
                                                    const int* wr, float loss,
                                                    float* nt,
                                                    double* stats) {
  float pairs = 0.0f;
  if (threadIdx.x < STRIP) {
    const int t = t0 + threadIdx.x;
    if (t < t1) {
      const int w = wr[t - lo];
      pairs = PAIRED ? 1.0f : (float)(min(L - 1, t + w) - max(0, t - w));
    }
    nt[base + t] = pairs;
  }
  pdl_trigger();
  block_add(loss, &stats[0]);
  block_add(pairs, &stats[1]);
}

// Positive band of one strip of STRIP centres [t0, t0 + STRIP) of one walk.
// grid (NSTRIP, walks), block THREADS.  Writes (overwrites) dphi, dctx and
// nt for the strip's slots (strips past L write zeros), zeroes their rows of
// dphin (which the negative pass then adds to), and adds the
// positive loss and the pair count of its centres to stats.  The strip
// stages the rows [lo, hi) = [t0 - W, t0 + STRIP + W) inside the walk and
// scores every pair (t, u) of them with t or u in the strip: those with t
// in the strip give its dphi and loss, those with u in it its dctx (g of
// the halo centres is recomputed here, by the same arithmetic as in their
// own strip); n_t is the size of t's window inside the walk.  The rows are
// gathered with many loads in flight per thread and the pairs listed by
// warp ballots; a group of 8 lanes scores one pair.  Each thread then owns
// 4 elements of one slot's dphi and dctx, the strip's rows of
// [STRIP x R] . [R x d] products.  BF16 rounds the staged rows and each g
// (not with PAIRED: the TPU's paired pass is f32); PAIRED trains only
// u = t^1 (W must be 1, wrow is not read).  T is the tables' element type.
// PDL (sgns_common.cuh): the strip's walk rows and window draws are read
// before the wait; the table rows (the last scatter's and pool apply's) and
// the writes of dphi, dctx, dphin and nt (rows the last scatter reads)
// after.  A strip of padding slots waits before its zeros.
template <bool BF16, bool PAIRED, typename T>
static __global__ void __launch_bounds__(THREADS)
walk_pos_kernel(const T* emb_in, const T* emb_out, const int* walks,
                const int* wrow,
                int d, int L, int W, float* __restrict__ dphi,
                float* __restrict__ dctx, float* __restrict__ dphin,
                float* __restrict__ nt, double* __restrict__ stats) {
  constexpr bool RND = BF16 && !PAIRED;
  const int t0 = blockIdx.x * STRIP, base = blockIdx.y * BLK;
  if (t0 >= L) {  // padding slots: exact zeros, no pairs
    zero_strip(base, t0, d, dphi, dctx, dphin, nt);
    return;
  }
  const int t1 = min(t0 + STRIP, L);  // the strip's centres: [t0, t1)
  const int lo = max(0, t0 - W), hi = min(L, t1 + W), R = hi - lo;
  const int RM = walk_pos_rows(L, W), ds = walk_pos_stride(d), dp = ds - 4;
  extern __shared__ float4 pos_smem[];
  float* phi = reinterpret_cast<float*>(pos_smem);  // [RM][ds]: row lo + r
  float* ctx = phi + RM * ds;                       // [RM][ds]
  float* ga = ctx + RM * ds;        // [STRIP][RM]: g[t0 + a, lo + r]
  float* gb = ga + STRIP * RM;      // [RM][STRIP]: g[lo + r, t0 + a]
  int* wr = reinterpret_cast<int*>(gb + RM * STRIP);  // [RM] window draws
  int* rows = wr + RM;              // [RM] table rows
  int* plist = rows + RM;           // [2 * STRIP * RM] pairs r_t << 16 | r_u
  __shared__ int npairs;

  for (int r = threadIdx.x; r < R; r += THREADS) {
    rows[r] = step_ld(walks + base + lo + r);
    wr[r] = PAIRED ? 1 : min(step_ld(wrow + base + lo + r), W);
  }
  for (int idx = threadIdx.x; idx < 2 * STRIP * RM; idx += THREADS)
    ga[idx] = 0.0f;  // ga and gb
  if (threadIdx.x == 0) npairs = 0;
  __syncthreads();
  pdl_wait();
  // rows 0..R-1 of emb_in into phi, then the same rows of emb_out into ctx
  // (ctx follows phi in shared memory)
  stage_rows<THREADS, 8, T>(
      2 * R, d, dp,
      [&](int i) {
        return i < R ? emb_in + (size_t)rows[i] * d
                     : emb_out + (size_t)rows[i - R] * d;
      },
      [&](int i, int c, float4 v) {
        *reinterpret_cast<float4*>(phi + (i < R ? i : RM + i - R) * ds + c) =
            make_float4(mxu<RND>(v.x), mxu<RND>(v.y), mxu<RND>(v.z),
                        mxu<RND>(v.w));
      });

  list_pairs<PAIRED>(t0, t1, lo, R, wr, plist, &npairs);
  __syncthreads();

  const int np = npairs, lane8 = threadIdx.x & 7;
  float loss = 0.0f;
  for (int p0 = 0; p0 < np; p0 += THREADS / 8) {
    const int p = p0 + (threadIdx.x >> 3);
    const int pr = p < np ? plist[p] : 0;
    const int rt = pr >> 16, ru = pr & 0xffff;
    const float4* a = reinterpret_cast<const float4*>(phi + rt * ds);
    const float4* b = reinterpret_cast<const float4*>(ctx + ru * ds);
    float s = 0.0f;
    for (int q = lane8; q < dp / 4; q += 8) {
      const float4 x = a[q], y = b[q];
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
      s = fmaf(x.z, y.z, s);
      s = fmaf(x.w, y.w, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (p < np && lane8 == 0) {
      const float g = mxu<RND>(sigmoid_f(s) - 1.0f);
      const int t = lo + rt, u = lo + ru;
      if (t >= t0 && t < t1) {
        ga[(t - t0) * RM + ru] = g;
        loss -= log_sigmoid_f(s);
      }
      if (u >= t0 && u < t1) gb[rt * STRIP + (u - t0)] = g;
    }
  }
  __syncthreads();

  // dphi[t] = sum_u g[t, u] ctx[u], dctx[u] = sum_t g[t, u] phi[t] over
  // the band (g is zero outside each centre's window), 4 elements a thread
  for (int idx = threadIdx.x; idx < STRIP * (dp / 4); idx += THREADS) {
    const int a = idx / (dp / 4), c = 4 * (idx - a * (dp / 4)), t = t0 + a;
    float4 gp = make_float4(0.0f, 0.0f, 0.0f, 0.0f), gc = gp;
    if (t < t1) {
      const int r1 = min(hi, t + W + 1) - lo;
      for (int r = max(lo, t - W) - lo; r < r1; ++r) {
        const float4* cr = reinterpret_cast<const float4*>(ctx + r * ds + c);
        const float4* pr = reinterpret_cast<const float4*>(phi + r * ds + c);
        fma4(ga[a * RM + r], *cr, gp);
        fma4(gb[r * STRIP + a], *pr, gc);
      }
    }
    store4(dphi + (size_t)(base + t) * d, d, c, gp);
    store4(dctx + (size_t)(base + t) * d, d, c, gc);
    store4(dphin + (size_t)(base + t) * d, d, c,
           make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  }
  finish_strip<PAIRED>(base, t0, t1, lo, L, wr, loss, nt, stats);
}

static inline size_t walk_pos_slab_smem_bytes(int L, int W) {
  const size_t R = walk_pos_rows(L, W);
  return sizeof(float) * (2 * R * SLAB_STRIDE + 2 * STRIP * R +
                          2 * STRIP * R) +
         sizeof(int) * (2 * R + 2 * STRIP * R);
}

// walk_pos_kernel for any d, in every mode, its rows staged one column
// slab at a time (sgns_common.cuh: SLAB): the route past MAX_DIM where the
// strip's whole rows do not fit (walk_pos_route).  The pairs are listed as there;
// sweep A stages each slab of the strip's rows and adds every pair's slab
// part of its score to sc (the same 8 lanes own a pair in every slab, so
// no two threads write one sum); g and the loss follow from the sums; sweep
// B re-stages each slab and writes its columns of the strip's dphi, dctx
// and zeroed dphin.  Shared memory holds 2 R rows of SLAB columns (at most
// 128 rows: 135 KB for a whole walk, 30 KB at W 10), so a window is never
// cut.  BF16 rounds the staged slab rows and each g as walk_pos_kernel
// does (not with PAIRED); the scores are the f32 sums of the rounded
// products, the slabs' parts added in column order; T is the tables'
// element type (bf16 rows widened exactly by to_f32).  Grid, outputs and
// PDL as walk_pos_kernel.
template <bool BF16, bool PAIRED, typename T>
static __global__ void __launch_bounds__(THREADS)
walk_pos_slab_kernel(const T* emb_in, const T* emb_out, const int* walks,
                     const int* wrow, int d, int L, int W,
                     float* __restrict__ dphi, float* __restrict__ dctx,
                     float* __restrict__ dphin, float* __restrict__ nt,
                     double* __restrict__ stats) {
  constexpr bool RND = BF16 && !PAIRED;
  const int t0 = blockIdx.x * STRIP, base = blockIdx.y * BLK;
  if (t0 >= L) {  // padding slots: exact zeros, no pairs
    zero_strip(base, t0, d, dphi, dctx, dphin, nt);
    return;
  }
  const int t1 = min(t0 + STRIP, L);  // the strip's centres: [t0, t1)
  const int lo = max(0, t0 - W), hi = min(L, t1 + W), R = hi - lo;
  const int RM = walk_pos_rows(L, W);
  constexpr int ds = SLAB_STRIDE;
  const bool vec = d % 4 == 0;
  extern __shared__ float4 pos_smem[];
  float* phi = reinterpret_cast<float*>(pos_smem);  // [RM][ds]: a slab
  float* ctx = phi + RM * ds;                       // [RM][ds]
  float* ga = ctx + RM * ds;        // [STRIP][RM]: g[t0 + a, lo + r]
  float* gb = ga + STRIP * RM;      // [RM][STRIP]: g[lo + r, t0 + a]
  float* sc = gb + RM * STRIP;      // [2 * STRIP * RM] each pair's score
  int* wr = reinterpret_cast<int*>(sc + 2 * STRIP * RM);  // [RM] draws
  int* rows = wr + RM;              // [RM] table rows
  int* plist = rows + RM;           // [2 * STRIP * RM] pairs r_t << 16 | r_u
  __shared__ int npairs;

  for (int r = threadIdx.x; r < R; r += THREADS) {
    rows[r] = step_ld(walks + base + lo + r);
    wr[r] = PAIRED ? 1 : min(step_ld(wrow + base + lo + r), W);
  }
  for (int idx = threadIdx.x; idx < 2 * STRIP * RM; idx += THREADS)
    ga[idx] = 0.0f;  // ga and gb
  if (threadIdx.x == 0) npairs = 0;
  __syncthreads();
  pdl_wait();

  list_pairs<PAIRED>(t0, t1, lo, R, wr, plist, &npairs);
  __syncthreads();
  const int np = npairs, lane8 = threadIdx.x & 7, ns = n_slabs(d);
  auto stage = [&](const Slab& sl) {
    // rows 0..R-1 of emb_in into phi, then the same rows of emb_out into
    // ctx, columns s0 .. s0 + w - 1
    stage_rows<THREADS, 8, T>(
        2 * R, sl.w, sl.wp,
        [&](int i) {
          return (i < R ? emb_in + (size_t)rows[i] * d
                        : emb_out + (size_t)rows[i - R] * d) + sl.s0;
        },
        [&](int i, int c, float4 v) {
          *reinterpret_cast<float4*>(phi + (i < R ? i : RM + i - R) * ds + c) =
              make_float4(mxu<RND>(v.x), mxu<RND>(v.y), mxu<RND>(v.z),
                          mxu<RND>(v.w));
        },
        vec);
  };

  // sweep A: each pair's score, summed over the slabs (8 lanes a pair)
  for (int n = 0; n < ns; ++n) {
    const Slab sl(n, d);
    __syncthreads();  // the last slab's reads
    stage(sl);
    __syncthreads();
    for (int p0 = 0; p0 < np; p0 += THREADS / 8) {
      const int p = p0 + (threadIdx.x >> 3);
      const int pr = p < np ? plist[p] : 0;
      const int rt = pr >> 16, ru = pr & 0xffff;
      const float4* a = reinterpret_cast<const float4*>(phi + rt * ds);
      const float4* b = reinterpret_cast<const float4*>(ctx + ru * ds);
      float v = 0.0f;
      for (int q = lane8; q < sl.wp / 4; q += 8) {
        const float4 x = a[q], y = b[q];
        v = fmaf(x.x, y.x, v);
        v = fmaf(x.y, y.y, v);
        v = fmaf(x.z, y.z, v);
        v = fmaf(x.w, y.w, v);
      }
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (p < np && lane8 == 0) sc[p] = n ? sc[p] + v : v;
    }
  }
  __syncthreads();  // every pair's sum
  // g and the loss from the sums
  float loss = 0.0f;
  for (int p = threadIdx.x; p < np; p += THREADS) {
    const int pr = plist[p], rt = pr >> 16, ru = pr & 0xffff;
    const float x = sc[p], g = mxu<RND>(sigmoid_f(x) - 1.0f);
    const int t = lo + rt, u = lo + ru;
    if (t >= t0 && t < t1) {
      ga[(t - t0) * RM + ru] = g;
      loss -= log_sigmoid_f(x);
    }
    if (u >= t0 && u < t1) gb[rt * STRIP + (u - t0)] = g;
  }

  // sweep B: dphi[t] = sum_u g[t, u] ctx[u], dctx[u] = sum_t g[t, u]
  // phi[t] over the band, one slab at a time, 4 elements a thread
  for (int n = 0; n < ns; ++n) {
    const Slab sl(n, d);
    __syncthreads();  // g written; the last slab's reads
    stage(sl);
    __syncthreads();
    const int n4 = sl.wp / 4;
    for (int idx = threadIdx.x; idx < STRIP * n4; idx += THREADS) {
      const int a = idx / n4, c = 4 * (idx - a * n4), t = t0 + a;
      float4 gp = make_float4(0.0f, 0.0f, 0.0f, 0.0f), gc = gp;
      if (t < t1) {
        const int r1 = min(hi, t + W + 1) - lo;
        for (int r = max(lo, t - W) - lo; r < r1; ++r) {
          fma4(ga[a * RM + r],
               *reinterpret_cast<const float4*>(ctx + r * ds + c), gp);
          fma4(gb[r * STRIP + a],
               *reinterpret_cast<const float4*>(phi + r * ds + c), gc);
        }
      }
      const size_t o = (size_t)(base + t) * d + sl.s0;
      store4(dphi + o, sl.w, c, gp, vec);
      store4(dctx + o, sl.w, c, gc, vec);
      store4(dphin + o, sl.w, c, make_float4(0.0f, 0.0f, 0.0f, 0.0f), vec);
    }
  }
  finish_strip<PAIRED>(base, t0, t1, lo, L, wr, loss, nt, stats);
}

static inline size_t walk_pos_wide_smem_bytes(int d, int L, int W,
                                              bool bf16) {
  const size_t R = walk_pos_rows(L, W);
  return 16 + (bf16 ? 2 : 4) * 2 * R * pos_wide_stride(d, bf16) +
         sizeof(float) * 2 * STRIP * R +
         sizeof(int) * (2 * R + 2 * STRIP * R);
}

// Which band pass a step of width d, walk length L and window W takes
// (sgns_common.cuh: PosRoute); `bf16` says the band rounds its rows (BF16
// without PAIRED, which bf16 tables imply).
static inline int walk_pos_route(int d, int L, int W, bool bf16) {
  if (d <= MAX_DIM) return POS_ROWS;
  return walk_pos_wide_smem_bytes(d, L, W, bf16) <= POS_WIDE_SMEM ? POS_WHOLE
                                                                   : POS_SLAB;
}

// walk_pos_kernel past MAX_DIM with the strip's 2 R rows held whole for the
// pass (where walk_pos_wide_smem_bytes fits POS_WIDE_SMEM: R <= 103 rows in
// f32 at d 256, so W <= 47, any R in bf16 there; 62 KB at W 10 in f32, 33
// KB in bf16):
// one sweep, which scores every pair once from the held rows, forms g and
// the loss at once, then writes the strip's dphi, dctx and zeroed dphin.
// The rows are bf16 where the band rounds them (BF16 without PAIRED: each
// element rounded to nearest even as mxu<RND> rounds it; K3's bf16 rows as
// they are), else f32 (K1, K5 with either product mode), so a 16-byte
// shared-memory read carries 8 elements in the bf16 modes.  Where the rows
// are the table's own (f32 rows of an f32 table, K3's bf16 rows) they
// arrive by one cp.async.bulk a row and table onto an mbarrier (4-byte
// cp.async where a row's bytes are not a multiple of 16), issued right
// after the wait; K1b's and K4's f32 rows are loaded and rounded by
// stage_rows (16 loads in flight a thread).  The walk rows, window draws
// and the pair list are made before the wait (they read only the step's
// staged walks and draws).  Scoring: 8 lanes a pair, a lane's 16-byte
// pieces in column order, two pairs at a time; the updates: a thread owns
// one 16-byte piece (4 or 8 columns) of the dphi and dctx of two slots (f32
// rows) or one (bf16).  The scores are f32 sums of
// the (rounded) products, as walk_pos_kernel's.  Grid, outputs and PDL as
// walk_pos_kernel.
template <bool BF16, bool PAIRED, typename T>
static __global__ void __launch_bounds__(THREADS)
walk_pos_wide_kernel(const T* emb_in, const T* emb_out, const int* walks,
                     const int* wrow, int d, int L, int W,
                     float* __restrict__ dphi, float* __restrict__ dctx,
                     float* __restrict__ dphin, float* __restrict__ nt,
                     double* __restrict__ stats) {
  constexpr bool RND = BF16 && !PAIRED;
  using E = std::conditional_t<RND, __nv_bfloat16, float>;
  constexpr int V = 16 / sizeof(E);  // elements of a 16-byte piece
  // the rows arrive as they are in the table (else: loaded and rounded)
  constexpr bool DIRECT = std::is_same<E, T>::value;
  const int t0 = blockIdx.x * STRIP, base = blockIdx.y * BLK;
  if (t0 >= L) {  // padding slots: exact zeros, no pairs
    zero_strip(base, t0, d, dphi, dctx, dphin, nt);
    return;
  }
  const int t1 = min(t0 + STRIP, L);  // the strip's centres: [t0, t1)
  const int lo = max(0, t0 - W), hi = min(L, t1 + W), R = hi - lo;
  const int RM = walk_pos_rows(L, W), S = pos_wide_stride(d, RND);
  const int dp = (d + V - 1) / V * V, nq = dp / V;  // pieces a row
  const bool vec = d * sizeof(T) % 16 == 0;  // one bulk copy a row
  extern __shared__ float4 wide_smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(wide_smem);
  E* phi = reinterpret_cast<E*>(wide_smem + 1);  // [R][S]: row lo + r
  E* ctx = phi + R * S;                          // [R][S]
  float* ga = reinterpret_cast<float*>(phi + 2 * RM * S);  // [STRIP][RM]
  float* gb = ga + STRIP * RM;      // [RM][STRIP]: g[lo + r, t0 + a]
  int* wr = reinterpret_cast<int*>(gb + RM * STRIP);  // [RM] window draws
  int* rows = wr + RM;              // [RM] table rows
  int* plist = rows + RM;           // [2 * STRIP * RM] pairs r_t << 16 | r_u
  __shared__ int npairs;

  for (int r = threadIdx.x; r < R; r += THREADS) {
    rows[r] = step_ld(walks + base + lo + r);
    wr[r] = PAIRED ? 1 : min(step_ld(wrow + base + lo + r), W);
  }
  for (int idx = threadIdx.x; idx < 2 * STRIP * RM; idx += THREADS)
    ga[idx] = 0.0f;  // ga and gb
  if (DIRECT) {  // the columns past d of every held row: zeros
    for (int idx = threadIdx.x; idx < 2 * R * (dp - d); idx += THREADS)
      phi[idx / (dp - d) * S + d + idx % (dp - d)] = E(0.0f);
  }
  if (threadIdx.x == 0) {
    npairs = 0;
    if (DIRECT) mbar_init(bar, vec ? 1 : THREADS);
  }
  fence_async_smem();
  __syncthreads();
  list_pairs<PAIRED>(t0, t1, lo, R, wr, plist, &npairs);
  pdl_wait();
  auto row = [&](int i) {  // held row i's source: emb_in's, then emb_out's
    return i < R ? emb_in + (size_t)rows[i] * d
                 : emb_out + (size_t)rows[i - R] * d;
  };
  if constexpr (DIRECT) {
    copy_rows<THREADS>(phi, S, 2 * R, d, row, bar, vec);
    mbar_wait(bar, 0);
  } else {  // K1b, K4: f32 rows rounded to bf16 as they land
    stage_rows<THREADS, 16, T>(
        2 * R, d, dp, row,
        [&](int i, int c, float4 v) { put_bf16(phi + i * S + c, v); });
  }
  __syncthreads();

  // two pairs a group of 8 lanes at a time (p and p + THREADS / 8), each
  // summed as walk_pos_kernel sums it: two independent chains a lane
  const int np = npairs, lane8 = threadIdx.x & 7;
  float loss = 0.0f;
  auto put_g = [&](int p, float s) {  // g and the loss of pair p, score s
    const int pr = plist[p], rt = pr >> 16, ru = pr & 0xffff;
    const float g = mxu<RND>(sigmoid_f(s) - 1.0f);
    const int t = lo + rt, u = lo + ru;
    if (t >= t0 && t < t1) {
      ga[(t - t0) * RM + ru] = g;
      loss -= log_sigmoid_f(s);
    }
    if (u >= t0 && u < t1) gb[rt * STRIP + (u - t0)] = g;
  };
  for (int p0 = 0; p0 < np; p0 += THREADS / 4) {
    const int p = p0 + (threadIdx.x >> 3), p2 = p + THREADS / 8;
    const int pr = p < np ? plist[p] : 0, pr2 = p2 < np ? plist[p2] : 0;
    const E* a = phi + (pr >> 16) * S;
    const E* b = ctx + (pr & 0xffff) * S;
    const E* a2 = phi + (pr2 >> 16) * S;
    const E* b2 = ctx + (pr2 & 0xffff) * S;
    float s = 0.0f, s2 = 0.0f;
    for (int q = lane8; q < nq; q += 8) {
      float x[V], y[V], x2[V], y2[V];
      unpack16(a + V * q, x);
      unpack16(b + V * q, y);
      unpack16(a2 + V * q, x2);
      unpack16(b2 + V * q, y2);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s = fmaf(x[k], y[k], s);
        s2 = fmaf(x2[k], y2[k], s2);
      }
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane8 == 0) {
      if (p < np) put_g(p, s);
      if (p2 < np) put_g(p2, s2);
    }
  }
  __syncthreads();

  // dphi[t] = sum_u g[t, u] ctx[u], dctx[u] = sum_t g[t, u] phi[t] over
  // the band: a thread owns one 16-byte piece of held row for NC adjacent
  // centres (NC 2 for f32 rows, 1 for bf16), reading each row of their
  // windows' union once; g is zero outside a centre's window, so each sum
  // adds its window's terms in row order, as walk_pos_kernel's
  constexpr int NC = V == 4 ? 2 : 1, NA = STRIP / NC;
  const bool vs = d % 4 == 0;
  for (int idx = threadIdx.x; idx < NA * nq; idx += THREADS) {
    const int a0 = idx / nq, c = V * (idx - a0 * nq);
    float gp[NC][V], gc[NC][V];
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int k = 0; k < V; ++k) gp[j][k] = gc[j][k] = 0.0f;
    // the rows of the NC centres' windows (centres past t1 have none)
    const int tl = t0 + NC * a0, th = min(tl + NC - 1, t1 - 1);
    const int r0 = max(lo, tl - W) - lo, r1 = min(hi, th + W + 1) - lo;
#pragma unroll 2
    for (int r = tl < t1 ? r0 : r1; r < r1; ++r) {
      float cv[V], pv[V];
      unpack16(ctx + r * S + c, cv);
      unpack16(phi + r * S + c, pv);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int a = NC * a0 + j;
        const float x = ga[a * RM + r], y = gb[r * STRIP + a];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          gp[j][k] = fmaf(x, cv[k], gp[j][k]);
          gc[j][k] = fmaf(y, pv[k], gc[j][k]);
        }
      }
    }
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const size_t o = (size_t)(base + t0 + NC * a0 + j) * d;
#pragma unroll
      for (int h = 0; h < V / 4; ++h) {
        if (c + 4 * h >= d) break;
        const int ch = c + 4 * h;
        store4(dphi + o, d, ch,
               make_float4(gp[j][4 * h], gp[j][4 * h + 1], gp[j][4 * h + 2],
                           gp[j][4 * h + 3]),
               vs);
        store4(dctx + o, d, ch,
               make_float4(gc[j][4 * h], gc[j][4 * h + 1], gc[j][4 * h + 2],
                           gc[j][4 * h + 3]),
               vs);
        store4(dphin + o, d, ch, zero, vs);
      }
    }
  }
  finish_strip<PAIRED>(base, t0, t1, lo, L, wr, loss, nt, stats);
}

// K3's slot writes (pallas_walk_sgns.py:369-400, the slot fori_loop of
// _walk_kernel on bf16 tables, :377): for each real slot t of group g
// (position < L), in slot order, emb_in[v] = round(f32(emb_in[v]) +
// __fmul_rn(__fadd_rn(dphi[t], dphin[t]), -lr)) and emb_out[v] =
// round(f32(emb_out[v]) + __fmul_rn(dctx[t], -lr)), v = walks[t], each
// element rounded by sr_bits(sr_key(seed, g), t*d + k): its low 16 bits for
// the node row, its high 16 for the ctx row (SR), or truncated.  Bit for bit
// what the plain version (ops/walk_sgns.py::walk_scatter_bf16_reference,
// rmw_rows in slot order) writes from the same dphi, dphin and dctx.  A
// walk revisits nodes and hubs fill many slots, so a group may write a row
// many times; each distinct row gets one owner, the team of its first slot
// (slot_chains_kernel's info), which loads both rows once, applies the
// row's slots in order (order[i], ..., order[i + n - 1]) with the rows in
// registers and stores each once, with plain stores and no atomics.  A
// team is 16 lanes for a bf16 row of at most 16 pieces (d 128), else a
// warp; a piece is 16 bytes of the row (8 elements) where d % 8 == 0, else
// a bf16 pair (E = 2; d is even for bf16 tables).  The grid is the group's
// NBLK * L real slots' teams (padding slots get none); a team that does
// not own its row waits and exits.  Before its wait a team reads its
// slot's (place, count), row and first two batches of chained slots, lr
// and the seed (the chains, walks and argument block are two or more
// kernels before it: complete); after it, the rows and the slots' dphi,
// dphin and dctx pieces, a batch of slots' loads in flight at once
// (scatter_u) and the next batch's issued before this one's roundings, so
// a hub's long chain keeps its loads ahead of its dependent roundings.
// (Loading the rows before the wait, which the PDL rule allows since the
// negative pass just before only reads them, measured the same: they are
// in L2 after the band and negative passes read them; PERF.md §6.)  It
// is bound by latency, not bytes: it reads the real slots' three f32
// update rows and moves the distinct rows of two tables in and out (K3
// at d 128: 0.49 us at 3.35 TB/s).  block SCATTER_BF16_THREADS.  lr and
// the seed from the argument block `args`, or, without one (the C entry
// that runs the kernel alone), from `lr_in` and `seed_in`.
constexpr int SCATTER_BF16_THREADS = 128;

// Slots whose pieces a lane loads at once: a batch; two batches are in
// flight (the next batch's loads go out before this one's roundings).
template <int E>
__host__ __device__ constexpr int scatter_u() {
  return E == 8 ? 2 : 4;
}

// A batch's loads: elements j..j+E-1 of dphi, dphin and dctx (a, b, c) of
// slots cs[0..U) (-1: none), all in flight together.
template <int E, int U = scatter_u<E>()>
struct SlotBatch {
  int cs[U];
  float a[U][E], b[U][E], c[U][E];

  __device__ __forceinline__ void load(const float* dphi, const float* dphin,
                                       const float* dctx, int d, int j) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (cs[i] < 0) continue;
      const size_t o = (size_t)cs[i] * d + j;
      if constexpr (E == 8) {
#pragma unroll
        for (int h = 0; h < 8; h += 4) {
          const float4 x =
              step_ld(reinterpret_cast<const float4*>(dphi + o + h));
          const float4 y =
              step_ld(reinterpret_cast<const float4*>(dphin + o + h));
          const float4 z =
              step_ld(reinterpret_cast<const float4*>(dctx + o + h));
          a[i][h] = x.x, a[i][h + 1] = x.y, a[i][h + 2] = x.z;
          a[i][h + 3] = x.w;
          b[i][h] = y.x, b[i][h + 1] = y.y, b[i][h + 2] = y.z;
          b[i][h + 3] = y.w;
          c[i][h] = z.x, c[i][h + 1] = z.y, c[i][h + 2] = z.z;
          c[i][h + 3] = z.w;
        }
      } else {
        const float2 x = step_ld(reinterpret_cast<const float2*>(dphi + o));
        const float2 y = step_ld(reinterpret_cast<const float2*>(dphin + o));
        const float2 z = step_ld(reinterpret_cast<const float2*>(dctx + o));
        a[i][0] = x.x, a[i][1] = x.y;
        b[i][0] = y.x, b[i][1] = y.y;
        c[i][0] = z.x, c[i][1] = z.y;
      }
    }
  }

  // x (node row) and y (ctx row), elements j..j+E-1 as f32 values of bf16,
  // through the batch's slots in order: x = round(x + (a + b) * -lr), y =
  // round(y + c * -lr), each element rounded by the low (x) and high (y) 16
  // bits of sr_bits(key, cs[i] * d + j + e) (SR) or truncated.
  template <bool SR>
  __device__ __forceinline__ void apply(float (&x)[E], float (&y)[E], int d,
                                        int j, float lr,
                                        unsigned key) const {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (cs[i] < 0) break;
      const unsigned at = (unsigned)(cs[i] * d + j);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned r = SR ? mix32((at + e) ^ key) : 0u;
        const float sx =
            __fadd_rn(x[e], __fmul_rn(__fadd_rn(a[i][e], b[i][e]), -lr));
        const float sy = __fadd_rn(y[e], __fmul_rn(c[i][e], -lr));
        x[e] = __uint_as_float(((__float_as_uint(sx) + (r & 0xffffu)) >> 16)
                               << 16);
        y[e] = __uint_as_float(((__float_as_uint(sy) + (r >> 16)) >> 16)
                               << 16);
      }
    }
  }
};

// A row pair's piece of E bf16 elements at j, widened exactly, and back.
template <int E>
static __device__ __forceinline__ void load_row_piece(const __nv_bfloat16* row,
                                                      int j, float (&x)[E]) {
  if constexpr (E == 8) {
    const uint4 w = step_ld(reinterpret_cast<const uint4*>(row + j));
    widen2(w.x, x), widen2(w.y, x + 2), widen2(w.z, x + 4);
    widen2(w.w, x + 6);
  } else {
    widen2(step_ld(reinterpret_cast<const unsigned*>(row + j)), x);
  }
}

template <int E>
static __device__ __forceinline__ void store_row_piece(__nv_bfloat16* row,
                                                       int j,
                                                       const float (&x)[E]) {
  if constexpr (E == 8)
    *reinterpret_cast<uint4*>(row + j) =
        make_uint4(pack2(x), pack2(x + 2), pack2(x + 4), pack2(x + 6));
  else
    *reinterpret_cast<unsigned*>(row + j) = pack2(x);
}

// One owner's rows: its pieces p = tl, tl + ts, ... of E elements, each
// taken through the row's n slots ch[0..n) in order; `first` holds
// ch[0..2U) (-1 past n), read before the wait.  Each batch of U slots is
// applied once the next batch's loads and the slot numbers of the one
// after it are in flight.
template <bool SR, int E, int U = scatter_u<E>()>
static __device__ __forceinline__ void scatter_rows(
    __nv_bfloat16* row_in, __nv_bfloat16* row_out, const float* dphi,
    const float* dphin, const float* dctx, const int* ch, int n,
    const int (&first)[2 * U], int d, int ts, int tl, float lr,
    unsigned key) {
  for (int p = tl; p * E < d; p += ts) {
    const int j = p * E;
    SlotBatch<E> cur, next;
#pragma unroll
    for (int i = 0; i < U; ++i)
      cur.cs[i] = first[i], next.cs[i] = first[U + i];
    cur.load(dphi, dphin, dctx, d, j);
    float x[E], y[E];
    load_row_piece<E>(row_in, j, x);
    load_row_piece<E>(row_out, j, y);
    for (int i0 = 0; i0 < n; i0 += U) {
      if (next.cs[0] >= 0) next.load(dphi, dphin, dctx, d, j);
      int after[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int k = i0 + 2 * U + i;
        after[i] = k < n ? step_ld(ch + k) : -1;
      }
      cur.template apply<SR>(x, y, d, j, lr, key);
      cur = next;
#pragma unroll
      for (int i = 0; i < U; ++i) next.cs[i] = after[i];
    }
    store_row_piece<E>(row_in, j, x);
    store_row_piece<E>(row_out, j, y);
  }
}

template <bool SR, int E>
static __global__ void __launch_bounds__(SCATTER_BF16_THREADS)
walk_scatter_bf16_kernel(__nv_bfloat16* emb_in, __nv_bfloat16* emb_out,
                         const int* walks, const float* dphi,
                         const float* dphin, const float* dctx,
                         const int* info, const int* order, int d, int L,
                         int ts, const StepArgs* args, float lr_in,
                         unsigned seed_in, int g) {
  constexpr int U = scatter_u<E>();
  const float lr = args != nullptr ? step_ld(&args->lr) : lr_in;
  const unsigned key =
      SR ? sr_key(args != nullptr ? step_ld(&args->seed) : seed_in,
                  (unsigned)g)
         : 0u;
  // the team's real slot, its place and count, its row and first slots
  const int i = blockIdx.x * (SCATTER_BF16_THREADS / ts) + threadIdx.x / ts;
  int t = -1, v = 0, first[2 * U];
  int2 in = make_int2(0, 0);
  if (i < NBLK * L) {
    t = i / L * BLK + i % L;
    in = step_ld(reinterpret_cast<const int2*>(info) + t);
    if (in.y > 0) v = step_ld(walks + t);
  }
#pragma unroll
  for (int u = 0; u < 2 * U; ++u)
    first[u] = u == 0 ? t : u < in.y ? step_ld(order + in.x + u) : -1;
  pdl_wait();
  if (in.y > 0)  // else an earlier slot of the row owns it (or no slot)
    scatter_rows<SR, E>(emb_in + (size_t)v * d, emb_out + (size_t)v * d,
                        dphi, dphin, dctx, order + in.x, in.y, first, d, ts,
                        threadIdx.x % ts, lr, key);
  pdl_trigger();
}

// The team width of K3's slot scatter for rows of d elements (d even).
static inline int scatter_team(int d) {
  return pool_team(d, d % 8 == 0 ? 8 : 2);
}

// walk_scatter_bf16_kernel's launch for group g on `stream` (with PDL when
// `pdl`): its chains `info`, `order` (slot_chains_kernel's of the group),
// lr and the SR seed from `args`, or `lr`, `seed` where it is null.
template <bool SR>
static cudaError_t launch_scatter_bf16(__nv_bfloat16* emb_in,
                                       __nv_bfloat16* emb_out,
                                       const int* walks, const float* dphi,
                                       const float* dphin, const float* dctx,
                                       const int* info, const int* order,
                                       int d, int L, const StepArgs* args,
                                       float lr, unsigned seed, int g,
                                       cudaStream_t stream, bool pdl) {
  const int ts = scatter_team(d), per = SCATTER_BF16_THREADS / ts;
  const int grid = (NBLK * L + per - 1) / per;
  auto* kernel = d % 8 == 0 ? walk_scatter_bf16_kernel<SR, 8>
                            : walk_scatter_bf16_kernel<SR, 2>;
  return launch_kernel(kernel, dim3(grid), dim3(SCATTER_BF16_THREADS), 0,
                       stream, pdl, 0, emb_in, emb_out, walks, dphi, dphin,
                       dctx, info, order, d, L, ts, args, lr, seed, g);
}

// The f32 slot writes by owned rows (owned_writes.cuh: f32_owner,
// f32_write, on the chains slot_chains_kernel and fold_chains_kernel sort
// once a step).
//
// The f32 slot writes of a group that ends no R-block.  grid: the group's
// NBLK * L real slots' teams (launch_scatter_f32), block
// SCATTER_F32_THREADS.
template <int E>
static __global__ void __launch_bounds__(SCATTER_F32_THREADS)
walk_scatter_kernel(float* emb_in, float* emb_out, const int* walks,
                    const float* dphi, const float* dphin, const float* dctx,
                    const int* info, const int* order, int d, int L,
                    const StepArgs* args, float lr_in) {
  const float lr = args != nullptr ? step_ld(&args->lr) : lr_in;
  const int i = blockIdx.x * (SCATTER_F32_THREADS / 32) + threadIdx.x / 32;
  const F32Owner<> o = f32_owner<false>(i, walks, info, order, L, nullptr,
                                        nullptr, nullptr, 0, nullptr,
                                        nullptr);
  pdl_wait();
  if (o.n > 0)
    f32_write<E>(o, emb_in, emb_out, dphi, dphin, dctx, nullptr, d, lr);
  pdl_trigger();
}

// The f32 slot writes of the group that ends an R-block, with the block's
// pool write folded in: the real slots' teams, then one team a draw of the
// pool `pool` (KP draws, chains pinfo, porder; the group's fold chains
// fold_slot, fold_draw), so the pool write takes no launch of its own.
// grid: NBLK * L + KP teams, block SCATTER_F32_THREADS.
template <int E>
static __global__ void __launch_bounds__(SCATTER_F32_THREADS)
block_end_scatter_kernel(float* emb_in, float* emb_out, const int* walks,
                         const float* dphi, const float* dphin,
                         const float* dctx, const int* info, const int* order,
                         const int* pool, const float* dneg,
                         const int* pinfo, const int* porder,
                         const int* fold_slot, const int* fold_draw, int KP,
                         int d, int L, const StepArgs* args, float lr_in) {
  const float lr = args != nullptr ? step_ld(&args->lr) : lr_in;
  const int i = blockIdx.x * (SCATTER_F32_THREADS / 32) + threadIdx.x / 32;
  const F32Owner<> o = f32_owner<true>(i, walks, info, order, L, pool,
                                       pinfo, porder, KP, fold_slot,
                                       fold_draw);
  pdl_wait();
  if (o.n > 0 || o.pn > 0)
    f32_write<E>(o, emb_in, emb_out, dphi, dphin, dctx, dneg, d, lr);
  pdl_trigger();
}

// The f32 slot writes of group `walks` on `stream` (with PDL when `pdl`):
// walk_scatter_kernel, or with a pool (`pool` not null: the group ends an
// R-block) block_end_scatter_kernel with the pool's dneg and chains
// (pinfo, porder) and the group's fold chains (fold_slot, fold_draw).  Its
// chains `info`, `order` (slot_chains_kernel's of the group); lr from
// `args`, or `lr` where it is null.  `launched` (may be null) counts the
// launch under PASS_WALK_SCATTER or PASS_BLOCK_END_SCATTER.
static cudaError_t launch_scatter_f32(
    float* emb_in, float* emb_out, const int* walks, const float* dphi,
    const float* dphin, const float* dctx, const int* info, const int* order,
    const int* pool, const float* dneg, const int* pinfo, const int* porder,
    const int* fold_slot, const int* fold_draw, int KP, int d, int L,
    const StepArgs* args, float lr, cudaStream_t stream, bool pdl,
    int* launched) {
  constexpr int per = SCATTER_F32_THREADS / 32;
  const bool vec = d % 4 == 0;
  cudaError_t e;
  if (pool == nullptr) {
    e = launch_kernel(vec ? walk_scatter_kernel<4> : walk_scatter_kernel<1>,
                      dim3((NBLK * L + per - 1) / per),
                      dim3(SCATTER_F32_THREADS), 0, stream, pdl, 0, emb_in,
                      emb_out, walks, dphi, dphin, dctx, info, order, d, L,
                      args, lr);
  } else {
    e = launch_kernel(
        vec ? block_end_scatter_kernel<4> : block_end_scatter_kernel<1>,
        dim3((NBLK * L + KP + per - 1) / per), dim3(SCATTER_F32_THREADS), 0,
        stream, pdl, 0, emb_in, emb_out, walks, dphi, dphin, dctx, info,
        order, pool, dneg, pinfo, porder, fold_slot, fold_draw, KP, d, L,
        args, lr);
  }
  if (e == cudaSuccess && launched != nullptr)
    ++launched[pool == nullptr ? PASS_WALK_SCATTER : PASS_BLOCK_END_SCATTER];
  return e;
}

// Walk generation (TPU GEN_WALKS, pallas_walk_sgns.py:182-201).  One thread
// per walk w of nwalks: slot w*128 holds starts[w]; hop t (1 <= t < L)
// reads b = bits[w*128 + t] as 32 bits and moves from v to
//   indices[indptr[v] + min(int(u * float(deg)), max(deg - 1, 0))],
//   u = float((b >> 8) & 0xFFFFFF) * 2^-24   (both products in f32),
// and a node of degree 0 stays where it is.  Slots at positions >= L are 0.
// grid ceil(nwalks / 128), block 128.  The kernel after the step's head
// (which stages starts and bits), launched without PDL, so it needs no
// wait.
static __global__ void walk_gen_kernel(const int* __restrict__ starts,
                                       const unsigned* __restrict__ bits,
                                       const int* __restrict__ indptr,
                                       const int* __restrict__ indices,
                                       int nwalks, int L,
                                       int* __restrict__ slots) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nwalks) return;
  const size_t base = (size_t)w * BLK;
  int v = starts[w];
  slots[base] = v;
  for (int t = 1; t < BLK; ++t) {
    if (t < L) {
      const unsigned b = bits[base + t];
      const int lo = indptr[v];
      const int deg = indptr[v + 1] - lo;
      const float u = __fmul_rn((float)((b >> 8) & 0xFFFFFFu), 1.0f / 16777216.0f);
      const int r = min((int)__fmul_rn(u, (float)deg), max(deg - 1, 0));
      if (deg > 0) v = indices[lo + r];
      slots[base + t] = v;
    } else {
      slots[base + t] = 0;
    }
  }
}

// The arguments of one walk-kernel macro step (the C entries' buffers,
// below), as the group loop reads them: walks, wrow and pools (and K4's
// starts and bits) are the plan's buffers, which the step's head kernel
// fills from the call's.  starts, bits, indptr and indices are set for K4
// only: the step then generates its walks into `walks` first.
struct WalkStep {
  void* emb_in;
  void* emb_out;
  const int* walks;
  const int* wrow;
  const int* pools;
  double* stats;
  float* cneg;
  float* dneg;
  float* dphi;
  float* dctx;
  float* nt;
  StepArgs* args;
  // K3: the pools' chains (sgns_common.cuh: pool_chains_kernel), then the
  // groups' slot chains (slot_chains_kernel)
  int* chains;
  int d, G, L, W, KP, R;
  float negw;
  const int* starts;
  const unsigned* bits;
  const int* indptr;
  const int* indices;
};

// The group loop of one step, launched on `stream` (the recording stream)
// after the step's chains, every kernel under PDL.  T = float: K1, K1b, K4
// and K5 (the f32 slot writes by owned rows, the pool write folded into
// the block end's scatter); T = __nv_bfloat16: K3 (rounded RMW scatter by
// owned rows in slot order, SR with a per-step seed; the pool write by
// owned rows in draw order); no atomics in either.  `launched` receives
// the route of the band pass it launched (PosRoute), and `pool_launched`
// counts the pool passes and the slot scatters it launched (PoolPass).
template <bool BF16, bool PAIRED, typename T, bool SR>
static int walk_groups(const NegSetup& ns, const WalkStep& s,
                       int* launched, int* pool_launched,
                       cudaStream_t stream) {
  constexpr bool TB16 = !std::is_same<T, float>::value;
  T* emb_in = static_cast<T*>(s.emb_in);
  T* emb_out = static_cast<T*>(s.emb_out);
  const int d = s.d, L = s.L, W = s.W, KP = s.KP, R = s.R;
  constexpr bool RND = BF16 && !PAIRED;  // the band rounds its rows
  const int route = walk_pos_route(d, L, W, RND);
  const size_t pos_smem = route == POS_ROWS ? walk_pos_smem_bytes(d, L, W)
                          : route == POS_WHOLE
                              ? walk_pos_wide_smem_bytes(d, L, W, RND)
                              : walk_pos_slab_smem_bytes(L, W);
  auto* pos_kernel = route == POS_ROWS ? walk_pos_kernel<BF16, PAIRED, T>
                     : route == POS_WHOLE
                         ? walk_pos_wide_kernel<BF16, PAIRED, T>
                         : walk_pos_slab_kernel<BF16, PAIRED, T>;
  NegativePass<BF16, T> neg;
  static_cast<NegSetup&>(neg) = ns;
  float* dphin = s.dphi + (size_t)GROUP * d;  // the negative pass's part
  const StepArgs* args = s.args;
  cudaError_t e;
  for (int g = 0; g < s.G; ++g) {
    const int* pool = s.pools + (size_t)(g / R) * KP;
    const int* wg = s.walks + (size_t)g * GROUP;
    if (g % R == 0) {
      e = neg.stage(emb_out, pool, s.cneg, s.dneg, d, KP, stream, true,
                    pool_launched);
      if (e != cudaSuccess) return (int)e;
    }
    const int* wr = PAIRED ? nullptr : s.wrow + (size_t)g * GROUP;
    e = launch_kernel(pos_kernel, dim3(NSTRIP, NBLK), dim3(THREADS),
                      pos_smem, stream, true, 0, (const T*)emb_in,
                      (const T*)emb_out, wg, wr, d, L, W, s.dphi, s.dctx,
                      dphin, s.nt, s.stats);
    if (e != cudaSuccess) return (int)e;
    *launched = route;
    e = neg.launch(emb_in, wg, s.nt, s.cneg, d, KP, s.negw, dphin, s.dneg,
                   s.stats, stream, true);
    if (e != cudaSuccess) return (int)e;
    const bool end = g % R == R - 1 || g == s.G - 1;
    const int n_pools = (s.G + R - 1) / R;
    const int* sc = s.chains + (size_t)3 * n_pools * KP;  // slot chains
    if constexpr (TB16) {
      e = launch_scatter_bf16<SR>(emb_in, emb_out, wg, s.dphi, dphin, s.dctx,
                                  slot_info(sc, g), slot_order(sc, g, s.G), d,
                                  L, args, 0.0f, 0u, g, stream, true);
      if (e != cudaSuccess) return (int)e;
      ++pool_launched[PASS_WALK_SCATTER_BF16];
      if (end) {
        e = launch_apply_bf16<SR>(neg, emb_out, pool, s.dneg, s.chains,
                                  g / R, n_pools, d, KP, args, 0.0f, 0u, g,
                                  stream, true);
        if (e != cudaSuccess) return (int)e;
        ++pool_launched[PASS_APPLY_POOL_BF16];
      }
    } else {  // the block end's pool write folded into its scatter
      const int* fold = sc + (size_t)3 * s.G * GROUP;  // the fold chains
      e = launch_scatter_f32(
          emb_in, emb_out, wg, s.dphi, dphin, s.dctx, slot_info(sc, g),
          slot_order(sc, g, s.G), end ? pool : nullptr, s.dneg,
          pool_chain_info(s.chains, g / R, KP),
          pool_chain_order(s.chains, g / R, n_pools, KP),
          fold + (size_t)g * GROUP,
          fold + (size_t)s.G * GROUP + (size_t)(g / R) * KP, KP, d, L, args,
          0.0f, stream, true, pool_launched);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

// One step in one mode: checks the shapes, sets the kernels up at the
// plan's first step (the band pass's shared-memory cap, the negative
// pass's sizing), records the step if `how` asks (the head kernel, K4's
// walk generation, then the group loop; step_graph.cuh) and replays it
// with this call's head parameters `hin`.
template <bool BF16, bool PAIRED, typename T, bool SR>
static int walk_step(StepGraph* p, int how, int mode, const WalkStep& s,
                     const HeadIn& hin, const HeadBufs& hb,
                     cudaStream_t stream) {
  constexpr bool TB16 = !std::is_same<T, float>::value;
  if (p == nullptr || s.d < 1 || s.G < 1 ||
      s.L < 1 || s.L > BLK || s.W < 1 || s.R < 1 ||
      (PAIRED && (s.W != 1 || s.L % 2)) || s.chains == nullptr ||
      (TB16 && s.d % 2))
    return (int)cudaErrorInvalidValue;
  if (p->mode < 0) {
    // the caps are what the largest strip needs (d MAX_DIM, or a slab, and
    // a whole walk; the wide kernel's route limit), so a plan of another
    // width never lowers them
    cudaError_t e = cudaFuncSetAttribute(
        walk_pos_kernel<BF16, PAIRED, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)walk_pos_smem_bytes(MAX_DIM, BLK, BLK));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(walk_pos_slab_kernel<BF16, PAIRED, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)walk_pos_slab_smem_bytes(BLK, BLK));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(walk_pos_wide_kernel<BF16, PAIRED, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)POS_WIDE_SMEM);
    if (e != cudaSuccess) return (int)e;
    NegativePass<BF16, T> neg;
    e = neg.init(s.d, s.KP, GROUP);
    if (e == cudaSuccess)
      e = TB16 ? apply_setup(neg, s.d, s.KP) : fold_setup(s.KP);
    if (e != cudaSuccess) return (int)e;
    p->neg = neg;
    p->mode = mode;
  } else if (p->mode != mode) {
    return (int)cudaErrorInvalidValue;  // a plan serves one mode
  }
  return run_step(
      p, how, stream,
      [&](cudaStream_t cap) -> int {
        cudaError_t e = launch_head(hin, hb, cap);
        if (e != cudaSuccess) return (int)e;
        if (s.starts != nullptr) {  // K4, on the staged starts and draws
          const int nwalks = s.G * NBLK;
          e = launch_kernel(walk_gen_kernel, dim3((nwalks + 127) / 128),
                            dim3(128), 0, cap, false, 0, s.starts, s.bits,
                            s.indptr, s.indices, nwalks, s.L,
                            const_cast<int*>(s.walks));
          if (e != cudaSuccess) return (int)e;
        }
        // every block's pool and every group's real slots sorted into
        // their chains, which the slot and pool writes follow
        const int n_pools = (s.G + s.R - 1) / s.R;
        e = launch_chains(s.pools, n_pools, s.KP, s.chains, cap);
        if (e != cudaSuccess) return (int)e;
        ++p->pool[PASS_POOL_CHAINS];
        e = launch_slot_chains(s.walks, nullptr, s.G, s.L,
                               s.chains + (size_t)3 * n_pools * s.KP, cap,
                               true);
        if (e != cudaSuccess) return (int)e;
        ++p->pool[PASS_SLOT_CHAINS];
        if (!TB16) {  // the f32 block ends' fold chains
          int* sc = s.chains + (size_t)3 * n_pools * s.KP;
          e = launch_fold_chains(s.walks, nullptr, sc, s.pools, s.chains,
                                 s.G, s.L, s.KP, s.R,
                                 sc + (size_t)3 * s.G * GROUP, cap, true);
          if (e != cudaSuccess) return (int)e;
          ++p->pool[PASS_FOLD_CHAINS];
        }
        return walk_groups<BF16, PAIRED, T, SR>(p->neg, s, &p->route,
                                                p->pool, cap);
      },
      step_head_kernel, hin, hb);
}

// Dispatch on the runtime modes: tables_bf16 (K3, with sr) excludes
// paired and implies K1b's rounding.  The mode number, which a plan keeps,
// is bf16 | paired << 1 | tables_bf16 << 2 | sr << 3 | K4 << 4.
static int walk_step_mode(void* graph, int how, int bf16, int paired,
                          int tables_bf16, int sr, const WalkStep& s,
                          const HeadIn& hin, const HeadBufs& hb,
                          cudaStream_t stream) {
  StepGraph* p = static_cast<StepGraph*>(graph);
  const int mode = (bf16 != 0) | (paired != 0) << 1 | (tables_bf16 != 0) << 2 |
                   (sr != 0) << 3 | (s.starts != nullptr) << 4;
#define COME_WALK_STEP(B, P, T, S) \
  walk_step<B, P, T, S>(p, how, mode, s, hin, hb, stream)
  if (tables_bf16) {
    if (paired) return (int)cudaErrorInvalidValue;
    return sr ? COME_WALK_STEP(true, false, __nv_bfloat16, true)
              : COME_WALK_STEP(true, false, __nv_bfloat16, false);
  }
  if (paired)
    return bf16 ? COME_WALK_STEP(true, true, float, false)
                : COME_WALK_STEP(false, true, float, false);
  return bf16 ? COME_WALK_STEP(true, false, float, false)
              : COME_WALK_STEP(false, false, float, false);
#undef COME_WALK_STEP
}

}  // namespace come

using namespace come;

// One walk-kernel macro step over G groups through the plan's graph slot
// `graph` (come_step_graph_new): `record` 1 records the step and
// instantiates the slot's graph (the plan's first step), 2 records it and
// updates the instance (a table moved), 0 replays it; every call sets the
// head kernel's parameters (the call's walks, window draws and pools, lr,
// the SR seed) and launches the instance on `stream`.  All buffers are
// device pointers:
//   emb_in, emb_out [V, d] f32, or bf16 with tables_bf16 (updated in place)
//   walks           [G * 1024] i32 (walk j of group g at g*1024 + j*128)
//   wrow            [G * 1024] i32 window draws (not read when paired)
//   pools           [ceil(G / R), KP] i32
//   stats           [2] f64 scratch: the step's (loss, pairs)
//   cneg, dneg      [KP, d] f32 scratch
//   dphi            [2, 1024, d] f32 scratch: the positive pass's part of
//                   each slot's update, then the negative pass's
//   dctx            [1024, d] f32 scratch;  nt [1024] f32 scratch
//   walks_buf, wrow_buf, pools_buf: the plan's copies of walks, wrow
//                   (unused when paired) and pools, which the loop reads
//   args            the plan's argument block (sgns_common.cuh: StepArgs)
//   chains          [4 * ceil(G / R) * KP + 4 * G * 1024] i32 scratch, the
//                   pools' chains (sgns_common.cuh: pool_chains_kernel),
//                   the groups' slot chains (slot_chains_kernel), then the
//                   f32 block ends' fold chains (fold_chains_kernel: 1024
//                   a group, then KP a pool; unused with bf16 tables)
// bf16 != 0 selects K1b's rounding, paired != 0 K5 (W must be 1, L even),
// tables_bf16 != 0 K3 (d even; stochastic rounding from sr_seed when
// sr != 0, else truncation).  A plan serves one mode and one (d, G, L, W,
// KP, R); its recording holds the tables' addresses and negw.  Returns 0
// or the first CUDA error code.  Enqueues only: it does not synchronise and
// allocates no device memory.
extern "C" int come_walk_sgns_step(
    void* graph, int record, void* emb_in, void* emb_out, const int* walks,
    const int* wrow, const int* pools, double* stats, float* cneg,
    float* dneg, float* dphi, float* dctx, float* nt, int* walks_buf,
    int* wrow_buf, int* pools_buf, void* args, int* chains,
    int d, int G, int L, int W, int KP, int R, int bf16, int paired,
    int tables_bf16, int sr, unsigned sr_seed, float lr, float negw,
    void* stream_ptr) {
  StepArgs* a = static_cast<StepArgs*>(args);
  const WalkStep s{emb_in, emb_out, walks_buf, wrow_buf, pools_buf, stats,
                   cneg, dneg, dphi, dctx, nt, a, chains, d, G, L, W, KP, R,
                   negw, nullptr, nullptr, nullptr, nullptr};
  const int slots = G * GROUP, np = (G + R - 1) / R * KP;
  const HeadIn hin{{walks, paired ? nullptr : wrow, pools, nullptr}, lr,
                   sr_seed};
  const HeadBufs hb{{walks_buf, wrow_buf, pools_buf, nullptr},
                    {slots, paired ? 0 : slots, np, 0}, a, stats};
  return walk_step_mode(graph, record, bf16, paired, tables_bf16, sr, s, hin,
                        hb, (cudaStream_t)stream_ptr);
}

// K4: generate the walks of G groups into `slots` [G * 1024] i32 (the
// plan's) from starts [G * 8] i32, bits [G * 1024] u32 and the CSR (indptr
// [V + 1], indices [E] i32), then run the group loop on them (bf16,
// tables_bf16, sr as above), as one recorded step.  starts_buf, bits_buf,
// wrow_buf and pools_buf are the plan's copies of the call's starts, bits,
// wrow and pools.  Other arguments as come_walk_sgns_step; the recording
// also holds the CSR's addresses.
extern "C" int come_walk_sgns_gen_step(
    void* graph, int record, void* emb_in, void* emb_out, const int* starts,
    const unsigned* bits, const int* indptr, const int* indices, int* slots,
    const int* wrow, const int* pools, double* stats, float* cneg,
    float* dneg, float* dphi, float* dctx, float* nt, int* starts_buf,
    unsigned* bits_buf, int* wrow_buf, int* pools_buf, void* args,
    int* chains, int d, int G, int L, int W, int KP, int R,
    int bf16, int tables_bf16, int sr, unsigned sr_seed, float lr,
    float negw, void* stream_ptr) {
  StepArgs* a = static_cast<StepArgs*>(args);
  const WalkStep s{emb_in, emb_out, slots, wrow_buf, pools_buf, stats,
                   cneg, dneg, dphi, dctx, nt, a, chains, d, G, L, W, KP, R,
                   negw, starts_buf, bits_buf, indptr, indices};
  const int n = G * GROUP, np = (G + R - 1) / R * KP;
  const HeadIn hin{{starts, reinterpret_cast<const int*>(bits), wrow, pools},
                   lr, sr_seed};
  const HeadBufs hb{{starts_buf, reinterpret_cast<int*>(bits_buf), wrow_buf,
                     pools_buf},
                    {G * NBLK, n, n, np}, a, stats};
  return walk_step_mode(graph, record, bf16, 0, tables_bf16, sr, s, hin, hb,
                        (cudaStream_t)stream_ptr);
}

// The band pass a walk step of these arguments takes (come_walk_sgns_step's
// d, L, W and modes; sgns_common.cuh: PosRoute): 0 d <= 192
// (walk_pos_kernel), 1 whole rows (walk_pos_wide_kernel), 2 column slabs
// (walk_pos_slab_kernel).  The group loop routes by the same rule.
extern "C" int come_walk_pos_route(int d, int L, int W, int bf16, int paired,
                                   int tables_bf16) {
  return walk_pos_route(d, L, W, (bf16 != 0 || tables_bf16 != 0) && !paired);
}

// K3's slot chains and slot scatter alone, on given buffers: the C entries
// that hold each against its plain version (ops/scatter_pass.py) and time
// it, outside the step loop that launches them.  Both launch on the
// caller's stream without PDL, do not synchronise and allocate nothing.

// The slot chains of G groups of walks (walks [G * 1024] i32, walk j of
// group g at g*1024 + j*128, L real positions a walk) into chains
// [3 * G * 1024] i32: info [G][1024][2] (t's sorted place, and its row's
// slots at its first slot, else 0; padding slots (0, 0)), then order
// [G][1024] (the slot at each sorted place, -1 past the real slots).
// Returns 0 or the CUDA error code.
extern "C" int come_slot_chains(const int* walks, int G, int L, int* chains,
                                void* stream_ptr) {
  if (G < 1 || L < 1 || L > BLK) return (int)cudaErrorInvalidValue;
  return (int)launch_slot_chains(walks, nullptr, G, L, chains,
                                 (cudaStream_t)stream_ptr, false);
}

// K3's slot writes of group g alone: emb_in, emb_out [V, d] bf16 (d even,
// updated in place), walks [1024] i32 (the group's slots), dphi, dphin,
// dctx [1024, d] f32, chains the group's (come_slot_chains of these walks,
// G 1): for each real slot t in slot order, emb_in[v] = round(f32(row) +
// (dphi[t] + dphin[t]) * -lr) and emb_out[v] = round(f32(row) + dctx[t] *
// -lr), by stochastic rounding from `seed` (sr != 0) or truncation.
// Returns 0 or the CUDA error code.
extern "C" int come_walk_scatter_bf16(void* emb_in, void* emb_out,
                                      const int* walks, const float* dphi,
                                      const float* dphin, const float* dctx,
                                      const int* chains, int d, int L, int g,
                                      float lr, int sr, unsigned seed,
                                      void* stream_ptr) {
  if (d < 2 || d % 2 || L < 1 || L > BLK) return (int)cudaErrorInvalidValue;
  auto* ei = static_cast<__nv_bfloat16*>(emb_in);
  auto* eo = static_cast<__nv_bfloat16*>(emb_out);
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int* info = slot_info(chains, 0);
  const int* order = slot_order(chains, 0, 1);
  return (int)(sr ? launch_scatter_bf16<true>(ei, eo, walks, dphi, dphin,
                                               dctx, info, order, d, L,
                                               nullptr, lr, seed, g, stream,
                                               false)
                  : launch_scatter_bf16<false>(ei, eo, walks, dphi, dphin,
                                                dctx, info, order, d, L,
                                                nullptr, lr, 0u, g, stream,
                                                false));
}

// The fold chains of one group that ends a block alone: walks [1024] i32
// (the group's slots, L real positions a walk), chains the group's
// (come_slot_chains of these walks, G 1), pool [KP] i32 and pool_chains
// the pool's (come_pool_chains of it, n_pools 1), into fold [1024 + KP] i32:
// fold_slot [1024] (the place in the pool's chain of the first draw of
// real slot t's row, -1 where the pool does not draw it and at padding
// slots), then fold_draw [KP] (1 where draw k's row is a real slot's, else
// 0).  Launches on the caller's stream without PDL, does not synchronise
// and allocates nothing.  Returns 0 or the CUDA error code.
extern "C" int come_fold_chains(const int* walks, const int* chains,
                                const int* pool, const int* pool_chains,
                                int L, int KP, int* fold, void* stream_ptr) {
  if (L < 1 || L > BLK) return (int)cudaErrorInvalidValue;
  cudaError_t e = fold_setup(KP);
  if (e == cudaSuccess)
    e = launch_fold_chains(walks, nullptr, chains, pool, pool_chains, 1, L,
                           KP, 1, fold, (cudaStream_t)stream_ptr, false);
  return (int)e;
}

// The f32 slot writes of one group alone (walk_scatter_kernel), or with
// `pool` not null those of a group that ends an R-block with the block's
// pool write folded in (block_end_scatter_kernel): emb_in, emb_out [V, d]
// f32 (updated in place), walks [1024] i32 (the group's slots), dphi,
// dphin, dctx [1024, d] f32, chains the group's (come_slot_chains of these
// walks, G 1); pool [KP] i32, dneg [KP, d] f32, pool_chains the pool's
// (come_pool_chains of it, n_pools 1) and fold the group's fold chains
// (come_fold_chains).  For each distinct row of the real slots, emb_in[v]
// += f64 sum in slot order of f32((dphi[t] + dphin[t]) * -lr), emb_out[v]
// += that of f32(dctx[t] * -lr), each rounded once; then emb_out[pool[k]]
// += f32(dneg[k] * -lr) for k in order, each rounded.  Launches on the
// caller's stream without PDL, does not synchronise and allocates nothing.
// Returns 0 or the CUDA error code.
extern "C" int come_walk_scatter_f32(float* emb_in, float* emb_out,
                                     const int* walks, const float* dphi,
                                     const float* dphin, const float* dctx,
                                     const int* chains, const int* pool,
                                     const float* dneg,
                                     const int* pool_chains, const int* fold,
                                     int d, int L, int KP, float lr,
                                     void* stream_ptr) {
  const bool end = pool != nullptr;
  if (d < 1 || L < 1 || L > BLK || (end && KP < 1))
    return (int)cudaErrorInvalidValue;
  return (int)launch_scatter_f32(
      emb_in, emb_out, walks, dphi, dphin, dctx, slot_info(chains, 0),
      slot_order(chains, 0, 1), pool, dneg,
      end ? pool_chain_info(pool_chains, 0, KP) : nullptr,
      end ? pool_chain_order(pool_chains, 0, 1, KP) : nullptr,
      fold, end ? fold + GROUP : nullptr, KP, d, L, nullptr, lr,
      (cudaStream_t)stream_ptr, false, nullptr);
}
