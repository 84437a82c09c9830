// Flat SGNS micro-step against one shared negative pool, for Hopper, f32
// tables: K6 (two tables, O1) and K7 (one tied table, O2).
//
// Replaces the Pallas kernels come_tpu/ops/pallas_sgns.py::_fused_kernel
// (fused_sgns_step) and ::_fused_tied_kernel (fused_sgns_step_tied).
// Semantics are the TPU kernels', tile by tile in order:
//   * before the first tile the KP pool rows are staged from emb_out (the
//     tied table for K7) and dneg is zeroed: the pool is staged ONCE;
//   * a tile is TP pairs (c, x, m).  Every valid pair (m != 0) reads
//     phi = emb_in[c], cpos = emb_out[x] as the previous tile left them:
//     g = sigmoid(phi . cpos) - 1, dphi = g cpos, dcpos = g phi;
//   * every valid pair scores the staged pool with weight negw
//     (sgns_common.cuh: NegativePass, f32, with nt = mask), adding to dphi and
//     to the pool gradient dneg;
//   * each valid pair adds -lr*dphi to emb_in[c] and -lr*dcpos to
//     emb_out[x] with atomicAdd, so duplicate rows sum as the TPU's
//     sequential read-modify-writes do (in another order); for K7 both go
//     into the one table;
//   * after the last tile the pool gradient is applied once (atomic: the
//     pool is drawn with replacement and repeats rows on small graphs).
// Masked pairs contribute nothing.  The TPU zeroes their phi and subtracts
// their constant loss afterwards; here they are skipped.
//
// What bounds it on the H100: the negative pass, 3 x TP x KP x d
// multiply-adds per tile, is compute; the positive scores are one dot
// product per pair and the gathers and the scatter are row traffic
// (4 x d x 4 bytes per pair).  The design:
//   * a micro-step is one unit the card replays, as the TPU runs it as one
//     pallas_call with a grid over the tiles: the C entry records the tile
//     loop as a CUDA graph on the plan's private stream and replays it on
//     the caller's (step_graph.cuh), every kernel after tile 0's negative
//     pass under programmatic dependent launch (PDL, sgns_common.cuh: that
//     pass reads its slot ids before its wait, and the first kernel packs
//     them);
//   * the plan (ops/sgns.py, ops/launch_plan.py) owns every buffer the loop
//     reads besides the tables: the packed ids, the per-tile masks nt
//     (written once a call, rows TP.. of each tile's last 128-row chunk 0),
//     the pool, the scratch; the negative pass is sized once a plan;
//   * a tile runs negative -> positive -> scatter.  The negative and the
//     positive pass both read only what the previous tile's scatter left,
//     and the negative pass no longer needs the positive one (nt is the
//     plan's, its dphi part is zeroed once a call and then by each scatter
//     after it reads a row), so the positive pass does all its work before
//     its PDL wait, while the negative pass runs, and waits only to exit:
//     a tile's critical path is its negative pass and its scatter;
//   * the positive pass is one warp per pair with lanes across d, the
//     scatter one warp per pair with 16-byte loads and atomics;
//   * any d: past 192 the negative pass takes its column-slab form
//     (sgns_common.cuh: SLAB; the plan's sizing keeps at most NEGS_PMAX
//     pool chunks a CTA), and past 256 the positive pass loops over a
//     lane's columns instead of holding them in registers.
// The table pointers are not __restrict__: K7 passes one table as both.

#include "sgns_common.cuh"
#include "step_graph.cuh"

namespace come {

// An id of the caller's (int32, or int64 when `wide`) as int32.
static __device__ __forceinline__ int id_at(const void* p, bool wide,
                                            size_t i) {
  return wide ? (int)static_cast<const long long*>(p)[i]
              : static_cast<const int*>(p)[i];
}

// The step's first kernel (launched without PDL), in three block ranges:
//   * k < KP: pool[k] = the caller's pool id k, cneg[k] = emb_out[pool[k]],
//     dneg[k] = 0 (the pool staged once);
//   * the next TPr / 8: zero the negative pass's part of dphi, 8 rows each;
//   * the rest, a pair each thread: the call's P pairs packed into the
//     plan's buffers as ops/launch_plan.py::FusedPlan.pack packs them: ids
//     [3, n_tiles * TP + 128] i32 (centres, contexts, mask != 0; zero past
//     P) and nt [n_tiles, TPr] f32 (pair j of tile t at t * TPr + j; rows
//     TP.. stay 0, and so do the 128 extra ids).
// grid KP + TPr / 8 + ceil(n_tiles * TP / 128), block 128.
static __global__ void fused_stage_kernel(
    const float* table, const void* __restrict__ pool_in, bool pool_wide,
    const void* __restrict__ c_in, const void* __restrict__ x_in,
    bool ids_wide, const float* __restrict__ m_in, int P,
    int* __restrict__ ids, float* __restrict__ nt, int* __restrict__ pool,
    float* __restrict__ cneg, float* __restrict__ dneg,
    float* __restrict__ dphin, int d, int KP, int n_tiles, int TP) {
  const int TPr = (TP + BLK - 1) / BLK * BLK;
  const int k = blockIdx.x, zb = KP + TPr / 8;
  if (k < KP) {
    const int v = id_at(pool_in, pool_wide, k);
    if (threadIdx.x == 0) pool[k] = v;
    const size_t src = (size_t)v * d, dst = (size_t)k * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      cneg[dst + j] = table[src + j];
      dneg[dst + j] = 0.0f;
    }
  } else if (k < zb) {
    float* rows = dphin + (size_t)(k - KP) * 8 * d;
    for (int j = threadIdx.x; j < 8 * d; j += blockDim.x) rows[j] = 0.0f;
  } else {
    const size_t n = (size_t)n_tiles * TP, row = n + BLK;
    const size_t j = (size_t)(k - zb) * blockDim.x + threadIdx.x;
    if (j < n) {
      const bool in = j < (size_t)P;
      const bool valid = in && m_in[j] != 0.0f;
      ids[j] = in ? id_at(c_in, ids_wide, j) : 0;
      ids[row + j] = in ? id_at(x_in, ids_wide, j) : 0;
      ids[2 * row + j] = valid;
      nt[(j / TP) * TPr + j % TP] = valid ? 1.0f : 0.0f;
    }
  }
  pdl_trigger();
}

// Positive term of one tile, one warp per pair i < TP (grid ceil(TP / 8),
// block THREADS): dphi[i] = g cpos, dcpos[i] = g phi for the valid pairs
// (nt[i] != 0), and the positive loss and the pair count added to stats.
// Each lane keeps its columns lane + 32 q of both rows in registers up to
// d = 32 * KMAX (256), and loops over them past it.
// PDL: it runs after the tile's negative pass, and all its work comes
// before its wait: what it reads (ids, nt, the table rows the last scatter
// wrote, read through L2) no kernel still running writes, and what it
// writes (dphi, dcpos, stats by atomics) the running negative pass does not
// touch, the scatter that read them last being complete (sgns_common.cuh's
// note).  It waits only to exit, so the scatter after it starts once the
// negative pass is complete.
static __global__ void __launch_bounds__(THREADS)
fused_pos_kernel(const float* emb_in, const float* emb_out,
                 const int* __restrict__ c, const int* __restrict__ x,
                 const float* __restrict__ nt, int d, int TP,
                 float* __restrict__ dphi, float* __restrict__ dcpos,
                 double* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const bool valid = i < TP && nt[i] != 0.0f;  // warp-uniform
  float loss = 0.0f, pairs = 0.0f;
  if (valid && d > 32 * KMAX) {
    // a lane's share of the rows would not fit its registers: the dot
    // product first (each lane's terms in the order of the form below),
    // then the rows re-read from L2 for the two updates
    const float* pr = emb_in + (size_t)c[i] * d;
    const float* cr = emb_out + (size_t)x[i] * d;
    float p = 0.0f;
    for (int k = lane; k < d; k += 32)
      p = fmaf(__ldcg(pr + k), __ldcg(cr + k), p);
    const float s = warp_sum(p);
    const float g = sigmoid_f(s) - 1.0f;
    if (lane == 0) {
      loss = -log_sigmoid_f(s);
      pairs = 1.0f;
    }
    for (int k = lane; k < d; k += 32) {
      dphi[(size_t)i * d + k] = g * __ldcg(cr + k);
      dcpos[(size_t)i * d + k] = g * __ldcg(pr + k);
    }
  } else if (valid) {
    const float* pr = emb_in + (size_t)c[i] * d;
    const float* cr = emb_out + (size_t)x[i] * d;
    float ph[KMAX], cp[KMAX], p = 0.0f;
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      const int k = lane + 32 * q;
      ph[q] = cp[q] = 0.0f;
      if (k < d) {
        ph[q] = __ldcg(pr + k);
        cp[q] = __ldcg(cr + k);
        p = fmaf(ph[q], cp[q], p);
      }
    }
    const float s = warp_sum(p);
    const float g = sigmoid_f(s) - 1.0f;
    if (lane == 0) {
      loss = -log_sigmoid_f(s);
      pairs = 1.0f;
    }
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      const int k = lane + 32 * q;
      if (k < d) {
        dphi[(size_t)i * d + k] = g * cp[q];
        dcpos[(size_t)i * d + k] = g * ph[q];
      }
    }
  }
  block_add(loss, &stats[0]);
  block_add(pairs, &stats[1]);
  pdl_wait();
}

// emb_in[c[i]] -= lr*(dphi[i] + dphin[i]), emb_out[x[i]] -= lr*dcpos[i] for
// the tile's valid pairs (the positive and the negative part of dphi add
// once here, as the plain version adds them), then dphin[i] = 0 for the
// next tile's negative pass.  One warp per pair, grid ceil(TP / 8), block
// THREADS.  PDL: ids and nt before the wait; dphi, dphin, dcpos and the
// tables after.
static __global__ void __launch_bounds__(THREADS)
fused_scatter_kernel(float* emb_in, float* emb_out, const int* __restrict__ c,
                     const int* __restrict__ x,
                     const float* __restrict__ dphi,
                     float* __restrict__ dphin,
                     const float* __restrict__ dcpos,
                     const float* __restrict__ nt, int d, int TP, float lr) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const bool valid = i < TP && nt[i] != 0.0f;
  size_t ci = 0, xi = 0;
  if (valid) {
    ci = (size_t)c[i] * d;
    xi = (size_t)x[i] * d;
  }
  const size_t src = (size_t)i * d;
  pdl_wait();
  if (valid) {
    if (d % 4 == 0) {
      for (int k = 4 * lane; k < d; k += 128) {
        const float4 a = load4(dphi + src + k), b = load4(dphin + src + k),
                     e = load4(dcpos + src + k);
        atomicAdd(reinterpret_cast<float4*>(emb_in + ci + k),
                  make_float4(-lr * (a.x + b.x), -lr * (a.y + b.y),
                              -lr * (a.z + b.z), -lr * (a.w + b.w)));
        atomicAdd(reinterpret_cast<float4*>(emb_out + xi + k),
                  make_float4(-lr * e.x, -lr * e.y, -lr * e.z, -lr * e.w));
        *reinterpret_cast<float4*>(dphin + src + k) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        atomicAdd(&emb_in[ci + k], -lr * (dphi[src + k] + dphin[src + k]));
        atomicAdd(&emb_out[xi + k], -lr * dcpos[src + k]);
        dphin[src + k] = 0.0f;
      }
    }
  }
  pdl_trigger();
}

// The step's last kernel: table[pool[k]] -= lr * dneg[k] (atomic: a pool
// may repeat a row), and block 0 writes the step's (loss, pairs) as f32 to
// out.  grid KP, block 128.  PDL: everything after the wait (with no tile
// the stage kernel that writes pool is the one just before it).
static __global__ void fused_apply_kernel(float* table,
                                          const int* __restrict__ pool,
                                          const float* __restrict__ dneg,
                                          const double* __restrict__ stats,
                                          float* __restrict__ out, int d,
                                          float lr) {
  const int k = blockIdx.x;
  pdl_wait();
  const size_t dst = (size_t)pool[k] * d, src = (size_t)k * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    atomicAdd(&table[dst + j], -lr * dneg[src + j]);
  if (k == 0 && threadIdx.x < 2) out[threadIdx.x] = (float)stats[threadIdx.x];
}

// The caller's inputs of one micro-step: P pairs (c, x int32, or int64
// when ids_wide; m f32) and the pool (int32, or int64 when pool_wide).
struct FusedInputs {
  const void* c;
  const void* x;
  const float* m;
  const void* pool;
  int P, ids_wide, pool_wide;
};

// The tile loop of one micro-step, launched on `stream` (the recording
// stream).  ids, nt and pool are the plan's buffers (fused_stage_kernel).
static int fused_tiles(const NegSetup& ns, float* emb_in, float* emb_out,
                       const FusedInputs& in, int* ids, float* nt, int* pool,
                       double* stats, float* out, float* cneg, float* dneg,
                       float* dphi, float* dcpos, int d, int n_tiles, int TP,
                       int KP, float lr, float negw, cudaStream_t stream) {
  const int TPr = (TP + BLK - 1) / BLK * BLK;
  NegativePass<false, float> neg;
  static_cast<NegSetup&>(neg) = ns;
  float* dphin = dphi + (size_t)TPr * d;  // the negative pass's part
  const size_t n = (size_t)n_tiles * TP, row = n + BLK;
  const int *c = ids, *x = ids + row;
  const dim3 pairs((TP + NWARPS - 1) / NWARPS);
  cudaError_t e = launch_kernel(
      fused_stage_kernel, dim3(KP + TPr / 8 + (unsigned)((n + 127) / 128)),
      dim3(128), 0, stream, false, 0, (const float*)emb_out, in.pool,
      (bool)in.pool_wide, in.c, in.x, (bool)in.ids_wide, in.m, in.P, ids, nt,
      pool, cneg, dneg, dphin, d, KP, n_tiles, TP);
  if (e != cudaSuccess) return (int)e;
  for (int t = 0; t < n_tiles; ++t) {
    const int *ct = c + (size_t)t * TP, *xt = x + (size_t)t * TP;
    const float* ntt = nt + (size_t)t * TPr;
    // tile 0's negative pass reads its slot ids, which the stage kernel
    // just before it writes, before its wait: it launches without PDL
    e = neg.launch(emb_in, ct, ntt, cneg, d, KP, negw, dphin, dneg, stats,
                   stream, t > 0);
    if (e != cudaSuccess) return (int)e;
    e = launch_kernel(fused_pos_kernel, pairs, dim3(THREADS), 0, stream, true,
                      0, (const float*)emb_in, (const float*)emb_out, ct, xt,
                      ntt, d, TP, dphi, dcpos, stats);
    if (e != cudaSuccess) return (int)e;
    e = launch_kernel(fused_scatter_kernel, pairs, dim3(THREADS), 0, stream,
                      true, 0, emb_in, emb_out, ct, xt, (const float*)dphi,
                      dphin, (const float*)dcpos, ntt, d, TP, lr);
    if (e != cudaSuccess) return (int)e;
  }
  e = launch_kernel(fused_apply_kernel, dim3(KP), dim3(128), 0, stream, true,
                    0, emb_out, (const int*)pool, (const float*)dneg,
                    (const double*)stats, out, d, lr);
  return (int)e;
}

// One micro-step: checks the shapes, sizes the negative pass at the plan's
// first step, then records the step and replays it (step_graph.cuh).
static int fused_step(StepGraph* p, int instantiate, float* emb_in,
                      float* emb_out, const FusedInputs& in, int* ids,
                      float* nt, int* pool, double* stats, float* out,
                      float* cneg, float* dneg, float* dphi, float* dcpos,
                      int d, int n_tiles, int TP, int KP, float lr,
                      float negw, cudaStream_t stream) {
  if (p == nullptr || d < 1 || n_tiles < 0 || TP < 1 ||
      KP < 1 || in.P < 0 || in.P > (long long)n_tiles * TP ||
      in.P <= (long long)(n_tiles - 1) * TP)
    return (int)cudaErrorInvalidValue;
  if (p->mode < 0) {
    NegativePass<false, float> neg;
    const cudaError_t e = neg.init(d, KP, (TP + BLK - 1) / BLK * BLK);
    if (e != cudaSuccess) return (int)e;
    p->neg = neg;
    p->mode = 0;
  }
  return replay_step(p, instantiate, stream, [&](cudaStream_t cap) {
    return fused_tiles(p->neg, emb_in, emb_out, in, ids, nt, pool, stats,
                       out, cneg, dneg, dphi, dcpos, d, n_tiles, TP, KP, lr,
                       negw, cap);
  });
}

}  // namespace come

using namespace come;

// K6: one O1 micro-step of P pairs in n_tiles tiles of TP, recorded into
// the plan's graph slot `graph` (come_step_graph_new) and replayed on
// `stream`: instantiate != 0 at the plan's first step, 0 at every later
// one.  All buffers are device pointers:
//   emb_in, emb_out  [V, d] f32 (updated in place)
//   c, x       [P] the call's pair ends, int32 or (ids_wide) int64
//   m          [P] f32 mask (valid = m != 0);  pool_in [KP] int32 or
//              (pool_wide) int64
//   ids        [3, n_tiles * TP + 128] i32, nt [n_tiles, TPr] f32 (TPr =
//              ceil(TP / 128) * 128; rows TP.. and the extra 128 ids 0),
//              pool [KP] i32: the plan's buffers, which the step's first
//              kernel fills from the call's
//   stats      [2] f64, accumulates (loss, pairs), zeroed by the caller
//   out        [2] f32, the step's (loss, pairs)
//   cneg, dneg [KP, d] f32 scratch
//   dphi       [2, TPr, d] f32 scratch: the positive part of each pair's
//              centre update, then the negative pass's
//   dcpos      [TPr, d] f32 scratch
// P must lie in ((n_tiles - 1) * TP, n_tiles * TP] (or be 0 with n_tiles
// 0).  A plan serves one (d, TP, KP, n_tiles).  Returns 0 or the first CUDA
// error code.  Enqueues only: it does not synchronise and allocates no
// device memory.
extern "C" int come_fused_sgns_step(
    void* graph, int instantiate, float* emb_in, float* emb_out,
    const void* c, const void* x, const float* m, const void* pool_in, int P,
    int ids_wide, int pool_wide, int* ids, float* nt, int* pool,
    double* stats, float* out, float* cneg, float* dneg, float* dphi,
    float* dcpos, int d, int n_tiles, int TP, int KP, float lr, float negw,
    void* stream_ptr) {
  const FusedInputs in{c, x, m, pool_in, P, ids_wide, pool_wide};
  return fused_step(static_cast<StepGraph*>(graph), instantiate, emb_in,
                    emb_out, in, ids, nt, pool, stats, out, cneg, dneg, dphi,
                    dcpos, d, n_tiles, TP, KP, lr, negw,
                    (cudaStream_t)stream_ptr);
}

// K7: K6 on one tied table emb [V, d] (both pair ends and the pool).
extern "C" int come_fused_sgns_step_tied(
    void* graph, int instantiate, float* emb, const void* c, const void* x,
    const float* m, const void* pool_in, int P, int ids_wide, int pool_wide,
    int* ids, float* nt, int* pool, double* stats, float* out, float* cneg,
    float* dneg, float* dphi, float* dcpos, int d, int n_tiles, int TP,
    int KP, float lr, float negw, void* stream_ptr) {
  const FusedInputs in{c, x, m, pool_in, P, ids_wide, pool_wide};
  return fused_step(static_cast<StepGraph*>(graph), instantiate, emb, emb,
                    in, ids, nt, pool, stats, out, cneg, dneg, dphi, dcpos,
                    d, n_tiles, TP, KP, lr, negw, (cudaStream_t)stream_ptr);
}
