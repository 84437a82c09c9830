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
//     pallas_call with a grid over the tiles: the plan records the tile
//     loop once as a CUDA graph on its private stream, and a call sets the
//     head (stage) kernel's parameters and replays it on the caller's
//     stream (step_graph.cuh), every kernel after tile 0's negative pass
//     under programmatic dependent launch (PDL, sgns_common.cuh: that pass
//     reads its slot ids before its wait, and the first kernel packs them);
//   * a macro batch of micro-steps is one launch, the port of the JAX
//     trainer's lax.scan over them (come_tpu/trainer/come.py:350): a WHILE
//     graph (step_graph.cu) whose body is one micro-step recorded once,
//     its stage kernel reading micro-step `it`'s pairs and pool from the
//     argument block and its apply kernel adding the step's (loss, pairs)
//     to the block's total and advancing `it`;
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
//   * any d: past 192 the negative pass is its wide kernel (sgns_common.cuh:
//     NEG_WHOLE), and past 256 the positive pass loops over a lane's
//     columns instead of holding them in registers.
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

// What a call changes: the stage kernel's per-call parameters (set on the
// recorded graph's head node at every call, step_graph.cuh).  P pairs (c,
// x int32, or int64 when ids_wide; m f32), the pool (int32, or int64 when
// pool_wide), lr and where the step's (loss, pairs) go.
struct FusedIn {
  const void* c;
  const void* x;
  const float* m;
  const void* pool;
  int P, ids_wide, pool_wide;
  float lr;
  float* out;
};

// The plan's buffers and shape (ops/launch_plan.py::FusedPlan); `scan`: the
// stage kernel takes micro-step args->it of the macro batch in the
// argument block instead of its FusedIn.
struct FusedBufs {
  const float* table;  // emb_out: the pool's rows
  int* ids;
  float* nt;
  int* pool;
  float* cneg;
  float* dneg;
  float* dphin;
  double* stats;
  StepArgs* args;
  int d, KP, n_tiles, TP, scan;
};

// The step's first kernel (launched without PDL), in three block ranges:
//   * k < KP: pool[k] = the caller's pool id k, cneg[k] = emb_out[pool[k]],
//     dneg[k] = 0 (the pool staged once);
//   * the next TPr / 8: zero the negative pass's part of dphi, 8 rows each;
//   * the rest, a pair each thread: the call's P pairs packed into the
//     plan's buffers as ops/launch_plan.py::FusedPlan.pack packs them: ids
//     [3, n_tiles * TP + 128] i32 (centres, contexts, mask != 0; zero past
//     P) and nt [n_tiles, TPr] f32 (pair j of tile t at t * TPr + j; rows
//     TP.. stay 0, and so do the 128 extra ids).
// Block 0 zeroes stats and (not in a scan) writes lr and out into the
// argument block and zeroes its total.  In a scan the inputs are micro-step
// it's: c, x, m + it * P, pools + it * KP.
// grid KP + TPr / 8 + ceil(n_tiles * TP / 128), block 128.
static __global__ void fused_stage_kernel(FusedIn in, FusedBufs b) {
  const int d = b.d, KP = b.KP, TP = b.TP;
  const int TPr = (TP + BLK - 1) / BLK * BLK;
  const int k = blockIdx.x, zb = KP + TPr / 8;
  if (b.scan) {
    const StepArgs* a = b.args;
    const size_t it = (size_t)step_ld(&a->it);
    in.P = step_ld(&a->P);
    in.ids_wide = step_ld(&a->ids_wide);
    in.pool_wide = step_ld(&a->pool_wide);
    const size_t e = in.ids_wide ? 8 : 4, off = it * (size_t)in.P;
    in.c = static_cast<const char*>(step_ld(&a->c)) + off * e;
    in.x = static_cast<const char*>(step_ld(&a->x)) + off * e;
    in.m = step_ld(&a->m) + off;
    in.pool = static_cast<const char*>(step_ld(&a->pools)) +
              it * KP * (in.pool_wide ? 8 : 4);
  } else if (k == 0 && threadIdx.x == 0) {
    b.args->lr = in.lr;
    b.args->out = in.out;
    b.args->total[0] = 0.0;
    b.args->total[1] = 0.0;
  }
  if (k == 0 && threadIdx.x == 0) {
    b.stats[0] = 0.0;
    b.stats[1] = 0.0;
  }
  if (k < KP) {
    const int v = id_at(in.pool, in.pool_wide, k);
    if (threadIdx.x == 0) b.pool[k] = v;
    const size_t src = (size_t)v * d, dst = (size_t)k * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      b.cneg[dst + j] = step_ld(b.table + src + j);
      b.dneg[dst + j] = 0.0f;
    }
  } else if (k < zb) {
    float* rows = b.dphin + (size_t)(k - KP) * 8 * d;
    for (int j = threadIdx.x; j < 8 * d; j += blockDim.x) rows[j] = 0.0f;
  } else {
    const size_t n = (size_t)b.n_tiles * TP, row = n + BLK;
    const size_t j = (size_t)(k - zb) * blockDim.x + threadIdx.x;
    if (j < n) {
      const bool inb = j < (size_t)in.P;
      const bool valid = inb && in.m[j] != 0.0f;
      b.ids[j] = inb ? id_at(in.c, in.ids_wide, j) : 0;
      b.ids[row + j] = inb ? id_at(in.x, in.ids_wide, j) : 0;
      b.ids[2 * row + j] = valid;
      b.nt[(j / TP) * TPr + j % TP] = valid ? 1.0f : 0.0f;
    }
  }
  pdl_trigger();
}

// The scan's entry, launched on the caller's stream just before its WHILE
// graph (one thread): the macro batch's inputs, micro-step count and lr,
// and where its (loss, pairs) go, into the argument block; it = 0, the
// total zeroed.
static __global__ void fused_scan_entry_kernel(StepArgs* a, FusedIn in,
                                               int n_micro) {
  a->lr = in.lr;
  a->out = in.out;
  a->c = in.c;
  a->x = in.x;
  a->m = in.m;
  a->pools = in.pool;
  a->P = in.P;
  a->ids_wide = in.ids_wide;
  a->pool_wide = in.pool_wide;
  a->n_micro = n_micro;
  a->it = 0;
  a->go = true;
  a->total[0] = 0.0;
  a->total[1] = 0.0;
}

// Positive term of one tile, one warp per pair i < TP (grid ceil(TP / 8),
// block THREADS): dphi[i] = g cpos, dcpos[i] = g phi for the valid pairs
// (nt[i] != 0), and the positive loss and the pair count added to stats.
// Each lane keeps its columns lane + 32 q of both rows in registers up to
// d = 32 * KMAX (256), and loops over them past it.
// PDL: it runs after the tile's negative pass, and all its work comes
// before its wait: what it reads (ids, nt, the table rows the last scatter
// wrote, all through step_ld) no kernel still running writes, and what it
// writes (dphi, dcpos, stats by atomics) the running negative pass does not
// touch, the scatter that read them last being complete (sgns_common.cuh's
// note).  It waits only to exit, so the scatter after it starts once the
// negative pass is complete.
static __global__ void __launch_bounds__(THREADS)
fused_pos_kernel(const float* emb_in, const float* emb_out, const int* c,
                 const int* x, const float* nt, int d, int TP,
                 float* __restrict__ dphi, float* __restrict__ dcpos,
                 double* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const bool valid = i < TP && step_ld(nt + i) != 0.0f;  // warp-uniform
  float loss = 0.0f, pairs = 0.0f;
  if (valid && d > 32 * KMAX) {
    // a lane's share of the rows would not fit its registers: the dot
    // product first (each lane's terms in the order of the form below),
    // then the rows re-read for the two updates
    const float* pr = emb_in + (size_t)step_ld(c + i) * d;
    const float* cr = emb_out + (size_t)step_ld(x + i) * d;
    float p = 0.0f;
    for (int k = lane; k < d; k += 32)
      p = fmaf(step_ld(pr + k), step_ld(cr + k), p);
    const float s = warp_sum(p);
    const float g = sigmoid_f(s) - 1.0f;
    if (lane == 0) {
      loss = -log_sigmoid_f(s);
      pairs = 1.0f;
    }
    for (int k = lane; k < d; k += 32) {
      dphi[(size_t)i * d + k] = g * step_ld(cr + k);
      dcpos[(size_t)i * d + k] = g * step_ld(pr + k);
    }
  } else if (valid) {
    const float* pr = emb_in + (size_t)step_ld(c + i) * d;
    const float* cr = emb_out + (size_t)step_ld(x + i) * d;
    float ph[KMAX], cp[KMAX], p = 0.0f;
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      const int k = lane + 32 * q;
      ph[q] = cp[q] = 0.0f;
      if (k < d) {
        ph[q] = step_ld(pr + k);
        cp[q] = step_ld(cr + k);
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
// THREADS.  PDL: ids, nt and lr (the stage kernel's, complete) before the
// wait; dphi, dphin, dcpos and the tables after.
static __global__ void __launch_bounds__(THREADS)
fused_scatter_kernel(float* emb_in, float* emb_out, const int* c,
                     const int* x, const float* dphi, float* dphin,
                     const float* dcpos, const float* nt, int d, int TP,
                     const StepArgs* args) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const bool valid = i < TP && step_ld(nt + i) != 0.0f;
  size_t ci = 0, xi = 0;
  if (valid) {
    ci = (size_t)step_ld(c + i) * d;
    xi = (size_t)step_ld(x + i) * d;
  }
  const size_t src = (size_t)i * d;
  const float lr = step_ld(&args->lr);
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
        atomicAdd(&emb_in[ci + k],
                  -lr * (step_ld(dphi + src + k) + step_ld(dphin + src + k)));
        atomicAdd(&emb_out[xi + k], -lr * step_ld(dcpos + src + k));
        dphin[src + k] = 0.0f;
      }
    }
  }
  pdl_trigger();
}

// The step's last kernel: table[pool[k]] -= lr * dneg[k] (atomic: a pool
// may repeat a row), and block 0 adds the step's (loss, pairs) to the
// argument block's total, writes the total as f32 to its `out` and
// advances `it` (the scan's micro-step).  grid KP, block 128.  PDL:
// everything after the wait (with no tile the stage kernel that writes
// pool is the one just before it).
static __global__ void fused_apply_kernel(float* table, const int* pool,
                                          const float* dneg,
                                          const double* stats,
                                          StepArgs* args, int d) {
  const int k = blockIdx.x;
  pdl_wait();
  const float lr = step_ld(&args->lr);
  const size_t dst = (size_t)step_ld(pool + k) * d, src = (size_t)k * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    atomicAdd(&table[dst + j], -lr * step_ld(dneg + src + j));
  if (k == 0 && threadIdx.x == 0) {
    const double loss = step_ld(&args->total[0]) + step_ld(stats);
    const double pairs = step_ld(&args->total[1]) + step_ld(stats + 1);
    args->total[0] = loss;
    args->total[1] = pairs;
    float* out = step_ld(&args->out);
    out[0] = (float)loss;
    out[1] = (float)pairs;
    args->it = step_ld(&args->it) + 1;
  }
}

// The tile loop of one micro-step, launched on `stream` (the recording
// stream): the stage kernel with `in` (the call's, or with b.scan
// micro-step it's), then each tile's passes, then the apply kernel.
static int fused_tiles(const NegSetup& ns, float* emb_in, float* emb_out,
                       const FusedIn& in, const FusedBufs& b, float* dphi,
                       float* dcpos, float negw, cudaStream_t stream) {
  const int d = b.d, TP = b.TP, KP = b.KP;
  const int TPr = (TP + BLK - 1) / BLK * BLK;
  NegativePass<false, float> neg;
  static_cast<NegSetup&>(neg) = ns;
  const size_t n = (size_t)b.n_tiles * TP, row = n + BLK;
  const int *c = b.ids, *x = b.ids + row;
  const dim3 pairs((TP + NWARPS - 1) / NWARPS);
  cudaError_t e = launch_kernel(
      fused_stage_kernel, dim3(KP + TPr / 8 + (unsigned)((n + 127) / 128)),
      dim3(128), 0, stream, false, 0, in, b);
  if (e != cudaSuccess) return (int)e;
  for (int t = 0; t < b.n_tiles; ++t) {
    const int *ct = c + (size_t)t * TP, *xt = x + (size_t)t * TP;
    const float* ntt = b.nt + (size_t)t * TPr;
    // tile 0's negative pass reads its slot ids, which the stage kernel
    // just before it writes, before its wait: it launches without PDL
    e = neg.launch(emb_in, ct, ntt, b.cneg, d, KP, negw, b.dphin, b.dneg,
                   b.stats, stream, t > 0);
    if (e != cudaSuccess) return (int)e;
    e = launch_kernel(fused_pos_kernel, pairs, dim3(THREADS), 0, stream, true,
                      0, (const float*)emb_in, (const float*)emb_out, ct, xt,
                      ntt, d, TP, dphi, dcpos, b.stats);
    if (e != cudaSuccess) return (int)e;
    e = launch_kernel(fused_scatter_kernel, pairs, dim3(THREADS), 0, stream,
                      true, 0, emb_in, emb_out, ct, xt, (const float*)dphi,
                      b.dphin, (const float*)dcpos, ntt, d, TP,
                      (const StepArgs*)b.args);
    if (e != cudaSuccess) return (int)e;
  }
  e = launch_kernel(fused_apply_kernel, dim3(KP), dim3(128), 0, stream, true,
                    0, emb_out, (const int*)b.pool, (const float*)b.dneg,
                    (const double*)b.stats, b.args, d);
  return (int)e;
}

// Checks a plan's shape and sizes its negative pass at its first use.
static int fused_setup(StepGraph* p, const FusedBufs& b) {
  if (p == nullptr || b.d < 1 || b.n_tiles < 0 || b.TP < 1 || b.KP < 1)
    return (int)cudaErrorInvalidValue;
  if (p->mode < 0) {
    NegativePass<false, float> neg;
    const cudaError_t e = neg.init(b.d, b.KP, (b.TP + BLK - 1) / BLK * BLK);
    if (e != cudaSuccess) return (int)e;
    p->neg = neg;
    p->mode = b.scan;
  } else if (p->mode != b.scan) {
    return (int)cudaErrorInvalidValue;  // a slot serves one kind of plan
  }
  return 0;
}

static bool fused_pairs_fit(int P, const FusedBufs& b) {
  return P >= 0 && P <= (long long)b.n_tiles * b.TP &&
         P > (long long)(b.n_tiles - 1) * b.TP;
}

// One micro-step: checks the shapes, sizes the negative pass at the plan's
// first step, records the step if `how` asks (step_graph.cuh), then replays
// it with this call's stage parameters.
static int fused_step(StepGraph* p, int how, float* emb_in, float* emb_out,
                      const FusedIn& in, const FusedBufs& b, float* dphi,
                      float* dcpos, float negw, cudaStream_t stream) {
  if (!fused_pairs_fit(in.P, b) || b.scan) return (int)cudaErrorInvalidValue;
  const int rc = fused_setup(p, b);
  if (rc != 0) return rc;
  return run_step(
      p, how, stream,
      [&](cudaStream_t cap) {
        return fused_tiles(p->neg, emb_in, emb_out, in, b, dphi, dcpos, negw,
                           cap);
      },
      fused_stage_kernel, in, b);
}

// A scan plan's WHILE graph (step_graph.cu): the entry sets the condition
// (it = 0 < n_micro); the body is one micro-step with b.scan set, then
// come_while_flag on (args->go, args->it, args->n_micro).  Both are
// recorded on the slot's private stream and built into `loop`.
static int fused_scan_record(StepGraph* p, void* loop,
                             unsigned long long handle, float* emb_in,
                             float* emb_out, const FusedBufs& b, float* dphi,
                             float* dcpos, float negw) {
  if (!b.scan || loop == nullptr) return (int)cudaErrorInvalidValue;
  int rc = fused_setup(p, b);
  if (rc != 0) return rc;
  StepArgs* a = b.args;
  auto flag = [&](cudaStream_t s) {
    return come_while_flag(&a->go, 1, &a->it, &a->n_micro, handle, s);
  };
  cudaGraph_t graphs[2] = {nullptr, nullptr};
  for (int k = 0; k < 2 && rc == 0; ++k) {
    cudaError_t e =
        cudaStreamBeginCapture(p->cap, cudaStreamCaptureModeThreadLocal);
    if (e != cudaSuccess) {
      rc = (int)e;
      break;
    }
    if (k == 1) {
      const FusedIn none{};
      rc = fused_tiles(p->neg, emb_in, emb_out, none, b, dphi, dcpos, negw,
                       p->cap);
    }
    if (rc == 0) rc = flag(p->cap);
    e = cudaStreamEndCapture(p->cap, &graphs[k]);
    if (rc == 0 && e != cudaSuccess) rc = (int)e;
  }
  if (rc == 0) rc = come_while_graph_build(loop, graphs[0], graphs[1]);
  for (cudaGraph_t g : graphs)
    if (g != nullptr) cudaGraphDestroy(g);
  return rc;
}

}  // namespace come

using namespace come;

// K6: one O1 micro-step of P pairs in n_tiles tiles of TP, through the
// plan's graph slot `graph` (come_step_graph_new): `record` 1 records the
// step and instantiates the slot's graph (the plan's first call), 2
// records it and updates the instance (a table moved), 0 replays it; every
// call sets the stage kernel's parameters (the pairs, the pool, lr, out)
// and launches the instance on `stream`.  All buffers are device pointers:
//   emb_in, emb_out  [V, d] f32 (updated in place)
//   c, x       [P] the call's pair ends, int32 or (ids_wide) int64
//   m          [P] f32 mask (valid = m != 0);  pool_in [KP] int32 or
//              (pool_wide) int64
//   ids        [3, n_tiles * TP + 128] i32, nt [n_tiles, TPr] f32 (TPr =
//              ceil(TP / 128) * 128; rows TP.. and the extra 128 ids 0),
//              pool [KP] i32: the plan's buffers, which the step's first
//              kernel fills from the call's
//   stats      [2] f64 scratch: the step's (loss, pairs)
//   out        [2] f32, the call's (loss, pairs)
//   cneg, dneg [KP, d] f32 scratch
//   dphi       [2, TPr, d] f32 scratch: the positive part of each pair's
//              centre update, then the negative pass's
//   dcpos      [TPr, d] f32 scratch
//   args       the plan's argument block (sgns_common.cuh: StepArgs)
// P must lie in ((n_tiles - 1) * TP, n_tiles * TP] (or be 0 with n_tiles
// 0).  A plan serves one (d, TP, KP, n_tiles); its recording holds the
// tables' addresses and negw.  Returns 0 or the first CUDA error code.
// Enqueues only: it does not synchronise and allocates no device memory.
extern "C" int come_fused_sgns_step(
    void* graph, int record, float* emb_in, float* emb_out, const void* c,
    const void* x, const float* m, const void* pool_in, int P, int ids_wide,
    int pool_wide, int* ids, float* nt, int* pool, double* stats, float* out,
    float* cneg, float* dneg, float* dphi, float* dcpos, void* args, int d,
    int n_tiles, int TP, int KP, float lr, float negw, void* stream_ptr) {
  const FusedIn in{c, x, m, pool_in, P, ids_wide, pool_wide, lr, out};
  const int TPr = (TP + BLK - 1) / BLK * BLK;
  const FusedBufs b{emb_out, ids, nt, pool, cneg, dneg,
                    dphi + (size_t)TPr * d, stats, static_cast<StepArgs*>(args),
                    d, KP, n_tiles, TP, 0};
  return fused_step(static_cast<StepGraph*>(graph), record, emb_in, emb_out,
                    in, b, dphi, dcpos, negw, (cudaStream_t)stream_ptr);
}

// K7: K6 on one tied table emb [V, d] (both pair ends and the pool).
extern "C" int come_fused_sgns_step_tied(
    void* graph, int record, float* emb, const void* c, const void* x,
    const float* m, const void* pool_in, int P, int ids_wide, int pool_wide,
    int* ids, float* nt, int* pool, double* stats, float* out, float* cneg,
    float* dneg, float* dphi, float* dcpos, void* args, int d, int n_tiles,
    int TP, int KP, float lr, float negw, void* stream_ptr) {
  return come_fused_sgns_step(graph, record, emb, emb, c, x, m, pool_in, P,
                              ids_wide, pool_wide, ids, nt, pool, stats, out,
                              cneg, dneg, dphi, dcpos, args, d, n_tiles, TP,
                              KP, lr, negw, stream_ptr);
}

// Records a K6 (tied 0) or K7 (tied 1) scan plan into the WHILE graph
// `loop` (come_while_graph_new, its condition `handle`): one micro-step of
// P pairs (P fixed by the launches) in n_tiles tiles of TP as the body,
// run while args->it < args->n_micro.  `graph` is the plan's slot (its
// recording stream and the negative pass's sizing).  Buffers as
// come_fused_sgns_step (emb_out is emb when tied).  Returns 0 or the
// first CUDA error code (cudaErrorNotSupported below CUDA 12.4).
extern "C" int come_fused_scan_record(
    void* graph, void* loop, unsigned long long handle, float* emb_in,
    float* emb_out, int* ids, float* nt, int* pool, double* stats,
    float* cneg, float* dneg, float* dphi, float* dcpos, void* args, int d,
    int n_tiles, int TP, int KP, float negw) {
  const int TPr = (TP + BLK - 1) / BLK * BLK;
  const FusedBufs b{emb_out, ids, nt, pool, cneg, dneg,
                    dphi + (size_t)TPr * d, stats, static_cast<StepArgs*>(args),
                    d, KP, n_tiles, TP, 1};
  return fused_scan_record(static_cast<StepGraph*>(graph), loop, handle,
                           emb_in, emb_out, b, dphi, dcpos, negw);
}

// Runs a macro batch through a recorded scan plan on `stream`: the entry
// kernel puts the batch into the plan's argument block `args` (n_micro
// micro-steps of P pairs: c, x [n_micro * P] int32 or (ids_wide) int64, m
// [n_micro * P] f32, pools [n_micro, KP] int32 or (pool_wide) int64; lr;
// out [2] f32, the summed (loss, pairs)), then the WHILE graph `loop` runs
// every micro-step.  P must fit the plan's tiles as in come_fused_sgns_step.
// Returns 0 or the first CUDA error code.  Enqueues only.
extern "C" int come_fused_scan_launch(void* loop, void* args, const void* c,
                                      const void* x, const float* m,
                                      const void* pools, int P, int n_micro,
                                      int ids_wide, int pool_wide, int n_tiles,
                                      int TP, float lr, float* out,
                                      void* stream_ptr) {
  FusedBufs b{};
  b.n_tiles = n_tiles;
  b.TP = TP;
  if (loop == nullptr || n_micro < 1 || !fused_pairs_fit(P, b))
    return (int)cudaErrorInvalidValue;
  const FusedIn in{c, x, m, pools, P, ids_wide, pool_wide, lr, out};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  fused_scan_entry_kernel<<<1, 1, 0, stream>>>(static_cast<StepArgs*>(args),
                                               in, n_micro);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return come_while_graph_launch(loop, stream_ptr);
}
