// Pieces shared by the two SGNS kernels (walk_sgns.cu, star_sgns.cu).
//
// Both TPU kernels end the same way: every staged slot scores all KP rows
// of a shared negative pool (weight negw * n_t, n_t = the slot's positive
// pair count), the pool is staged once per R-group block, its gradient
// accumulates over the block and is applied at the block end, and every
// slot's update is added back into its table row.  The device functions and
// kernels here are `static`, so each translation unit keeps its own copy.
//
// The negative pass computes the TPU's three dense products
// (pallas_walk_sgns.py:343-360, pallas_star_sgns.py:167-180): scores
// S = Phi . C^T of the slots against the pool, G = sigmoid(S) * negw * n_t,
// dphi += G . C and dneg += G^T . Phi.  On the card it is 3 x slots x KP x
// d multiply-adds, which bounds it (a group at KP 2048 is 1.6 GFLOP:
// 24 us at the f32 SIMT peak, 1.6 us at the bf16 tensor-core peak); its
// other cost is merging the partial sums of dphi and dneg across CTAs.
// NegativePass<BF16, T> owns each instance's grid and shared memory, so the
// callers (walk_sgns.cu, star_sgns.cu, star_probe.cu, sgns_fused.cu) only
// launch it.  Both instances share one structure: a CTA stages 64 slots'
// rows (16-byte loads, many in flight per thread) and walks several 32-row
// pool chunks, loading the next chunk's rows into registers while it
// computes the current one and keeping its dphi in registers across them,
// so the grid is (slots / 64) x (pool splits), sized to the CTAs that fit
// on the card at once (by the kernel's occupancy: 2-3 an SM); dphi is
// merged once per CTA and dneg once per chunk, by 16-byte f32 atomics.
// Past MAX_DIM both run wide kernels (negative_f32_wide_kernel,
// negative_bf16_wide_kernel; see the note at NEG_WHOLE): the tile's rows
// held in shared memory for the whole pass, the pool chunks streamed
// through a ring filled by asynchronous copies, one sweep up to NEG_WHOLE
// (256) columns, column slabs of NEG_WHOLE in two sweeps past it, and the
// bf16 products on wgmma.
//
//   * f32 (negative_f32_kernel: K1, K2, K5, K6, K7): every product and sum
//     in f32 on the SIMT units (FFMA; its checks allow no TF32).  Each of
//     the 128 threads computes a register tile of each product (scores 4 x
//     4, dphi 8 slots x 8 or 12 columns, dneg 4 pool rows x the same
//     columns) from float4 shared-memory reads, so a thread issues 10-11
//     FFMA per 16-byte read; g is kept both by slot and by pool row, so
//     every read of it is a float4 too.  A tile whose slots all have nt = 0
//     (star pads, K6's masked tail) returns at once.
//   * bf16 (negative_bf16_kernel: K1b, K4 with bf16, K2b, P3; K3 on bf16
//     tables): the TPU's mxu_bf16=True mode, where every product operand is
//     bf16 and every sum f32, which is exactly what mma.sync.m16n8k16 bf16
//     with f32 accumulation computes.  Rows and chunks are staged as bf16
//     (half the bytes) and the three products run on the tensor cores (4
//     warps of 16 rows), reading the transposed operands of dphi and dneg
//     through ldmatrix .trans instead of keeping transposed copies.  g is
//     made in f32 from the f32 score, rounded to bf16 as the TPU rounds
//     gneg, and kept in shared memory; two lanes pool their mma fragments
//     into one 16-byte atomic.
// What bounds either on the card is not its arithmetic alone but the
// latency of each chunk's steps and the merging of partial sums (PERF.md).
// The loops give the pass a dphi buffer of its own, zeroed by the positive
// pass (K6/K7: once a step, then by each scatter), and their scatter adds
// the two parts once, as the plain versions add them: partial sums added
// onto the positive part would each round at its magnitude, which on a
// heavily repeated row is far larger.
//
// K3 (bf16 tables) reads rows through to_f32 (the stage kernel and the bf16
// negative kernel are templated on the table's element type) and writes
// its slots' rows one rounded read-modify-write per slot, each element
// rounded by its own 16 random bits as the TPU's _pack_row does
// (pallas_walk_sgns.py:76-88), or truncated without them.  Neither write
// takes an atomic: one owner a row applies the row's slots in slot order
// (walk_scatter_bf16_kernel, walk_sgns.cu, on the chains slot_chains_kernel
// sorts once a step) and its pool draws in draw order
// (apply_pool_bf16_kernel, on the chains pool_chains_kernel sorts once a
// step), as the TPU's slot and pool loops do.
//
// Programmatic dependent launch (PDL).  The group loops (walk_sgns.cu,
// star_sgns.cu) and K6/K7's tile loop (sgns_fused.cu) record a step once as
// a CUDA graph (step_graph.cuh) and launch every kernel after the first
// one or two with launch_kernel(pdl = true): the card may then start a
// kernel while the one before it runs.  A kernel's pdl_wait() returns once
// the kernel just before it has completed and its writes are visible; the
// kernel after it launches once each of its CTAs has called pdl_trigger()
// or exited.  Every kernel a loop launches keeps one rule: each CTA calls
// pdl_wait() on every path before it exits, and triggers only after its
// wait has returned.  Since no CTA can trigger (or exit) before its wait
// returns, a kernel starts only once every kernel two or more places
// before it has completed, and its wait returns only once the one just
// before it has.  So what a kernel does before its wait may read only what
// the kernel just before it does not write, and write only what that
// kernel neither writes nor reads (atomic adds to stats excepted: they
// commute), and a trigger makes no write visible: only the wait does.  In the walk and star loops that is what the step's
// head kernel copied from the call (walks, window draws, pools, star slots
// and meta), complete before the third kernel starts, and K4's generated
// walks, written by the second kernel and complete before the fourth
// starts; so the kernel just after the head (and K4's walk generation)
// launches without the attribute.  In K6/K7's loop, where a tile runs
// negative -> positive -> scatter, the positive pass does all its work
// there (sgns_fused.cu); the negative passes read their slot ids before
// the wait, and K6/K7's first kernel packs those ids, so the negative pass
// after it launches without the attribute.  Every read of such a buffer,
// before the wait or after it, and of anything else an earlier kernel of
// the step writes (the tables, nt, dphi, dphin, dneg, cneg, dctx, dcpos,
// stats, the argument block), goes through step_ld (below): no kernel that
// waits takes a const __restrict__ pointer, whose loads the compiler may
// make invariant and move above the wait.  lr, the SR seed and K6/K7's
// result pointer come from the plan's argument block, which the head
// kernel writes: the kernels two or more places after it read lr and the
// seed before their wait; K6/K7's apply kernel, which may follow the
// stage kernel directly, reads lr and the result pointer after it.
// The f32 negative pass triggers right after its wait, so K6/K7's positive
// pass runs beside it; the bf16 pass triggers once its dphi is merged, the
// bf16 stage past MAX_DIM not at all (stage_pool_bf16_kernel), and the
// other kernels once their last write is issued.  Each kernel's note
// says where its wait stands.  A kernel launched without the attribute
// (the head, the kernel after it, tile 0's negative pass in K6/K7, P3's
// stream launches) starts once the kernel before it has completed, and its
// pdl_wait() returns at once.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace come {

constexpr int BLK = 128;       // slots per block (one walk / one star row)
constexpr int GROUP = 1024;    // slots per group (8 blocks), TPU order unit
constexpr int NBLK = GROUP / BLK;
constexpr int THREADS = 256;   // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int KMAX = 8;        // d <= 32 * KMAX for per-lane accumulators
constexpr int MAX_DIM = 192;   // the widest d of the passes' row-staging
                               // kernels; past it the wide or slab forms

// PDL's two sides (the note above): wait until the kernels this one depends
// on have completed and their writes are visible; let the next kernel in
// the stream launch once every CTA of this one has triggered or exited.
static __device__ __forceinline__ void pdl_wait() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

static __device__ __forceinline__ void pdl_trigger() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}

// step_ld: every read, in a kernel that runs under PDL, of a buffer that
// an earlier kernel of the step writes (the tables, nt, dphi, dphin, dneg,
// cneg, dctx, dcpos, stats, K4's generated walks, the plan's staged inputs
// and argument block).  An ordinary
// load through a pointer that is not const __restrict__: such a load is
// never invariant, so the compiler keeps it after pdl_wait()'s memory
// clobber, and the wait makes the kernel before's writes visible to it.  A
// load through a const __restrict__ pointer may be compiled as an invariant
// (non-coherent) load, which the compiler is free to move above the wait;
// no kernel that calls pdl_wait() takes one (tests/test_torch_pdl_loads.py
// holds both over csrc/).  An L2-only form (ld.global.cg as volatile asm)
// measured 4.3 µs slower a K3 group in the bf16 negative pass, whose CTAs
// share the pool chunks through L1 (PERF.md §6).
template <typename T>
static __device__ __forceinline__ T step_ld(const T* p) {
  return *p;
}

// A recorded step's argument block (ops/launch_plan.py: a plan's `args`,
// 128 bytes of device memory): what a call changes besides its input
// arrays.  The step's head kernel, the one graph node whose parameters a
// call sets (step_graph.cuh), writes lr, seed and out from its parameters;
// every later kernel reads them after its wait, through step_ld.  K6/K7's
// scan (sgns_fused.cu) also keeps here the macro batch's inputs, its
// micro-step count, the running micro-step and the summed (loss, pairs).
struct StepArgs {
  float lr;
  unsigned seed;  // K3's stochastic-rounding seed
  int it;         // the scan: the micro-step running
  int n_micro;    // the scan: micro-steps in the macro batch
  float* out;     // K6/K7: the call's (loss, pairs) as f32
  const void* c;  // the scan: the macro batch's pairs, mask and pools
  const void* x;
  const float* m;
  const void* pools;
  int P, ids_wide, pool_wide;  // the scan: pairs a micro-step, id widths
  bool go;                     // the scan: come_while_flag's flag (true)
  double total[2];  // K6/K7: (loss, pairs) summed over the call's steps
};
static_assert(sizeof(StepArgs) <= 128, "a plan's argument block");

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static __device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// x rounded to the nearest bf16 (ties to even) and widened back: the TPU's
// cast of a product operand to mxu_t when BF16, x itself otherwise.
template <bool BF16>
static __device__ __forceinline__ float mxu(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

static __device__ __forceinline__ float to_f32(float x) { return x; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A bijective 32-bit hash; ops/walk_sgns.py::mix32 bit for bit.
static __device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  return x ^ (x >> 16);
}

// The stochastic-rounding key of one group of one step
// (ops/walk_sgns.py::sr_key); sr_bits(key, counter) = mix32(counter ^ key).
static __device__ __forceinline__ unsigned sr_key(unsigned seed, unsigned g) {
  return mix32(seed ^ mix32(g));
}

// log(sigmoid(x)) without overflow: min(x, 0) - log1p(exp(-|x|))
static __device__ __forceinline__ float log_sigmoid_f(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// Sum `v` over the CTA (all NT threads must call) and add the total to
// `*dst` from thread 0.
template <int NT = THREADS>
static __device__ void block_add(float v, double* dst) {
  __shared__ float part[NT / 32];
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < NT / 32; ++w) s += part[w];
    atomicAdd(dst, s);
  }
  __syncthreads();
}

// Elements c..c+3 of a row widened to f32: one 16-byte load of f32, one
// 8-byte load of bf16 (c and the row's start a multiple of 4 elements),
// through step_ld: every row the passes load is one the step writes.
static __device__ __forceinline__ float4 load4(const float* p) {
  return step_ld(reinterpret_cast<const float4*>(p));
}
static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = step_ld(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Row staging: nrows rows of width d, padded with zeros to dp (a multiple
// of 4), move as a grid of nrows x dp/4 four-element pieces.  load_batch
// reads this thread's pieces b, b + NT, ..., b + (U-1) NT into v, from
// row(i) (a T pointer, or nullptr for a row of zeros; vector loads when
// d % 4 == 0), all loads in flight together; store_batch hands them to
// store(i, c, v) (elements c..c+3 of row i).
// `vec` says the rows allow 16-byte loads (d % 4 == 0 where the row pointers
// are whole rows; a column slab's pointers need the table's d % 4 == 0).
template <int NT, int U, typename T, typename Row>
static __device__ __forceinline__ void load_batch(float4 (&v)[U], int b,
                                                  int nrows, int d, int dp,
                                                  Row row, bool vec) {
  const int n4 = dp / 4;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int idx = b + NT * u, i = idx / n4, c = 4 * (idx - i * n4);
    v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const T* p = idx < nrows * n4 ? row(i) : nullptr;
    if (p == nullptr || c >= d) continue;
    if (vec) {
      v[u] = load4(p + c);
    } else {
      v[u].x = to_f32(step_ld(p + c));
      if (c + 1 < d) v[u].y = to_f32(step_ld(p + c + 1));
      if (c + 2 < d) v[u].z = to_f32(step_ld(p + c + 2));
      if (c + 3 < d) v[u].w = to_f32(step_ld(p + c + 3));
    }
  }
}

template <int NT, int U, typename T, typename Row>
static __device__ __forceinline__ void load_batch(float4 (&v)[U], int b,
                                                  int nrows, int d, int dp,
                                                  Row row) {
  load_batch<NT, U, T>(v, b, nrows, d, dp, row, d % 4 == 0);
}

template <int NT, int U, typename Store>
static __device__ __forceinline__ void store_batch(const float4 (&v)[U], int b,
                                                   int nrows, int dp,
                                                   Store store) {
  const int n4 = dp / 4;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int idx = b + NT * u, i = idx / n4;
    if (idx < nrows * n4) store(i, 4 * (idx - i * n4), v[u]);
  }
}

// All nrows rows, U pieces in flight per thread at a time.
template <int NT, int U, typename T, typename Row, typename Store>
static __device__ __forceinline__ void stage_rows(int nrows, int d, int dp,
                                                  Row row, Store store,
                                                  bool vec) {
  for (int b = threadIdx.x; b < nrows * (dp / 4); b += NT * U) {
    float4 v[U];
    load_batch<NT, U, T>(v, b, nrows, d, dp, row, vec);
    store_batch<NT, U>(v, b, nrows, dp, store);
  }
}

template <int NT, int U, typename T, typename Row, typename Store>
static __device__ __forceinline__ void stage_rows(int nrows, int d, int dp,
                                                  Row row, Store store) {
  stage_rows<NT, U, T>(nrows, d, dp, row, store, d % 4 == 0);
}

// y += g * x, element by element.
static __device__ __forceinline__ void fma4(float g, float4 x, float4& y) {
  y.x = fmaf(g, x.x, y.x);
  y.y = fmaf(g, x.y, y.y);
  y.z = fmaf(g, x.z, y.z);
  y.w = fmaf(g, x.w, y.w);
}

// row[c..c+3] = v, or its elements below d (c < d, a multiple of 4): one
// 16-byte store when d % 4 == 0.
static __device__ __forceinline__ void store4(float* row, int d, int c,
                                              float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(row + c) = v;
    return;
  }
  row[c] = v.x;
  if (c + 1 < d) row[c + 1] = v.y;
  if (c + 2 < d) row[c + 2] = v.z;
  if (c + 3 < d) row[c + 3] = v.w;
}

static __device__ __forceinline__ void store4(float* row, int d, int c,
                                              float4 v) {
  store4(row, d, c, v, d % 4 == 0);
}

// row[c..c+3] += v atomically, as store4 writes: one 16-byte atomic when
// d % 4 == 0.
static __device__ __forceinline__ void atomic_add4(float* row, int d, int c,
                                                   float4 v, bool vec) {
  if (vec) {
    atomicAdd(reinterpret_cast<float4*>(row + c), v);
    return;
  }
  atomicAdd(row + c, v.x);
  if (c + 1 < d) atomicAdd(row + c + 1, v.y);
  if (c + 2 < d) atomicAdd(row + c + 2, v.z);
  if (c + 3 < d) atomicAdd(row + c + 3, v.w);
}

static __device__ __forceinline__ void atomic_add4(float* row, int d, int c,
                                                   float4 v) {
  atomic_add4(row, d, c, v, d % 4 == 0);
}

// Past MAX_DIM the band and star passes hold their whole rows in shared
// memory for the pass where they fit in POS_WIDE_SMEM (walk_pos_wide_kernel,
// star_pos_wide_kernel: one sweep, rows by asynchronous copies; bf16 rows
// where the pass rounds them), and take column slabs where they do not.
// The route of a pass is one of:
enum PosRoute {
  POS_ROWS = 0,   // d <= MAX_DIM: walk_pos_kernel, star_pos_kernel
  POS_WHOLE = 1,  // whole rows past MAX_DIM: the *_wide_kernel forms
  POS_SLAB = 2,   // column slabs: the *_slab_kernel forms
};
// the most dynamic shared memory a band or star CTA takes: the H100's
// 227 KB opt-in a block, less 3 KB for the kernels' static shared memory
// (the star passes' StarRow and g2, 2.1 KB)
constexpr size_t POS_WIDE_SMEM = 232448 - 3072;

// A row the wide band and star passes hold: bf16 where the pass rounds
// its rows, else f32; d elements to a 16-byte piece, and 16 bytes more.
static __host__ __device__ inline int pos_wide_stride(int d, bool bf16) {
  return bf16 ? ((d + 7) & ~7) + 8 : ((d + 3) & ~3) + 4;
}

// Column slabs.  Past MAX_DIM the band and star passes, f32 and bf16,
// whose whole rows would not fit in POS_WIDE_SMEM, stage their rows SLAB
// columns at a time: a row pointer then
// points at the slab's first column, d is the slab's width w (the last slab
// may be narrower), and 16-byte accesses need the table's d % 4 == 0
// (`vec`), not w's.  Each pass sweeps the slabs twice: once to sum every
// dot product's slab parts (sweep A), then, with the coefficients made
// from the sums, once more to form each slab's part of the updates (sweep
// B), re-reading the rows from L2.  The negative passes hold rows whole up
// to NEG_WHOLE (256) columns in one sweep, and take slabs of NEG_WHOLE
// past it (the note at NEG_WHOLE).
constexpr int SLAB = 128;
// a staged slab row's floats: 16-byte aligned, rows 4 banks apart
constexpr int SLAB_STRIDE = SLAB + 4;

// (s0, w, wp) of slab number k: its first column, width, width to a float4.
struct Slab {
  int s0, w, wp;
  __device__ Slab(int k, int d)
      : s0(k * SLAB), w(min(SLAB, d - k * SLAB)), wp((w + 3) & ~3) {}
};

static __host__ __device__ inline int n_slabs(int d) {
  return (d + SLAB - 1) / SLAB;
}

// The pool stage (pallas_walk_sgns.py:216 _stage_pool, inside the walk
// kernel, and the star kernel's): cneg[k] = table[pool[k]] widened to f32
// and dneg[k] = 0 for the KP rows of an R-block's pool.  It moves KP rows
// in and 2 KP f32 rows out (K3: 0.5 MiB in, 2 MiB out at KP 2048, d 128;
// 0.78 us at 3.35 TB/s), so what bounds it on the card is the latency of
// its loads and of the launch under PDL, not their bytes.  A team of `ts`
// lanes (16 for rows of at most 16 pieces: a bf16 row of 128, two rows a
// warp; else a warp) takes one row, so the grid is KP rows' teams
// (stage_setup; 256 CTAs at K3's KP 2048, fewer than fit on the card at
// once): its row's id is read before the wait, and a lane moves 16-byte
// pieces (4 f32 or 8 bf16 elements; one element where the row is not a
// whole number of pieces), STAGE_U pieces' loads in flight before any of
// their stores, so every row of a launch is in flight at once.  (Staging
// a CTA's ids in shared memory first, one coalesced load and a barrier,
// read 0.4 µs slower a group: PERF.md §6.)  It writes exactly what the
// one-CTA-a-row kernel it replaced wrote.  block STAGE_THREADS.  PDL: the
// pool ids (the call's, staged by the head kernel, two or more kernels
// before) before the wait; the table rows (the last scatter's or pool
// write's) and cneg/dneg (the last block's passes) after.
constexpr int STAGE_THREADS = 128;
constexpr int STAGE_U = 4;  // pieces of a row a lane loads before it stores

// Elements of a pool row piece: 16 bytes of T where the row is a whole
// number of them, else one element.
template <typename T, bool VEC>
__host__ __device__ constexpr int piece_elems() {
  return VEC ? 16 / (int)sizeof(T) : 1;
}

// One pool row's pieces p = tl, tl + ts, ... (E elements each) from `row`
// into cneg[k] and zeros into dneg[k], STAGE_U loads of a lane in flight
// before their stores.
template <typename T, bool VEC>
static __device__ __forceinline__ void stage_pool_row(const T* row,
                                                      float* cneg, float* dneg,
                                                      int k, int d, int ts,
                                                      int tl) {
  constexpr int E = piece_elems<T, VEC>();
  using Raw = typename std::conditional<VEC, uint4, T>::type;
  const int np = (d + E - 1) / E;
  for (int q0 = tl; q0 < np; q0 += ts * STAGE_U) {
    Raw v[STAGE_U];
#pragma unroll
    for (int u = 0; u < STAGE_U; ++u) {
      const int p = q0 + ts * u;
      if (p < np) v[u] = step_ld(reinterpret_cast<const Raw*>(row) + p);
    }
#pragma unroll
    for (int u = 0; u < STAGE_U; ++u) {
      const int p = q0 + ts * u;
      if (p >= np) continue;
      const size_t at = (size_t)k * d + p * E;
      if constexpr (!VEC) {
        cneg[at] = to_f32(v[u]);
        dneg[at] = 0.0f;
      } else if constexpr (E == 4) {  // f32
        *reinterpret_cast<uint4*>(cneg + at) = v[u];
        *reinterpret_cast<float4*>(dneg + at) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      } else {  // bf16: 8 elements, widened exactly
        const uint4 w = v[u];
        *reinterpret_cast<float4*>(cneg + at) = make_float4(
            __uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
            __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
        *reinterpret_cast<float4*>(cneg + at + 4) = make_float4(
            __uint_as_float(w.z << 16), __uint_as_float(w.z & 0xffff0000u),
            __uint_as_float(w.w << 16), __uint_as_float(w.w & 0xffff0000u));
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dneg + at) = z;
        *reinterpret_cast<float4*>(dneg + at + 4) = z;
      }
    }
  }
}

template <typename T, bool VEC>
static __global__ void __launch_bounds__(STAGE_THREADS)
stage_pool_kernel(const T* table, const int* pool, float* __restrict__ cneg,
                  float* __restrict__ dneg, int d, int KP, int ts) {
  const int k = blockIdx.x * (STAGE_THREADS / ts) + threadIdx.x / ts;
  const int id = k < KP ? step_ld(pool + k) : 0;
  pdl_wait();
  if (k < KP)
    stage_pool_row<T, VEC>(table + (size_t)id * d, cneg, dneg, k, d, ts,
                           threadIdx.x % ts);
  pdl_trigger();
}

// The lanes a pool row's team takes: 16 for rows of at most 16 pieces of
// `e` elements, else a warp.
static inline int pool_team(int d, int e) {
  return (d + e - 1) / e <= 16 ? 16 : 32;
}

// table[pool[k]] -= lr * dneg[k], atomic: a pool may repeat a row; lr from
// the argument block `args` (null: `lr`).  grid KP, block 128.  PDL: the
// pool id and lr (the head's) before the wait; dneg (the negative pass's)
// and the table row (the scatter's) after.  P3's pool write (star_probe.cu:
// its POOL section), its one caller: the f32 walk and star steps write
// their pools in their block-end scatter (walk_sgns.cu:
// block_end_scatter_kernel, star_sgns.cu: star_block_end_scatter_kernel),
// K3 in apply_pool_bf16_kernel.
static __global__ void apply_pool_kernel(float* table, const int* pool,
                                         const float* dneg, int d,
                                         const StepArgs* args, float lr) {
  const int k = blockIdx.x;
  const size_t dst = (size_t)step_ld(pool + k) * d, src = (size_t)k * d;
  const float r = args != nullptr ? step_ld(&args->lr) : lr;  // P3: none
  pdl_wait();
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    atomicAdd(&table[dst + j], -r * step_ld(dneg + src + j));
  pdl_trigger();
}

// K3's pool write in draw order.  A pool may draw a row more than once
// (unigram^0.75 pools over a power-law graph draw hubs repeatedly), and
// the TPU's fori_loop over k (pallas_walk_sgns.py:405 _apply_pool) and the
// plain version (ops/walk_sgns.py::rmw_rows) apply a row's draws in
// increasing k, each rounded.  So each distinct row gets one owner, its
// first draw, which applies the row's draws in order; the owners need each
// row's draws sorted by k.  pool_chains_kernel finds them once a step for
// every block's pool (the pools are the call's, staged by the head kernel):
// one CTA a pool sorts (id, k) in shared memory (a bitonic network over
// pool_chain_slots(KP) 64-bit keys, so a row's draws stand together in
// increasing k) and writes, for the pool, order[i] = the k at sorted place
// i and info[k] = (i, n): k's place and, for a row's first draw, its n
// draws (0 for the others).  It runs right after the head kernel (K4: its
// walk generation), launched without PDL, and lets the stage after it
// start at once: the stage's wait holds its work until this completes.
// K3's pool writes read info and order before their wait: written two or
// more kernels before, they are complete.  At KP 2048 a CTA sorts 2048
// keys in 66 passes; the 128 pools of a synthetic-10m step sort side by
// side, once a step of 128 groups.  grid: the step's pools, block
// CHAIN_THREADS, dynamic shared memory pool_chain_smem(KP); refused past
// POOL_CHAIN_MAX.
constexpr int CHAIN_THREADS = 1024;
constexpr int POOL_CHAIN_MAX = 16384;  // the largest KP (keys in 128 KiB)

static __host__ __device__ inline int pool_chain_slots(int KP) {
  int n = 2;
  while (n < KP) n <<= 1;
  return n;
}

static inline size_t pool_chain_smem(int KP) {
  return sizeof(unsigned long long) * (size_t)pool_chain_slots(KP);
}

static __global__ void __launch_bounds__(CHAIN_THREADS)
pool_chains_kernel(const int* pools, int KP, int* info, int* order) {
  pdl_wait();  // launched without PDL: returns at once
  pdl_trigger();
  extern __shared__ unsigned long long chain_keys[];
  const int n2 = pool_chain_slots(KP), t0 = threadIdx.x;
  const int* pool = pools + (size_t)blockIdx.x * KP;
  for (int i = t0; i < n2; i += CHAIN_THREADS)
    chain_keys[i] = i < KP ? (unsigned long long)(unsigned)step_ld(pool + i)
                                     << 32 |
                                 (unsigned)i
                           : ~0ull;
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int t = t0; t < n2 / 2; t += CHAIN_THREADS) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const unsigned long long x = chain_keys[i], y = chain_keys[j];
        if ((x > y) == ((i & size) == 0)) {
          chain_keys[i] = y;
          chain_keys[j] = x;
        }
      }
      __syncthreads();
    }
  }
  int* inf = info + (size_t)blockIdx.x * KP * 2;
  int* ord = order + (size_t)blockIdx.x * KP;
  for (int i = t0; i < KP; i += CHAIN_THREADS) {
    const unsigned long long key = chain_keys[i];
    const unsigned id = (unsigned)(key >> 32);
    const int k = (int)(key & 0xffffffffu);
    ord[i] = k;
    int n = 0;
    if (i == 0 || (unsigned)(chain_keys[i - 1] >> 32) != id)
      for (n = 1; i + n < KP && (unsigned)(chain_keys[i + n] >> 32) == id;)
        ++n;
    inf[2 * k] = i;
    inf[2 * k + 1] = n;
  }
}

// K3's pool write at a block end (pallas_walk_sgns.py:405 _apply_pool on
// bf16 tables): table[pool[k]] = round(f32(row) + __fmul_rn(dneg[k], -lr))
// for k in draw order, each element rounded by the low 16 bits of
// sr_bits(sr_key(seed, g), (GROUP + k) * d + j) (SR; truncation without):
// the pool has its own counter range past the group's 1024 slots (the TPU
// reads its 1024-row draw buffer at row k, pallas_walk_sgns.py:418
// against :603, past its end for KP > 1024).  Bit for bit what rmw_rows
// writes.  Each row's owner (pool_chains_kernel's info) is a team of `ts`
// lanes (16 up to 16 pieces, a bf16 row of 128; else a warp): it loads the
// row once, applies its draws in order (order[i], ..., order[i + n - 1])
// with the row in registers and stores it once, with plain stores and no
// atomics.  Before its wait a team reads its draw's (i, n) and the first
// APPLY_U draws' places; after it, the row and those draws' dneg pieces,
// all in flight together (dneg is the negative pass's, two kernels before,
// but it shares the row's latency).  A team takes one pool draw k, so the
// grid is KP draws' teams (apply_setup).  Pieces are 16 bytes of the row (8
// elements) where d % 8 == 0, else a bf16 pair (E = 2; d is even for bf16
// tables).  It is bound by latency, not bytes: it moves the distinct rows
// in and out and KP dneg rows in (K3: 0.63 us at d 128).  block
// APPLY_THREADS.  lr and seed from the argument block `args`,
// or, without one (the C entry that runs the kernel alone), from `lr_in`
// and `seed_in`.
constexpr int APPLY_THREADS = 256;
constexpr int APPLY_U = 4;  // draws whose dneg pieces a lane loads at once

// A piece of E bf16 elements (a 16-byte word when E is 8, a pair when 2)
// widened exactly to f32, and packed back from f32 values that are bf16.
static __device__ __forceinline__ void widen2(unsigned w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}
static __device__ __forceinline__ unsigned pack2(const float* x) {
  return (__float_as_uint(x[0]) >> 16) |
         (__float_as_uint(x[1]) & 0xffff0000u);
}

// The dneg pieces (elements j..j+E-1) of draws cs[0..APPLY_U) (-1: none),
// all loads in flight together.
template <int E>
static __device__ __forceinline__ void load_draws(const float* dneg, int d,
                                                  int j,
                                                  const int (&cs)[APPLY_U],
                                                  float (&u)[APPLY_U][E]) {
#pragma unroll
  for (int i = 0; i < APPLY_U; ++i) {
    if (cs[i] < 0) continue;
    const float* src = dneg + (size_t)cs[i] * d + j;
    if constexpr (E == 8) {
      const float4 lo = step_ld(reinterpret_cast<const float4*>(src));
      const float4 hi = step_ld(reinterpret_cast<const float4*>(src + 4));
      u[i][0] = lo.x, u[i][1] = lo.y, u[i][2] = lo.z, u[i][3] = lo.w;
      u[i][4] = hi.x, u[i][5] = hi.y, u[i][6] = hi.z, u[i][7] = hi.w;
    } else {
      const float2 a = step_ld(reinterpret_cast<const float2*>(src));
      u[i][0] = a.x, u[i][1] = a.y;
    }
  }
}

// x (elements j..j+E-1 of the row, f32 values of bf16) through the draws
// cs[i] in order: x = round(x + f32(u[i] * -lr)), by the low 16 bits of
// sr_bits(key, (GROUP + cs[i]) * d + j + e) (SR) or truncated.
template <bool SR, int E>
static __device__ __forceinline__ void apply_draws(
    float (&x)[E], const int (&cs)[APPLY_U], const float (&u)[APPLY_U][E],
    int d, int j, float lr, unsigned key) {
#pragma unroll
  for (int i = 0; i < APPLY_U; ++i) {
    if (cs[i] < 0) break;
    const unsigned at = (unsigned)((GROUP + cs[i]) * d + j);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float s = __fadd_rn(x[e], __fmul_rn(u[i][e], -lr));
      const unsigned r = SR ? mix32((at + e) ^ key) & 0xffffu : 0u;
      x[e] = __uint_as_float(((__float_as_uint(s) + r) >> 16) << 16);
    }
  }
}

// One owner's row: its pieces p = tl, tl + ts, ... of E elements, each
// taken through the row's n draws ch[0..n) in order; `first` holds
// ch[0..APPLY_U) (-1 past n), read before the wait.
template <bool SR, int E>
static __device__ __forceinline__ void apply_row(
    __nv_bfloat16* row, const float* dneg, const int* ch, int n,
    const int (&first)[APPLY_U], int d, int ts, int tl, float lr,
    unsigned key) {
  for (int p = tl; p * E < d; p += ts) {
    const int j = p * E;
    float u[APPLY_U][E];
    load_draws<E>(dneg, d, j, first, u);
    float x[E];
    if constexpr (E == 8) {
      const uint4 w = step_ld(reinterpret_cast<const uint4*>(row + j));
      widen2(w.x, x), widen2(w.y, x + 2), widen2(w.z, x + 4);
      widen2(w.w, x + 6);
    } else {
      widen2(step_ld(reinterpret_cast<const unsigned*>(row + j)), x);
    }
    apply_draws<SR, E>(x, first, u, d, j, lr, key);
    for (int i0 = APPLY_U; i0 < n; i0 += APPLY_U) {
      int cs[APPLY_U];
#pragma unroll
      for (int i = 0; i < APPLY_U; ++i)
        cs[i] = i0 + i < n ? step_ld(ch + i0 + i) : -1;
      load_draws<E>(dneg, d, j, cs, u);
      apply_draws<SR, E>(x, cs, u, d, j, lr, key);
    }
    if constexpr (E == 8)
      *reinterpret_cast<uint4*>(row + j) =
          make_uint4(pack2(x), pack2(x + 2), pack2(x + 4), pack2(x + 6));
    else
      *reinterpret_cast<unsigned*>(row + j) = pack2(x);
  }
}

template <bool SR, int E>
static __global__ void __launch_bounds__(APPLY_THREADS)
apply_pool_bf16_kernel(__nv_bfloat16* table, const int* pool,
                       const float* dneg, const int* info, const int* order,
                       int d, int KP, int ts, const StepArgs* args,
                       float lr_in, unsigned seed_in, int g) {
  const float lr = args != nullptr ? step_ld(&args->lr) : lr_in;
  const unsigned key =
      SR ? sr_key(args != nullptr ? step_ld(&args->seed) : seed_in,
                  (unsigned)g)
         : 0u;
  const int k = blockIdx.x * (APPLY_THREADS / ts) + threadIdx.x / ts;
  // k's place and draws (pool_chains_kernel's, complete) and its row
  int2 in = make_int2(0, 0);
  int id = 0, first[APPLY_U];
  if (k < KP) {
    in = step_ld(reinterpret_cast<const int2*>(info) + k);
    id = step_ld(pool + k);
  }
#pragma unroll
  for (int i = 0; i < APPLY_U; ++i)
    first[i] = i == 0 ? k : i < in.y ? step_ld(order + in.x + i) : -1;
  pdl_wait();
  if (in.y > 0)  // else an earlier draw of the row owns it (or k >= KP)
    apply_row<SR, E>(table + (size_t)id * d, dneg, order + in.x, in.y, first,
                     d, ts, threadIdx.x % ts, lr, key);
  pdl_trigger();
}

// ------------------------------------------------ the negative pass's tiles

constexpr int NEG_MS = 64;        // slots per CTA
constexpr int NEG_KC = 32;        // pool rows per chunk
constexpr int NEG_THREADS = 128;

// The pool splits ny of a pass over `tiles` slot tiles and `nch` pool
// chunks when `fit` CTAs fit on the card at once: CTA (x, y) walks chunks
// y, y + ny, ... of tile x, each CTA as few (`per`) as fill the card.
// tests/test_torch_star_pass.py repeats it.
static inline int neg_pool_splits(int tiles, int nch, int fit) {
  const int per = (nch * tiles + fit - 1) / fit;
  return (nch + per - 1) / per;
}

// ------------------------------------------------ f32 pass (SIMT FFMA)

// Staged f32 rows: d rounded up to a float4, + 4 floats of stride, so rows
// stay 16-byte aligned and float4 reads of 8 consecutive rows at one column
// fall in distinct banks (d a multiple of 32).
static __host__ __device__ inline int negf_stride(int d) {
  return ((d + 3) & ~3) + 4;
}
constexpr int NEGF_GS = NEG_KC + 4;  // g by slot:      [MS][KC + 4]
constexpr int NEGF_GT = NEG_MS + 4;  // g by pool row:  [KC][MS + 4]
constexpr int NEGF_CMAX = 8;         // the largest cluster (portable size)

static inline size_t negative_f32_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(NEG_MS + NEG_KC) * negf_stride(d) +
                          NEG_MS * NEGF_GS + NEG_KC * NEGF_GT + NEG_MS);
}

// f32 negative pass of one 64-slot tile against the pool chunks
// blockIdx.y, blockIdx.y + ny, ... (32 rows each).  grid (slots / 64, ny),
// block NEG_THREADS, launched in clusters of C = 1, 2, 4 or 8 CTAs along y
// (C divides ny); NP = 2 takes d <= 128, NP = 3 d <= 192.
//   phi[i]  = table[ids[i]]           (the slot's staged row)
//   s[i,j]  = phi[i] . cneg[j]
//   g[i,j]  = sigmoid(s) * negw * nt[i]   (0 for pool rows j >= KP)
//   dphi[i] += g[i,:] @ cneg          (once per cluster, atomic; slots with
//                                      nt = 0 get exactly no write)
//   dneg[j] += g[:,j]^T @ phi         (atomic, once per chunk; rows >= KP
//                                      are staged as zeros, never written)
// and adds -negw * nt[i] * log(sigmoid(-s)) (j < KP) to stats[0].  Thread
// t's register tiles: scores of slots 4 (t / 8) + r and pool rows t % 8 +
// 8 c (r, c < 4), read as float4 along d; dphi of slots 8 (t / 16) + r (r
// < 8) and dneg of pool rows 4 (t / 16) + r (r < 4), both at the columns
// 4 (t % 16) + 64 p (p < NP, a float4 each), so the 8 lanes of a
// quarter-warp read 8 neighbouring float4 of one row or one float4 of 8
// rows 4 banks apart.  A cluster's CTAs share the tile: each writes its dphi
// partial to its shared memory, and CTA q of the cluster sums slots
// 64 q / C.. of every CTA's partial (distributed shared memory) in f64, in
// rank order, and adds the sum once: few rounded adds, in a fixed order,
// where one atomic add per CTA would round each partial at the running
// sum's magnitude.  A tile whose slots all have nt = 0 returns at once
// (every CTA of its cluster).  PDL: the tile's slot ids are read before the
// wait; cneg (pool staging), nt (the positive pass, or K6/K7's plan), the
// table rows (the last scatter) and dphi/dneg after; it triggers right
// after its wait.
template <int NP>
static __global__ void __launch_bounds__(NEG_THREADS, NP == 2 ? 3 : 2)
negative_f32_kernel(const float* table,
                    const int* ids, const float* nt,
                    const float* cneg, int d, int KP, int ny,
                    float negw, float* __restrict__ dphi,
                    float* __restrict__ dneg, double* __restrict__ stats) {
  extern __shared__ float4 negf_smem[];
  const int sa = negf_stride(d), dp = sa - 4;
  float* ph = reinterpret_cast<float*>(negf_smem);  // [MS][sa]
  float* cn = ph + NEG_MS * sa;                     // [KC][sa]
  float* gs = cn + NEG_KC * sa;                     // [MS][GS]
  float* gt = gs + NEG_MS * NEGF_GS;                // [KC][GT]
  float* nts = gt + NEG_KC * NEGF_GT;               // [MS]
  __shared__ int rows[NEG_MS];
  const int base = blockIdx.x * NEG_MS, t = threadIdx.x;
  const int nch = (KP + NEG_KC - 1) / NEG_KC;
  auto pool_row = [&](int ch) {
    return [=](int j) {
      const int k = ch * NEG_KC + j;
      return k < KP ? cneg + (size_t)k * d : nullptr;
    };
  };
  constexpr int CU = 4 * NP;  // a chunk's float4 pieces per thread
  if (t < NEG_MS) rows[t] = step_ld(ids + base + t);
  pdl_wait();
  pdl_trigger();
  float4 next[CU];
  load_batch<NEG_THREADS, CU, float>(next, t, NEG_KC, d, dp,
                                     pool_row(blockIdx.y));
  float own = 0.0f;
  if (t < NEG_MS) {
    own = step_ld(nt + base + t);
    nts[t] = own;
  }
  if (!__syncthreads_or(own != 0.0f)) return;  // no slot of the tile scores
  stage_rows<NEG_THREADS, 8, float>(
      NEG_MS, d, dp, [&](int i) { return table + (size_t)rows[i] * d; },
      [&](int i, int c, float4 v) {
        *reinterpret_cast<float4*>(ph + i * sa + c) = v;
      });

  const int sr = t >> 3, sc = t & 7, rg = t >> 4, cg = t & 15;
  float4 acc[8][NP];  // dphi of slots 8 rg + r
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int p = 0; p < NP; ++p) acc[r][p] = make_float4(0.f, 0.f, 0.f, 0.f);
  float loss = 0.0f;
  for (int ch = blockIdx.y; ch < nch; ch += ny) {
    const int j0 = ch * NEG_KC;
    __syncthreads();  // the staging above, or the last chunk's reads
    store_batch<NEG_THREADS, CU>(
        next, t, NEG_KC, dp, [&](int j, int c, float4 v) {
          *reinterpret_cast<float4*>(cn + j * sa + c) = v;
        });
    if (ch + ny < nch)
      load_batch<NEG_THREADS, CU, float>(next, t, NEG_KC, d, dp,
                                         pool_row(ch + ny));
    __syncthreads();

    // scores of slots 4 sr + r against pool rows sc + 8 c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < dp; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(ph + (4 * sr + r) * sa + k);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(cn + (sc + 8 * c) * sa + k);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(a[r].x, b[c].x, s[r][c]);
          s[r][c] = fmaf(a[r].y, b[c].y, s[r][c]);
          s[r][c] = fmaf(a[r].z, b[c].z, s[r][c]);
          s[r][c] = fmaf(a[r].w, b[c].w, s[r][c]);
        }
    }
    // g = sigmoid(s) * w and the loss -w * log(sigmoid(-s)) from one exp,
    // kept by slot (gs) and by pool row (gt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float w = negw * nts[4 * sr + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // no branch: the chains overlap
        const float x = s[r][c];
        const float wj = j0 + sc + 8 * c < KP ? w : 0.0f;
        const float ex = expf(-fabsf(x));
        s[r][c] = (x >= 0.0f ? 1.0f : ex) / (1.0f + ex) * wj;
        loss -= wj * (fminf(-x, 0.0f) - log1pf(ex));
        gs[(4 * sr + r) * NEGF_GS + sc + 8 * c] = s[r][c];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(gt + (sc + 8 * c) * NEGF_GT + 4 * sr) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // dphi[8 rg + r, cols] += G[8 rg + r, chunk] . C[chunk, cols]
#pragma unroll 4
    for (int j = 0; j < NEG_KC; ++j) {
      const float4 g0 = *reinterpret_cast<const float4*>(gt + j * NEGF_GT + 8 * rg);
      const float4 g1 =
          *reinterpret_cast<const float4*>(gt + j * NEGF_GT + 8 * rg + 4);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = 4 * cg + 64 * p;
        if (c >= dp) break;
        const float4 cv = *reinterpret_cast<const float4*>(cn + j * sa + c);
#pragma unroll
        for (int r = 0; r < 8; ++r) fma4(g[r], cv, acc[r][p]);
      }
    }

    // dneg[j0 + 4 rg + r, cols] += G^T[., tile] . Phi[tile, cols]
    float4 q[4][NP];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int p = 0; p < NP; ++p) q[r][p] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < NEG_MS; ++i) {
      const float4 g = *reinterpret_cast<const float4*>(gs + i * NEGF_GS + 4 * rg);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = 4 * cg + 64 * p;
        if (c >= dp) break;
        const float4 pv = *reinterpret_cast<const float4*>(ph + i * sa + c);
        fma4(g.x, pv, q[0][p]);
        fma4(g.y, pv, q[1][p]);
        fma4(g.z, pv, q[2][p]);
        fma4(g.w, pv, q[3][p]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + 4 * rg + r;
      if (j >= KP) continue;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = 4 * cg + 64 * p;
        if (c < dp) atomic_add4(dneg + (size_t)j * d, d, c, q[r][p]);
      }
    }
  }

  // the cluster's partials of dphi, summed on chip
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  __syncthreads();  // the last chunk's reads of ph
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c = 4 * cg + 64 * p;
      if (c < dp)
        *reinterpret_cast<float4*>(ph + (8 * rg + r) * sa + c) = acc[r][p];
    }
  cluster.sync();
  const int rows_q = NEG_MS / C, n4 = dp / 4;
  for (int idx = t; idx < rows_q * n4; idx += NEG_THREADS) {
    const int i = q * rows_q + idx / n4, c = 4 * (idx % n4);
    if (nts[i] == 0.0f) continue;  // no pairs: exactly zero update
    float4 v[NEGF_CMAX];  // every rank's partial in flight at once
#pragma unroll
    for (int k = 0; k < NEGF_CMAX; ++k)
      if (k < C)
        v[k] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(ph, k) + i * sa + c);
    double x = 0.0, y = 0.0, z = 0.0, w = 0.0;
#pragma unroll
    for (int k = 0; k < NEGF_CMAX; ++k)
      if (k < C) {
        x += v[k].x;
        y += v[k].y;
        z += v[k].z;
        w += v[k].w;
      }
    atomic_add4(dphi + (size_t)(base + i) * d, d, c,
                make_float4((float)x, (float)y, (float)z, (float)w));
  }
  cluster.sync();  // no CTA leaves while another reads its partial
  block_add<NEG_THREADS>(loss, &stats[0]);
}

// The cluster size of an f32 pass with ny pool splits: the largest of 8, 4,
// 2, 1 not above ny; ny is then rounded up to a multiple of it.
static inline int negf_cluster(int ny) {
  return ny >= NEGF_CMAX ? NEGF_CMAX : ny >= 4 ? 4 : ny >= 2 ? 2 : 1;
}

// ------------------------------------------- bf16 pass on the tensor cores

// d padded to the mma depth; each staged matrix's row stride is its width
// + 8 bf16 (an odd multiple of 16 bytes), so the 8 rows an ldmatrix phase
// reads fall in distinct banks.
static __host__ __device__ inline int neg_dp(int d) { return (d + 15) & ~15; }

static inline size_t negative_bf16_smem_bytes(int d) {
  const size_t sa = neg_dp(d) + 8, sk = NEG_KC + 8;
  return 2 * (NEG_MS * sa + NEG_KC * sa + NEG_MS * sk) + sizeof(float) * NEG_MS;
}

// c += a . b on one m16n8k16 tile: bf16 operands, f32 accumulation.
static __device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                                const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The A fragment (rows m0..m0+15, depth k0..k0+15) of a bf16 matrix in
// shared memory with row stride st: stored [m][k] (TRANS false) or [k][m]
// (TRANS true, read through ldmatrix .trans).
template <bool TRANS>
static __device__ __forceinline__ void frag_a(unsigned a[4],
                                              const __nv_bfloat16* m, int st,
                                              int m0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p =
      TRANS ? m + (k0 + 8 * (q >> 1) + r) * st + m0 + 8 * (q & 1)
            : m + (m0 + 8 * (q & 1) + r) * st + k0 + 8 * (q >> 1);
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(smem_addr(p)));
}

// The B fragment (depth k0..k0+15, columns n0..n0+7) of a bf16 matrix in
// shared memory with row stride st: stored [n][k] (TRANS false) or [k][n]
// (TRANS true).
template <bool TRANS>
static __device__ __forceinline__ void frag_b(unsigned b[2],
                                              const __nv_bfloat16* m, int st,
                                              int n0, int k0) {
  const int lane = threadIdx.x & 15, q = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p = TRANS ? m + (k0 + 8 * q + r) * st + n0
                                 : m + (n0 + r) * st + k0 + 8 * q;
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
                 : "=r"(b[0]), "=r"(b[1])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
                 : "=r"(b[0]), "=r"(b[1])
                 : "r"(smem_addr(p)));
}

// out[row * d + col] += c for one m16n8 accumulator tile whose fragment
// rows are r (c[0], c[1]) and r + 8 (c[2], c[3]), at columns col, col + 1
// (col = the tile's first column + 2 * (lane & 3)); ok_r and ok_r8 say
// whether each row is written, columns >= d are not.  With d % 4 == 0 two
// neighbouring lanes pool their fragments into one 16-byte atomic each.
// The general form: rows ld apart, columns >= w not written, 16-byte
// atomics when `vec` (ld % 4 == 0 and w % 4 == 0; a column slab's out
// points at its first column, w is its width).
static __device__ __forceinline__ void red_tile(float* out, int ld, int w,
                                                bool vec, int r, bool ok_r,
                                                bool ok_r8, int col,
                                                const float c[4]) {
  const float x0 = __shfl_xor_sync(0xffffffffu, c[0], 1);
  const float x1 = __shfl_xor_sync(0xffffffffu, c[1], 1);
  const float x2 = __shfl_xor_sync(0xffffffffu, c[2], 1);
  const float x3 = __shfl_xor_sync(0xffffffffu, c[3], 1);
  if (vec) {
    const bool odd = threadIdx.x & 1;
    const int row = odd ? r + 8 : r, c0 = odd ? col - 2 : col;
    if ((odd ? ok_r8 : ok_r) && c0 < w)
      atomicAdd(reinterpret_cast<float4*>(out + (size_t)row * ld + c0),
                odd ? make_float4(x2, x3, c[2], c[3])
                    : make_float4(c[0], c[1], x0, x1));
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (col + e >= w) continue;
    if (ok_r) atomicAdd(out + (size_t)r * ld + col + e, c[e]);
    if (ok_r8) atomicAdd(out + (size_t)(r + 8) * ld + col + e, c[2 + e]);
  }
}

static __device__ __forceinline__ void red_tile(float* out, int d, int r,
                                                bool ok_r, bool ok_r8,
                                                int col, const float c[4]) {
  red_tile(out, d, d, d % 4 == 0, r, ok_r, ok_r8, col, c);
}

// m[0..3] = v rounded to bf16 (nearest even): one 8-byte store.
static __device__ __forceinline__ void put_bf16(__nv_bfloat16* m, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(m) = u;
}

// bf16 negative pass of one 64-slot tile against the pool chunks
// blockIdx.y, blockIdx.y + ny, ... (32 rows each).  grid (slots / 64, ny),
// block NEG_THREADS; NTILE = 16 takes d <= 128, NTILE = 24 d <= 192.
// Computes what negative_f32_kernel computes, with phi, cneg and g rounded
// to bf16 (round to nearest even) as the TPU rounds phi_m, cneg_m and
// gneg_m; the loss and g take the f32 score.  Warp w owns slot rows
// 16w..16w+15 of the scores and of dphi (kept in registers over the CTA's
// chunks, merged once at the end; rows with nt = 0 get exactly no update),
// and of each chunk's dneg the 16 pool rows 16 (w & 1) and half of d's
// columns (w >> 1).  The next chunk's rows are loaded into registers while
// the current one is computed.  PDL: as negative_f32_kernel, but it
// triggers once dphi is merged.
template <int NTILE, typename T>
static __global__ void __launch_bounds__(NEG_THREADS, NTILE == 16 ? 3 : 2)
negative_bf16_kernel(const T* table, const int* ids,
                     const float* nt,
                     const float* cneg, int d, int KP, int ny,
                     float negw, float* __restrict__ dphi,
                     float* __restrict__ dneg, double* __restrict__ stats) {
  extern __shared__ float4 neg_smem[];
  const int dp = neg_dp(d), sa = dp + 8, sk = NEG_KC + 8;
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(neg_smem);  // [MS][sa]
  __nv_bfloat16* cn = ph + NEG_MS * sa;                            // [KC][sa]
  __nv_bfloat16* gs = cn + NEG_KC * sa;                            // [MS][sk]
  float* nts = reinterpret_cast<float*>(gs + NEG_MS * sk);         // [MS]
  __shared__ int rows[NEG_MS];
  const int base = blockIdx.x * NEG_MS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fr = lane >> 2, fc = 2 * (lane & 3);  // fragment row, column
  const int ntiles = dp / 8, half = ntiles / 2;
  const int nch = (KP + NEG_KC - 1) / NEG_KC;
  auto pool_row = [&](int ch) {
    return [=](int j) {
      const int k = ch * NEG_KC + j;
      return k < KP ? cneg + (size_t)k * d : nullptr;
    };
  };
  constexpr int CU = NTILE / 2;  // a chunk's pieces per thread
  if (threadIdx.x < NEG_MS) rows[threadIdx.x] = step_ld(ids + base + threadIdx.x);
  pdl_wait();
  float4 next[CU];
  load_batch<NEG_THREADS, CU, float>(next, threadIdx.x, NEG_KC, d, dp,
                                     pool_row(blockIdx.y));

  if (threadIdx.x < NEG_MS) nts[threadIdx.x] = step_ld(nt + base + threadIdx.x);
  __syncthreads();
  stage_rows<NEG_THREADS, 8, T>(
      NEG_MS, d, dp, [&](int i) { return table + (size_t)rows[i] * d; },
      [&](int i, int c, float4 v) { put_bf16(ph + i * sa + c, v); });

  float acc[NTILE][4];  // dphi of the warp's 16 rows
#pragma unroll
  for (int n = 0; n < NTILE; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float loss = 0.0f;
  const int r0 = 16 * warp;
  for (int ch = blockIdx.y; ch < nch; ch += ny) {
    const int j0 = ch * NEG_KC;
    __syncthreads();  // the staging above, or the last chunk's reads
    store_batch<NEG_THREADS, CU>(
        next, threadIdx.x, NEG_KC, dp,
        [&](int j, int c, float4 v) { put_bf16(cn + j * sa + c, v); });
    if (ch + ny < nch)
      load_batch<NEG_THREADS, CU, float>(next, threadIdx.x, NEG_KC, d, dp,
                                         pool_row(ch + ny));
    __syncthreads();

    // scores of the warp's 16 slots against the chunk's 32 rows
    float s[NEG_KC / 8][4];
#pragma unroll
    for (int n = 0; n < NEG_KC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < 8 * NTILE; k0 += 16) {
      if (k0 >= dp) break;
      unsigned a[4];
      frag_a<false>(a, ph, sa, r0, k0);
#pragma unroll
      for (int n = 0; n < NEG_KC / 8; ++n) {
        unsigned b[2];
        frag_b<false>(b, cn, sa, 8 * n, k0);
        mma_bf16(s[n], a, b);
      }
    }
    // g = sigmoid(s) * w and the loss -w * log(sigmoid(-s)) from one exp
#pragma unroll
    for (int n = 0; n < NEG_KC / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // fragment rows fr and fr + 8
        const int i = r0 + fr + 8 * h, j = 8 * n + fc;
        const float w = negw * nts[i];
        float g[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // no branch: the chains overlap
          const float x = s[n][2 * h + e];
          const float wj = j0 + j + e < KP ? w : 0.0f;
          const float ex = expf(-fabsf(x));
          g[e] = (x >= 0.0f ? 1.0f : ex) / (1.0f + ex) * wj;
          loss -= wj * (fminf(-x, 0.0f) - log1pf(ex));
        }
        *reinterpret_cast<__nv_bfloat162*>(gs + i * sk + j) =
            __floats2bfloat162_rn(g[0], g[1]);
      }
    __syncthreads();

    // dphi[r0.., :] += G[r0.., chunk] . C[chunk, :]
#pragma unroll
    for (int k0 = 0; k0 < NEG_KC; k0 += 16) {
      unsigned a[4];
      frag_a<false>(a, gs, sk, r0, k0);
#pragma unroll
      for (int n = 0; n < NTILE; ++n) {
        if (n >= ntiles) break;
        unsigned b[2];
        frag_b<true>(b, cn, sa, 8 * n, k0);
        mma_bf16(acc[n], a, b);
      }
    }

    // dneg[chunk rows mr.., columns of half h] += G^T . Phi
    const int mr = 16 * (warp & 1), n0 = (warp >> 1) * half;
    float q[NTILE / 2][4];
#pragma unroll
    for (int n = 0; n < NTILE / 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) q[n][e] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < NEG_MS; k0 += 16) {
      unsigned a[4];
      frag_a<true>(a, gs, sk, mr, k0);
#pragma unroll
      for (int n = 0; n < NTILE / 2; ++n) {
        if (n >= half) break;
        unsigned b[2];
        frag_b<true>(b, ph, sa, 8 * (n0 + n), k0);
        mma_bf16(q[n], a, b);
      }
    }
    const int jr = j0 + mr + fr;
#pragma unroll
    for (int n = 0; n < NTILE / 2; ++n) {
      if (n >= half) break;
      red_tile(dneg + (size_t)j0 * d, d, mr + fr, jr < KP, jr + 8 < KP,
               8 * (n0 + n) + fc, q[n]);
    }
  }

  const int ir = r0 + fr;
  const bool ok = nts[ir] != 0.0f, ok8 = nts[ir + 8] != 0.0f;
#pragma unroll
  for (int n = 0; n < NTILE; ++n) {
    if (n >= ntiles) break;
    red_tile(dphi + (size_t)base * d, d, ir, ok, ok8, 8 * n + fc, acc[n]);
  }
  pdl_trigger();
  block_add<NEG_THREADS>(loss, &stats[0]);
}

// ------------------------------------------- the passes past MAX_DIM

// Past MAX_DIM both negative passes run their wide kernels
// (negative_f32_wide_kernel, negative_bf16_wide_kernel<T>): 256 threads, one
// CTA an SM.  Each CTA holds its 64-slot tile's rows in shared memory for
// the whole pass and streams its pool chunks through a ring of two stages,
// filled by asynchronous copies while the chunk before is computed (chunk
// k + 1 in flight during chunk k), each stage on an mbarrier.  The f32 pass
// copies f32 rows: one cp.async.bulk a row where d % 4 == 0 (every row then
// starts 16-byte aligned), 4-byte cp.async otherwise.  The bf16 pass copies
// a pool staged once per R-block as bf16 in wgmma's layout
// (stage_pool_bf16_kernel): one bulk copy a chunk and slab.  Up to NEG_WHOLE columns a chunk is
// resident at full width, so its scores, g, dphi and dneg are formed from
// one copy of it in one sweep, dphi stays in registers across the CTA's
// chunks and is merged once a pass, and a CTA may walk any number of chunks
// (occupancy alone sets the pool splits).  Past NEG_WHOLE the rows are taken
// in column slabs of NEG_WHOLE through the same ring in two sweeps: sweep A
// sums each chunk's scores over the slabs (at most NEG_PMAX chunks a CTA,
// whose scores stay in registers and whose g stays in shared memory), sweep
// B forms each slab's dphi and dneg.  NEG_WHOLE is what dphi's registers
// hold (64 a thread: 64 slots x 256 columns over 256 threads) and what the
// f32 pass's shared memory holds (152 KB: 64 + 2 x 32 rows of 260 floats).
// Every copy of a buffer the step writes (the tables, cneg) is issued after
// pdl_wait().
constexpr int NEG_WHOLE = 256;     // the widest d held whole
constexpr int NEG_PMAX = 8;        // chunks a CTA walks past NEG_WHOLE
constexpr int WIDE_THREADS = 256;  // 8 warps; the bf16 kernel's 2 warpgroups

// (s0, w, wp) of wide slab k: its first column, width, width to a float4.
struct WideSlab {
  int s0, w, wp;
  __device__ WideSlab(int k, int d)
      : s0(k * NEG_WHOLE), w(min(NEG_WHOLE, d - k * NEG_WHOLE)),
        wp((w + 3) & ~3) {}
};

static __host__ __device__ inline int n_wide_slabs(int d) {
  return (d + NEG_WHOLE - 1) / NEG_WHOLE;
}

// mbarriers, and copies from global to shared memory that complete on one.
static __device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                                 unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Thread 0's arrival that also expects `bytes` of bulk copies this phase.
static __device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

static __device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                                 unsigned parity) {
  unsigned ok = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}

// `bytes` (a multiple of 16; both ends 16-byte aligned) onto `bar`.
static __device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                                 unsigned bytes,
                                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

static __device__ __forceinline__ void async_copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

static __device__ __forceinline__ void async_copy16(void* dst,
                                                  const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// This thread's arrival on `bar`, now.
static __device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until this thread's cp.async so far have landed.
static __device__ __forceinline__ void async_copies_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// This thread's arrival on `bar` once its cp.async so far have landed (the
// barrier counts it: init with the block's thread count).
static __device__ __forceinline__ void cp_async_arrive(
    unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Orders this thread's generic writes to shared memory before the async
// proxy's later accesses (bulk copies, wgmma operand reads).
static __device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Rows i < n of w elements (f32, or bf16 with w even), src(i) -> dst + i *
// ld, completing on `bar`: with `vec` (every row's bytes a multiple of 16,
// 16-byte aligned) one bulk copy a row, issued by lanes 0-3 of every warp
// (a bulk copy holds its issuing warp ≈ 70 cycles on the H100, so warp 0
// alone would take ≈ 2.2 k cycles a chunk; thread 0 expects the bytes; init
// `bar` with 1), else 4-byte cp.async from every thread and each thread's
// arrival (init `bar` with NT).  All NT threads of the block call it.
template <int NT = WIDE_THREADS, typename E, typename Src>
static __device__ __forceinline__ void copy_rows(E* dst, int ld, int n, int w,
                                                 Src src,
                                                 unsigned long long* bar,
                                                 bool vec) {
  const int bytes = w * (int)sizeof(E);
  if (vec) {
    const int lane = threadIdx.x & 31, id = (threadIdx.x >> 5) * 4 + lane;
    if (threadIdx.x == 0) mbar_expect(bar, (unsigned)(n * bytes));
    if (lane < 4)
      for (int i = id; i < n; i += NT / 8)
        bulk_copy(dst + i * ld, src(i), (unsigned)bytes, bar);
    return;
  }
  for (int e = threadIdx.x; e < n * (bytes / 4); e += NT) {
    const int i = e / (bytes / 4), b = 4 * (e - i * (bytes / 4));
    async_copy4(reinterpret_cast<char*>(dst + i * ld) + b,
                reinterpret_cast<const char*>(src(i)) + b);
  }
  cp_async_arrive(bar);
}

// The elements of a 16-byte piece of a row held in shared memory (4 f32,
// or 8 bf16 widened exactly to f32), in order.
template <typename E>
static __device__ __forceinline__ void unpack16(const E* p,
                                                float (&v)[16 / sizeof(E)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(E) == 4) {
      v[k] = __uint_as_float(w[k]);
    } else {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// ------------------------------------------ f32 wide pass (SIMT FFMA)

constexpr int NEGW_SA = NEG_WHOLE + 4;  // staged row stride (floats)
constexpr int NEGW_GS = NEG_KC + 4;     // g by slot:     [MS][KC + 4]
constexpr int NEGW_GT = NEG_MS + 4;     // g by pool row: [KC][MS + 4]

// Shared memory of the f32 wide pass at width d: tile, ring, g by slot, g
// by pool row (NEG_PMAX chunks' past NEG_WHOLE), nt, 3 mbarriers.
static inline size_t negative_f32_wide_smem_bytes(int d) {
  const size_t gt = n_wide_slabs(d) > 1 ? NEG_PMAX : 1;
  return sizeof(float) * ((size_t)(NEG_MS + 2 * NEG_KC) * NEGW_SA +
                          NEG_MS * NEGW_GS + gt * NEG_KC * NEGW_GT + NEG_MS) +
         3 * sizeof(unsigned long long);
}

// What negative_f32_kernel computes, for any d > MAX_DIM, in FFMA (its
// checks allow no TF32).  grid (slots / 64, ny), block WIDE_THREADS,
// clusters of C along y; CTA (x, y) takes tile x and pool chunks y, y + ny,
// ....  Shared memory (152 KB at d <= NEG_WHOLE, 213 KB past it): the
// tile's rows [64][NEG_WHOLE + 4], the ring [2][32][NEG_WHOLE + 4], g by
// slot and by pool row.  A chunk: the scores (thread t: slots 2 (t / 8) + r,
// pool rows t % 8 + 8 c, r < 2, c < 4; float4 reads, a quarter-warp's 8 pool
// rows 4 banks apart), g and the loss from one exp, then dphi (thread t:
// slots 16 (t / 64) + r, r < 16, at columns 4 (t % 64): 64 registers over
// the CTA's chunks) and dneg (pool rows 8 (t / 64) + r, r < 8, the same
// columns; one 16-byte atomic a row), each from float4 reads of 32 lanes'
// neighbouring columns and broadcast reads of g.  The ring's next fill is
// issued as soon as a chunk's reads of its stage are done.  The cluster's
// dphi partials are summed on chip once a pass (once a slab past
// NEG_WHOLE) as negative_f32_kernel sums them.  Rows past KP and columns
// past d are never copied: the ring starts zeroed, a stale row's g is 0,
// and the tile's pad columns are zeroed after each fill.  A tile whose
// slots all have nt = 0 returns at once.  PDL as negative_f32_kernel: the
// ids before the wait, every copy and read of nt after it, the trigger
// right after it.
static __global__ void __launch_bounds__(WIDE_THREADS, 1)
negative_f32_wide_kernel(const float* table, const int* ids, const float* nt,
                         const float* cneg, int d, int KP, int ny,
                         float negw, float* __restrict__ dphi,
                         float* __restrict__ dneg,
                         double* __restrict__ stats) {
  extern __shared__ float4 negw_smem[];
  constexpr int sa = NEGW_SA;
  const int ns = n_wide_slabs(d);
  float* ph = reinterpret_cast<float*>(negw_smem);  // [MS][sa]
  float* ring = ph + NEG_MS * sa;                   // [2][KC][sa]
  float* gs = ring + 2 * NEG_KC * sa;               // [MS][GS]
  float* gt = gs + NEG_MS * NEGW_GS;                // [1 or PMAX][KC][GT]
  float* nts = gt + (ns > 1 ? NEG_PMAX : 1) * NEG_KC * NEGW_GT;  // [MS]
  unsigned long long* bar =  // the tile's, the ring stages'
      reinterpret_cast<unsigned long long*>(nts + NEG_MS);
  __shared__ int rows[NEG_MS];
  const int base = blockIdx.x * NEG_MS, t = threadIdx.x;
  const int nch = (KP + NEG_KC - 1) / NEG_KC, py = blockIdx.y;
  const int m = py < nch ? (nch - 1 - py) / ny + 1 : 0;  // chunks py + k ny
  auto first_row = [&](int k) { return (py + k * ny) * NEG_KC; };  // chunk k's
  const bool vec = d % 4 == 0;
  if (t < NEG_MS) rows[t] = step_ld(ids + base + t);
  pdl_wait();
  pdl_trigger();
  float own = 0.0f;
  if (t < NEG_MS) {
    own = step_ld(nt + base + t);
    nts[t] = own;
  }
  if (!__syncthreads_or(own != 0.0f)) return;  // no slot of the tile scores
  if (t == 0)
    for (int b = 0; b < 3; ++b) mbar_init(&bar[b], vec ? 1 : WIDE_THREADS);
  for (int i = t; i < (NEG_MS + 2 * NEG_KC) * sa / 4; i += WIDE_THREADS)
    reinterpret_cast<float4*>(ph)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_async_smem();
  __syncthreads();

  auto load_tile = [&](int s) {
    const WideSlab sl(s, d);
    copy_rows(ph, sa, NEG_MS, sl.w,
              [&](int i) { return table + (size_t)rows[i] * d + sl.s0; },
              &bar[0], vec);
  };
  // the ring's fills in order: (sweep, slab, chunk), sweep A past NEG_WHOLE
  const int F = (ns > 1 ? 2 : 1) * ns * m;
  auto fill = [&](int f) {
    const WideSlab sl((f / m) % ns, d);
    const int j0 = first_row(f % m);
    copy_rows(ring + (f & 1) * NEG_KC * sa, sa, min(NEG_KC, KP - j0), sl.w,
              [&](int j) { return cneg + (size_t)(j0 + j) * d + sl.s0; },
              &bar[1 + (f & 1)], vec);
  };
  load_tile(0);
  if (F > 0) fill(0);
  if (F > 1) fill(1);
  int f = 0, u = 0;  // fills and tile loads consumed
  // waits for the tile's slab s, zeroes its pad columns
  auto tile_ready = [&](const WideSlab& sl) {
    mbar_wait(&bar[0], u++ & 1);
    for (int e = t; e < NEG_MS * (sl.wp - sl.w); e += WIDE_THREADS)
      ph[(e / (sl.wp - sl.w)) * sa + sl.w + e % (sl.wp - sl.w)] = 0.0f;
    __syncthreads();
  };
  // the stage of fill f, once landed
  auto stage = [&](int f) {
    mbar_wait(&bar[1 + (f & 1)], (f >> 1) & 1);
    return ring + (f & 1) * NEG_KC * sa;
  };
  // a chunk's stage read by every thread: refill it
  auto done = [&](int f) {
    __syncthreads();
    if (f + 2 < F) fill(f + 2);
  };

  const int sr = t >> 3, sc = t & 7, q = t >> 6, cl = 4 * (t & 63);
  // scores of slots 2 sr + r against pool rows sc + 8 c over columns < wp
  auto scores = [&](float (&sv)[2][4], const float* cn, int wp) {
#pragma unroll 4
    for (int k = 0; k < wp; k += 4) {
      float4 a[2], b[4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        a[r] = *reinterpret_cast<const float4*>(ph + (2 * sr + r) * sa + k);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(cn + (sc + 8 * c) * sa + k);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sv[r][c] = fmaf(a[r].x, b[c].x, sv[r][c]);
          sv[r][c] = fmaf(a[r].y, b[c].y, sv[r][c]);
          sv[r][c] = fmaf(a[r].z, b[c].z, sv[r][c]);
          sv[r][c] = fmaf(a[r].w, b[c].w, sv[r][c]);
        }
    }
  };
  // g = sigmoid(s) * w and the loss -w * log(sigmoid(-s)) from one exp, of
  // chunk k: by pool row into g (a [KC][GT] tile), and by slot into gsl
  // (a [MS][GS] tile) unless it is null
  float loss = 0.0f;
  auto put_g = [&](const float (&sv)[2][4], float* g, float* gsl, int k) {
    const int j0 = first_row(k);
    float v[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float w = negw * nts[2 * sr + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // no branch: the chains overlap
        const float x = sv[r][c];
        const float wj = j0 + sc + 8 * c < KP ? w : 0.0f;
        const float ex = expf(-fabsf(x));
        v[r][c] = (x >= 0.0f ? 1.0f : ex) / (1.0f + ex) * wj;
        loss -= wj * (fminf(-x, 0.0f) - log1pf(ex));
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float2*>(g + (sc + 8 * c) * NEGW_GT + 2 * sr) =
          make_float2(v[0][c], v[1][c]);
      if (gsl != nullptr) {
        gsl[(2 * sr) * NEGW_GS + sc + 8 * c] = v[0][c];
        gsl[(2 * sr + 1) * NEGW_GS + sc + 8 * c] = v[1][c];
      }
    }
  };

  // sweep A (past NEG_WHOLE): each chunk's scores summed over the slabs
  float s[NEG_PMAX][2][4];
#pragma unroll
  for (int k = 0; k < NEG_PMAX; ++k)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[k][r][c] = 0.0f;
  if (ns > 1) {
    for (int n = 0; n < ns; ++n) {
      const WideSlab sl(n, d);
      if (n > 0) {
        __syncthreads();  // the last slab's reads of ph
        load_tile(n);
      }
      tile_ready(sl);
#pragma unroll
      for (int k = 0; k < NEG_PMAX; ++k) {
        if (k >= m) break;
        scores(s[k], stage(f), sl.wp);
        done(f++);
      }
    }
#pragma unroll
    for (int k = 0; k < NEG_PMAX; ++k) {
      if (k >= m) break;
      put_g(s[k], gt + k * NEG_KC * NEGW_GT, nullptr, k);
    }
  }

  // sweep B (the only one up to NEG_WHOLE): each slab's dphi and dneg
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = (int)cluster.num_blocks(), qr = (int)cluster.block_rank();
  for (int n = 0; n < ns; ++n) {
    const WideSlab sl(n, d);
    if (ns > 1) {
      __syncthreads();  // g written; the last slab's merge read ph
      load_tile(n);
    }
    tile_ready(sl);
    float4 acc[16];  // dphi of slots 16 q + r at columns cl
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < m; ++k) {
      const int j0 = first_row(k);
      const float* cn = stage(f);
      const float* g = gt + (ns > 1 ? k : 0) * NEG_KC * NEGW_GT;
      if (ns == 1) {  // the chunk's scores and g, by pool row and by slot
        float sk[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sk[r][c] = 0.0f;
        scores(sk, cn, sl.wp);
        put_g(sk, gt, gs, k);
      } else {  // chunk k's g (sweep A's) by slot
        for (int e = t; e < NEG_MS * NEG_KC; e += WIDE_THREADS) {
          const int j = e / NEG_MS, i = e % NEG_MS;
          gs[i * NEGW_GS + j] = g[j * NEGW_GT + i];
        }
      }
      __syncthreads();
      if (cl < sl.wp) {
        // dphi[16 q + r, cl..] += G[16 q + r, chunk] . C[chunk, cl..]
#pragma unroll 2
        for (int j = 0; j < NEG_KC; ++j) {
          const float4* gr =
              reinterpret_cast<const float4*>(g + j * NEGW_GT + 16 * q);
          const float4 g0 = gr[0], g1 = gr[1], g2 = gr[2], g3 = gr[3];
          const float gv[16] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y,
                                g1.z, g1.w, g2.x, g2.y, g2.z, g2.w,
                                g3.x, g3.y, g3.z, g3.w};
          const float4 cv = *reinterpret_cast<const float4*>(cn + j * sa + cl);
#pragma unroll
          for (int r = 0; r < 16; ++r) fma4(gv[r], cv, acc[r]);
        }
        // dneg[j0 + 8 q + r, cl..] += G^T[., tile] . Phi[tile, cl..]
        float4 qv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) qv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
        for (int i = 0; i < NEG_MS; ++i) {
          const float4* gr =
              reinterpret_cast<const float4*>(gs + i * NEGW_GS + 8 * q);
          const float4 g0 = gr[0], g1 = gr[1];
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w,
                               g1.x, g1.y, g1.z, g1.w};
          const float4 pv = *reinterpret_cast<const float4*>(ph + i * sa + cl);
#pragma unroll
          for (int r = 0; r < 8; ++r) fma4(gv[r], pv, qv[r]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int j = j0 + 8 * q + r;
          if (j < KP)
            atomic_add4(dneg + (size_t)j * d + sl.s0, sl.w, cl, qv[r], vec);
        }
      }
      done(f++);
    }
    // the cluster's partials of the slab's dphi, summed on chip
    if (cl < sl.wp)
#pragma unroll
      for (int r = 0; r < 16; ++r)
        *reinterpret_cast<float4*>(ph + (16 * q + r) * sa + cl) = acc[r];
    cluster.sync();
    const int rows_q = NEG_MS / C, n4 = sl.wp / 4;
    for (int idx = t; idx < rows_q * n4; idx += WIDE_THREADS) {
      const int i = qr * rows_q + idx / n4, c = 4 * (idx % n4);
      if (nts[i] == 0.0f) continue;  // no pairs: exactly zero update
      float4 v[NEGF_CMAX];  // every rank's partial in flight at once
#pragma unroll
      for (int k = 0; k < NEGF_CMAX; ++k)
        if (k < C)
          v[k] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(ph, k) + i * sa + c);
      double x = 0.0, y = 0.0, z = 0.0, w = 0.0;
#pragma unroll
      for (int k = 0; k < NEGF_CMAX; ++k)
        if (k < C) {
          x += v[k].x;
          y += v[k].y;
          z += v[k].z;
          w += v[k].w;
        }
      atomic_add4(dphi + (size_t)(base + i) * d + sl.s0, sl.w, c,
                  make_float4((float)x, (float)y, (float)z, (float)w), vec);
    }
    cluster.sync();  // no CTA reloads ph while another reads its partial
  }
  block_add<WIDE_THREADS>(loss, &stats[0]);
}

// ------------------------------------------ bf16 wide pass (wgmma)

// A bf16 matrix of R rows (R % 8 == 0) in wgmma's core-matrix layout
// without swizzle: 8 x 8 blocks of 128 contiguous bytes (8 rows of 16
// bytes), the blocks of a column band of 8 one after another down the
// rows, the bands one after another.  Element (r, c) of it:
static __host__ __device__ __forceinline__ int core_off(int R, int r, int c) {
  return ((c >> 3) * (R >> 3) + (r >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// A shared-memory matrix descriptor of wgmma, no swizzle: start address,
// `lbo` the bytes between core matrices along the depth (K), `sbo` along
// the rows or columns (M or N).  A core-matrix layout of R rows read K-major
// (rows are M or N, columns the depth) has lbo = 16 R and sbo = 128; read
// MN-major (rows the depth, columns N: a B of 16-bit type), lbo = 128 and
// sbo = 16 R.
static __device__ __forceinline__ unsigned long long wg_desc(const void* p,
                                                             unsigned lbo,
                                                             unsigned sbo) {
  return (unsigned long long)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((unsigned long long)((lbo & 0x3FFFF) >> 4) << 16) |
         ((unsigned long long)((sbo & 0x3FFFF) >> 4) << 32);
}

static __device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
static __device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
static __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Pins accumulator registers across the asynchronous wgmma (the compiler
// must not move their reads and writes past the fence or the wait).
template <int N>
static __device__ __forceinline__ void wg_pin(float (&c)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(c[i])::"memory");
}

#define COME_WG_C4(i) "+f"(c[i]), "+f"(c[i + 1]), "+f"(c[i + 2]), "+f"(c[i + 3])
#define COME_WG_C16(i) \
  COME_WG_C4(i), COME_WG_C4(i + 4), COME_WG_C4(i + 8), COME_WG_C4(i + 12)

// c (m64n16, f32) += A . B, both K-major bf16 (warpgroup-wide, async).
static __device__ __forceinline__ void wgmma_n16(float (&c)[8],
                                                 unsigned long long da,
                                                 unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : COME_WG_C4(0), COME_WG_C4(4)
      : "l"(da), "l"(db), "r"(1));
}

// c (m64n128, f32) += A . B, A K-major, B MN-major (transposed).
static __device__ __forceinline__ void wgmma_n128t(float (&c)[64],
                                                   unsigned long long da,
                                                   unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : COME_WG_C16(0), COME_WG_C16(16), COME_WG_C16(32), COME_WG_C16(48)
      : "l"(da), "l"(db), "r"(1));
}

#undef COME_WG_C16
#undef COME_WG_C4

// The A fragment (rows m0.., depth k0..) of M^T and the B fragment (depth
// k0.., columns n0..) of M, for an R-row core-layout matrix M whose rows are
// the depth (mma.sync m16n8k16; ldmatrix .trans, as frag_a<true> and
// frag_b<true> read a row-major matrix).
static __device__ __forceinline__ void frag_a_core_t(unsigned a[4],
                                                     const __nv_bfloat16* m,
                                                     int R, int m0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p =
      m + core_off(R, k0 + 8 * (q >> 1) + r, m0 + 8 * (q & 1));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

static __device__ __forceinline__ void frag_b_core_t(unsigned b[2],
                                                     const __nv_bfloat16* m,
                                                     int R, int n0, int k0) {
  const int lane = threadIdx.x & 15, q = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p = m + core_off(R, k0 + 8 * q + r, n0);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(p)));
}

constexpr int NEGB_SF = NEG_WHOLE + 8;  // tile staging row stride (elements)

// The tile's staged rows (f32 or bf16, stride NEGB_SF elements) into core
// layout (NEG_MS rows, NEG_WHOLE wide), rounded to nearest even (bf16 rows
// as they are): elements of columns >= w are written as zeros.  A thread's
// 4 elements are half a core row; 16 lanes write one 128-byte core matrix,
// the lanes reading a staged row each lie 4 or 8 banks from the next.
template <typename T>
static __device__ __forceinline__ void to_core(__nv_bfloat16* dst,
                                               const T* src, int w) {
  constexpr int RB = NEG_MS / 8;  // row blocks
  for (int e = threadIdx.x; e < NEG_MS * NEG_WHOLE / 4; e += WIDE_THREADS) {
    const int h = e & 1, r8 = (e >> 1) & 7, cm = e >> 4;
    const int i = cm % RB * 8 + r8, c = cm / RB * 8 + 4 * h;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < w) {
      v = load4(src + i * NEGB_SF + c);
      if (c + 1 >= w) v.y = 0.0f;
      if (c + 2 >= w) v.z = 0.0f;
      if (c + 3 >= w) v.w = 0.0f;
    }
    put_bf16(dst + cm * 64 + r8 * 8 + 4 * h, v);
  }
}

// The width of a pool row as the bf16 wide pass reads it: whole slabs.
static __host__ __device__ inline int wide_row(int d) {
  return n_wide_slabs(d) * NEG_WHOLE;
}

// The pool of a bf16 pass past MAX_DIM, staged once per R-block in cneg's
// memory as the pass's ring stages hold it (the TPU's _stage_pool,
// pallas_walk_sgns.py:216, with mxu_bf16 rounding cneg_m): row k =
// table[pool[k]] rounded to bf16 (nearest even; bf16 tables as they are),
// zeros past d; each whole chunk of NEG_KC rows as one block a slab of
// NEG_KC x NEG_WHOLE in core layout, the blocks one after another, and the
// rows of a last, partial chunk after them, wide_row(d) elements each.  KP x
// wide_row(d) bf16 in all: at most the f32 rows' KP x d x 4 bytes for d >
// MAX_DIM, so it fits in cneg.  dneg[k] = 0.  A CTA of the pass then takes
// a whole chunk's slab by one bulk copy, already rounded and in place.
// Like stage_pool_kernel it is bound by the latency of its loads and of the
// launch under PDL, not by its bytes (K3 at d 256: 1 MiB in, 1 MiB of bf16
// rows and 2 MiB of dneg out, 1.25 us at 3.35 TB/s).  So a warp takes one
// row (the grid is KP rows' warps, stage_wide_setup): its id is read before
// the wait, and a lane moves 8-column pieces, every load of a piece (one 16
// bytes of a bf16 row, two of an f32 one; one element at a time where the
// row is not a whole number of them, VEC false) issued before any store.  In
// core layout the 8 columns of a piece are 16 contiguous bytes (core_off),
// so each piece goes out as one 16-byte store, and dneg's zeros as float4
// where d % 4 == 0.  It writes exactly what the one-CTA-a-row kernel it
// replaced wrote.  block STAGE_THREADS.  PDL: the pool ids before the wait
// and the rows after it, as stage_pool_kernel; it does not trigger, so the
// band or star pass after it launches as its CTAs exit.  (With a trigger
// after its stores, K3's wide band pass at d 256, launched while the
// stage's 512 CTAs still held the SMs, took 15.9-16.8 µs a group instead
// of 8.3-8.9: PERF.md §6.)
constexpr int WIDE_STAGE_U = 4;  // pieces of a row a lane loads at once

// Elements c..c+7 of a row widened to f32, zeros past d.
template <typename T, bool VEC>
static __device__ __forceinline__ void load_piece8(const T* row, int c, int d,
                                                   float (&x)[8]) {
  if constexpr (VEC && std::is_same<T, __nv_bfloat16>::value) {  // d % 8 == 0
    if (c >= d) {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.0f;
      return;
    }
    const uint4 w = step_ld(reinterpret_cast<const uint4*>(row + c));
    x[0] = __uint_as_float(w.x << 16), x[1] = __uint_as_float(w.x & 0xffff0000u);
    x[2] = __uint_as_float(w.y << 16), x[3] = __uint_as_float(w.y & 0xffff0000u);
    x[4] = __uint_as_float(w.z << 16), x[5] = __uint_as_float(w.z & 0xffff0000u);
    x[6] = __uint_as_float(w.w << 16), x[7] = __uint_as_float(w.w & 0xffff0000u);
  } else if constexpr (VEC) {  // f32, d % 4 == 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c + 4 * h < d) v = load4(row + c + 4 * h);
      x[4 * h] = v.x, x[4 * h + 1] = v.y, x[4 * h + 2] = v.z;
      x[4 * h + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = c + e < d ? to_f32(step_ld(row + c + e)) : 0.0f;
  }
}

static __device__ __forceinline__ unsigned bf16_pair_rn(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16;
}

template <typename T, bool VEC>
static __global__ void __launch_bounds__(STAGE_THREADS)
stage_pool_bf16_kernel(const T* table, const int* pool,
                       __nv_bfloat16* __restrict__ cnegb,
                       float* __restrict__ dneg, int d, int KP) {
  const int k = blockIdx.x * (STAGE_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int id = k < KP ? step_ld(pool + k) : 0;
  pdl_wait();
  if (k < KP) {
    const int ns = n_wide_slabs(d), wd = ns * NEG_WHOLE, np = wd / 8;
    const int whole = KP / NEG_KC * NEG_KC;  // rows in whole chunks
    const T* row = table + (size_t)id * d;
    for (int q0 = lane; q0 < np; q0 += 32 * WIDE_STAGE_U) {
      float x[WIDE_STAGE_U][8];
#pragma unroll
      for (int u = 0; u < WIDE_STAGE_U; ++u) {
        const int p = q0 + 32 * u;
        if (p < np) load_piece8<T, VEC>(row, 8 * p, d, x[u]);
      }
#pragma unroll
      for (int u = 0; u < WIDE_STAGE_U; ++u) {
        const int p = q0 + 32 * u, c = 8 * p;
        if (p >= np) continue;
        const size_t at =
            k < whole ? ((size_t)(k / NEG_KC) * ns + c / NEG_WHOLE) * NEG_KC *
                                NEG_WHOLE +
                            core_off(NEG_KC, k % NEG_KC, c % NEG_WHOLE)
                      : (size_t)k * wd + c;
        *reinterpret_cast<uint4*>(cnegb + at) = make_uint4(
            bf16_pair_rn(x[u][0], x[u][1]), bf16_pair_rn(x[u][2], x[u][3]),
            bf16_pair_rn(x[u][4], x[u][5]), bf16_pair_rn(x[u][6], x[u][7]));
        if (c >= d) continue;
        float* z = dneg + (size_t)k * d + c;
        if (d % 4 == 0) {
          const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(z) = z4;
          if (c + 4 < d) *reinterpret_cast<float4*>(z + 4) = z4;
        } else {
          for (int e = 0; e < 8 && c + e < d; ++e) z[e] = 0.0f;
        }
      }
    }
  }
  // no trigger: the band pass after it launches as its CTAs exit
}

// Shared memory of the bf16 wide pass: the tile's slab, a 2-stage ring of
// chunks and g (NEG_PMAX chunks' past NEG_WHOLE) in core layout, the
// tile's staged rows (T), nt, 3 mbarriers.
template <typename T>
static inline size_t negative_bf16_wide_smem_bytes(int d) {
  const size_t g = n_wide_slabs(d) > 1 ? NEG_PMAX : 1;
  return 2 * ((size_t)(NEG_MS + 2 * NEG_KC) * NEG_WHOLE +
              g * NEG_MS * NEG_KC) +
         sizeof(T) * NEG_MS * NEGB_SF + sizeof(float) * NEG_MS +
         3 * sizeof(unsigned long long);
}

// What negative_bf16_kernel computes, for any d > MAX_DIM: product operands
// in bf16 (phi, cneg and g rounded to nearest even, as the TPU rounds phi_m,
// cneg_m and gneg_m), every sum in f32.  grid (slots / 64, ny), block
// WIDE_THREADS (two warpgroups); CTA (x, y) takes tile x and pool chunks y,
// y + ny, ....  The tile's rows are held in core layout: bulk copies of
// the table's rows (f32, or bf16 for K3) into a staging, rounded from it;
// past NEG_WHOLE the next slab's rows arrive while the current one is
// read.  The pool is staged as bf16
// once per R-block, a whole chunk's slab as one block in core layout
// (stage_pool_bf16_kernel), so a chunk lands in its ring stage by one bulk
// copy onto the stage's mbarrier (the last, partial chunk by 16-byte
// cp.async): no rounding a CTA, half the bytes of f32 rows.  Measured on
// the H100 (PERF.md §6): a bulk copy holds its issuing warp ≈ 70
// cycles, 16-byte cp.async of a chunk from every thread ≈ 1.2 k cycles, its
// rounding from an f32 staging ≈ 1.5 k.  A chunk on the tensor cores: the scores S = Phi . C^T by 16
// wgmma m64n16k16 in one group (warpgroup h: pool rows 16 h.., both
// operands K-major), g and the loss from S in f32 (g rounded to bf16 into
// shared memory), dphi += G . C by wgmma m64n128k16 (warpgroup h: columns
// 128 h.., A = G K-major, B = the chunk read MN-major; 64 accumulators a
// thread over the CTA's chunks, added once a pass), while dneg = G^T . Phi
// runs on mma.sync m16n8k16 (warp w: pool rows 16 (w & 1).., columns
// 64 (w >> 1)..; ldmatrix .trans from the core layouts), whose M of 16 fits
// the 32-row chunk: wgmma's M is 64.  No divergent code runs while a wgmma
// is in flight: the compiler would fence and serialize every wgmma.  Past
// NEG_WHOLE, sweep A's scores of up to NEG_PMAX chunks stay in registers
// across the slabs, their g in shared memory.  A tile whose slots all have
// nt = 0 returns at once.  PDL as negative_bf16_kernel: ids before the
// wait, every copy and read of nt after it, the trigger once dphi is added.
template <typename T>
static __global__ void __launch_bounds__(WIDE_THREADS, 1)
negative_bf16_wide_kernel(const T* table, const int* ids, const float* nt,
                          const float* cneg, int d, int KP, int ny,
                          float negw, float* __restrict__ dphi,
                          float* __restrict__ dneg,
                          double* __restrict__ stats) {
  extern __shared__ float4 negbw_smem[];
  const int ns = n_wide_slabs(d), wd = wide_row(d);
  const __nv_bfloat16* pool_b = reinterpret_cast<const __nv_bfloat16*>(cneg);
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(negbw_smem);
  __nv_bfloat16* ring = ph + NEG_MS * NEG_WHOLE;  // [2][KC rows] core
  __nv_bfloat16* gb = ring + 2 * NEG_KC * NEG_WHOLE;  // [1 or PMAX][MS rows]
  T* pt = reinterpret_cast<T*>(  // [MS][SF]: the tile's staged rows
      gb + (ns > 1 ? NEG_PMAX : 1) * NEG_MS * NEG_KC);
  float* nts = reinterpret_cast<float*>(pt + NEG_MS * NEGB_SF);  // [MS]
  unsigned long long* bar =  // the tile's, the ring stages'
      reinterpret_cast<unsigned long long*>(nts + NEG_MS);
  __shared__ int rows[NEG_MS];
  const int base = blockIdx.x * NEG_MS, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31, wg = t >> 7, w4 = warp & 3;
  const int fr = lane >> 2, fc = 2 * (lane & 3);  // fragment row, column
  const int nch = (KP + NEG_KC - 1) / NEG_KC, py = blockIdx.y;
  const int m = py < nch ? (nch - 1 - py) / ny + 1 : 0;  // chunks py + k ny
  auto first_row = [&](int k) { return (py + k * ny) * NEG_KC; };  // chunk k's
  const bool vec = d % 4 == 0;  // dphi's and dneg's 16-byte atomics
  const bool vt = d * sizeof(T) % 16 == 0;  // the tile's bulk copies
  if (t < NEG_MS) rows[t] = step_ld(ids + base + t);
  pdl_wait();
  float own = 0.0f;
  if (t < NEG_MS) {
    own = step_ld(nt + base + t);  // the pass just before's output
    nts[t] = own;
  }
  if (!__syncthreads_or(own != 0.0f)) return;  // no slot of the tile scores
  if (t == 0) {
    mbar_init(&bar[0], vt ? 1 : WIDE_THREADS);
    mbar_init(&bar[1], 1);
    mbar_init(&bar[2], 1);
  }
  fence_async_smem();
  __syncthreads();

  // the tile's loads in order: its slabs, twice past NEG_WHOLE (sweeps A, B)
  const int U = ns > 1 ? 2 * ns : 1;
  auto load_tile = [&](int u) {  // into the staging, as T
    const WideSlab sl(u % ns, d);
    copy_rows(pt, NEGB_SF, NEG_MS, sl.w,
              [&](int i) { return table + (size_t)rows[i] * d + sl.s0; },
              &bar[0], vt);
  };
  // the ring's fills in order: (sweep, slab, chunk), sweep A past NEG_WHOLE
  const int F = (ns > 1 ? 2 : 1) * ns * m;
  auto fill = [&](int f) {
    const int s = (f / m) % ns, j0 = first_row(f % m);
    const int n = min(NEG_KC, KP - j0);
    __nv_bfloat16* st = ring + (f & 1) * NEG_KC * NEG_WHOLE;
    constexpr unsigned bytes = 2 * NEG_KC * NEG_WHOLE;
    if (n == NEG_KC) {  // a whole chunk: its slab's block, one bulk copy
      if (t == 0) {
        mbar_expect(&bar[1 + (f & 1)], bytes);
        bulk_copy(st, pool_b + ((size_t)(j0 / NEG_KC) * ns + s) * (bytes / 2),
                  bytes, &bar[1 + (f & 1)]);
      }
      return;
    }
    // the last, partial chunk: 16-byte pieces into place, zeros past KP
    for (int e = t; e < NEG_KC * NEG_WHOLE / 8; e += WIDE_THREADS) {
      const int j = e / (NEG_WHOLE / 8), c = 8 * (e % (NEG_WHOLE / 8));
      if (j < n)
        async_copy16(st + core_off(NEG_KC, j, c),
                     pool_b + (size_t)(j0 + j) * wd + s * NEG_WHOLE + c);
      else
        *reinterpret_cast<float4*>(st + core_off(NEG_KC, j, c)) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    async_copies_wait();
    __syncthreads();
    if (t == 0) mbar_arrive(&bar[1 + (f & 1)]);
  };
  load_tile(0);
  if (F > 0) fill(0);
  if (F > 1) fill(1);
  int f = 0, u = 0;  // fills and tile loads consumed
  // load u of the tile, once landed, into ph; the next load issued into the
  // staging, free again
  auto tile_ready = [&](const WideSlab& sl) {
    mbar_wait(&bar[0], u & 1);
    to_core(ph, pt, sl.w);
    fence_async_smem();
    __syncthreads();
    if (++u < U) load_tile(u);
  };
  // fill f's stage, once landed (its rows past KP zeroed by every thread)
  const __nv_bfloat16* cb = ring;
  auto chunk_ready = [&](int f) {
    mbar_wait(&bar[1 + (f & 1)], (f >> 1) & 1);
    fence_async_smem();
    __syncthreads();
    cb = ring + (f & 1) * NEG_KC * NEG_WHOLE;
  };
  // every read of fill f's stage done: refill it
  auto chunk_done = [&](int f) {
    __syncthreads();
    if (f + 2 < F) fill(f + 2);
  };
  // S[:, 16 wg..] += Phi . C^T over NEG_WHOLE columns (the chunk's past
  // the slab's width are zeros); a fixed count of wgmma with nothing
  // between them, which the compiler keeps in flight together
  auto scores = [&](float (&sv)[8]) {
    wg_pin(sv);
    wg_fence();
#pragma unroll
    for (int k0 = 0; k0 < NEG_WHOLE; k0 += 16)
      wgmma_n16(sv, wg_desc(ph + core_off(NEG_MS, 0, k0), 16 * NEG_MS, 128),
                wg_desc(cb + core_off(NEG_KC, 16 * wg, k0), 16 * NEG_KC, 128));
    wg_commit();
    wg_wait();
    wg_pin(sv);
  };
  // g = sigmoid(s) * w (rounded to bf16 into g) and the loss, of chunk k
  float loss = 0.0f;
  auto put_g = [&](const float (&sv)[8], __nv_bfloat16* g, int k) {
    const int j0 = first_row(k);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // fragment rows fr and fr + 8
        const int i = 16 * w4 + fr + 8 * h, j = 16 * wg + 8 * n + fc;
        const float w = negw * nts[i];
        float gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // no branch: the chains overlap
          const float x = sv[4 * n + 2 * h + e];
          const float wj = j0 + j + e < KP ? w : 0.0f;
          const float ex = expf(-fabsf(x));
          gv[e] = (x >= 0.0f ? 1.0f : ex) / (1.0f + ex) * wj;
          loss -= wj * (fminf(-x, 0.0f) - log1pf(ex));
        }
        *reinterpret_cast<__nv_bfloat162*>(g + core_off(NEG_MS, i, j)) =
            __floats2bfloat162_rn(gv[0], gv[1]);
      }
  };

  // sweep A (past NEG_WHOLE): each chunk's scores summed over the slabs
  float s[NEG_PMAX][8];
#pragma unroll
  for (int k = 0; k < NEG_PMAX; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) s[k][e] = 0.0f;
  if (ns > 1) {
    for (int n = 0; n < ns; ++n) {
      const WideSlab sl(n, d);
      tile_ready(sl);
#pragma unroll
      for (int k = 0; k < NEG_PMAX; ++k) {
        if (k >= m) break;
        chunk_ready(f);
        scores(s[k]);
        chunk_done(f++);
      }
    }
#pragma unroll
    for (int k = 0; k < NEG_PMAX; ++k) {
      if (k >= m) break;
      put_g(s[k], gb + k * NEG_MS * NEG_KC, k);
    }
    fence_async_smem();
  }

  // sweep B (the only one up to NEG_WHOLE): each slab's dphi and dneg
  const int ir = 16 * w4 + fr;
  const bool ok = nts[ir] != 0.0f, ok8 = nts[ir + 8] != 0.0f;
  const int mr = 16 * (warp & 1), n0 = 64 * (warp >> 1);  // dneg's part
  for (int n = 0; n < ns; ++n) {
    const WideSlab sl(n, d);
    tile_ready(sl);  // after the last slab's reads of ph (its last sync)
    float acc[64];  // dphi of rows 16 w4 + fr (+8), columns 128 wg + 8 c + fc
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
    for (int k = 0; k < m; ++k) {
      const int j0 = first_row(k);
      __nv_bfloat16* g = gb + (ns > 1 ? k : 0) * NEG_MS * NEG_KC;
      chunk_ready(f);
      if (ns == 1) {  // the chunk's scores and g
        float sk[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) sk[e] = 0.0f;
        scores(sk);
        put_g(sk, g, k);
        fence_async_smem();
        __syncthreads();  // g complete
      }
      // dphi[:, 128 wg..] += G . C[:, 128 wg..], on the tensor cores
      wg_pin(acc);
      wg_fence();
#pragma unroll
      for (int k0 = 0; k0 < NEG_KC; k0 += 16)
        wgmma_n128t(acc,
                    wg_desc(g + core_off(NEG_MS, 0, k0), 16 * NEG_MS, 128),
                    wg_desc(cb + core_off(NEG_KC, k0, 128 * wg), 128,
                            16 * NEG_KC));
      wg_commit();
      // dneg[j0 + mr.., n0..] += G^T . Phi meanwhile, on mma.sync
      float qd[8][4];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) qd[c][e] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < NEG_MS; k0 += 16) {
        unsigned a[4];
        frag_a_core_t(a, g, NEG_MS, mr, k0);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          unsigned b[2];
          frag_b_core_t(b, ph, NEG_MS, n0 + 8 * c, k0);
          mma_bf16(qd[c], a, b);
        }
      }
      wg_wait();  // before the atomics' divergent code: the compiler
      wg_pin(acc);  // would otherwise serialize every wgmma
      const int jr = j0 + mr + fr;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        red_tile(dneg + (size_t)j0 * d + sl.s0, d, sl.w, vec, mr + fr,
                 jr < KP, jr + 8 < KP, n0 + 8 * c + fc, qd[c]);
      chunk_done(f++);  // and every read of g
    }
#pragma unroll
    for (int c = 0; c < 16; ++c)
      red_tile(dphi + (size_t)base * d + sl.s0, d, sl.w, vec, ir, ok, ok8,
               128 * wg + 8 * c + fc, acc + 4 * c);
  }
  pdl_trigger();
  block_add<WIDE_THREADS>(loss, &stats[0]);
}

// PDL edges need CUDA 12.3 or later where the step is recorded as a graph;
// below it the loops launch without the attribute (come_pdl_enabled()).
#if CUDART_VERSION >= 12030
#define COME_PDL 1
#else
#define COME_PDL 0
#endif

// Launches `kernel` on `stream`, as <<<grid, block, smem, stream>>> would,
// with programmatic dependent launch when `pdl` (and COME_PDL) is set: the
// kernel may then start while the one before it in the stream drains, and
// must keep the rule of this file's note.  `cluster` > 0 launches it in
// clusters of that many CTAs along y.  Returns the launch's error.
template <typename... P, typename... A>
static cudaError_t launch_kernel(void (*kernel)(P...), dim3 grid, dim3 block,
                                 size_t smem, cudaStream_t stream, bool pdl,
                                 int cluster, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  unsigned n = 0;
  if (cluster > 0) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = 1;
    attr[n].val.clusterDim.y = cluster;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl && COME_PDL) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// What sizing a negative pass finds: its grid, block, shared memory and
// pool splits, and (f32) its cluster size.  A recorded step keeps one
// (step_graph.cuh), so the sizing runs once per plan, not per step.
struct NegSetup {
  dim3 grid;
  size_t smem = 0;
  int ny = 1;
  int cluster = 1;  // CTAs along y that merge dphi on chip (f32)
  int threads = NEG_THREADS;  // WIDE_THREADS past MAX_DIM
  // the pool stage's grid and team width (stage_setup), and K3's pool
  // write's (apply_setup): one team a pool row
  int stage_grid = 1, stage_ts = 32;
  int apply_grid = 1, apply_ts = 32;
};

// The pool passes a step's recording launched, by kernel
// (step_graph.cuh: StepGraph::pool): stage_pool_kernel on f32 and on bf16
// tables, every walk and star step's pool_chains_kernel (once a step), K3's
// apply_pool_bf16_kernel, the bf16 passes' stage past MAX_DIM
// (stage_pool_bf16_kernel), and the walk steps' slot passes: the slots'
// chains (slot_chains_kernel, once a step), K3's slot scatter
// (walk_scatter_bf16_kernel, once a group) and the f32 one
// (walk_scatter_kernel, or block_end_scatter_kernel at an R-block end,
// which also writes the pool; walk_sgns.cu), then apply_pool_kernel (no
// step launches it any more: P3's POOL section does, outside a step; the
// slot stays so a step's count can be read as 0), the f32 walk and star
// steps' fold chains (fold_chains_kernel, once a step: which rows a
// block's last group writes through both its slots and its pool), and the
// star steps' slot passes (star_sgns.cu): their slots' chains
// (slot_chains_kernel on the layout's meta, once a step) and their scatter
// (star_scatter_kernel, or star_block_end_scatter_kernel at an R-block
// end, which also writes the pool).
enum PoolPass {
  PASS_STAGE_POOL = 0,
  PASS_STAGE_POOL_BF16_TABLES = 1,
  PASS_POOL_CHAINS = 2,
  PASS_APPLY_POOL_BF16 = 3,
  PASS_STAGE_POOL_BF16 = 4,
  PASS_SLOT_CHAINS = 5,
  PASS_WALK_SCATTER_BF16 = 6,
  PASS_WALK_SCATTER = 7,
  PASS_BLOCK_END_SCATTER = 8,
  PASS_APPLY_POOL = 9,
  PASS_FOLD_CHAINS = 10,
  PASS_STAR_CHAINS = 11,
  PASS_STAR_SCATTER = 12,
  PASS_STAR_BLOCK_END_SCATTER = 13,
  POOL_PASSES = 14
};

// stage_pool_kernel<T, VEC>, the instance a row of d elements takes.
template <typename T>
static inline auto stage_instance(int d) {
  return d % piece_elems<T, true>() == 0 ? stage_pool_kernel<T, true>
                                         : stage_pool_kernel<T, false>;
}

// Sizes the pool stage of KP rows of d elements: one team a row.
template <typename T>
static void stage_setup(NegSetup& s, int d, int KP) {
  const int e = d % piece_elems<T, true>() == 0 ? piece_elems<T, true>() : 1;
  s.stage_ts = pool_team(d, e);
  const int teams = STAGE_THREADS / s.stage_ts;
  s.stage_grid = (KP + teams - 1) / teams;
}

// stage_pool_bf16_kernel<T, VEC>, the instance a row of d elements takes:
// 16-byte loads where the row is a whole number of them.
template <typename T>
static inline auto wide_stage_instance(int d) {
  return d % piece_elems<T, true>() == 0 ? stage_pool_bf16_kernel<T, true>
                                         : stage_pool_bf16_kernel<T, false>;
}

// Sizes the bf16 stage past MAX_DIM of KP rows: a warp a row.
static void stage_wide_setup(NegSetup& s, int KP) {
  s.stage_ts = 32;
  const int teams = STAGE_THREADS / s.stage_ts;
  s.stage_grid = (KP + teams - 1) / teams;
}

// stage_pool_bf16_kernel's launch on `stream` (with PDL when `pdl`), as
// stage_wide_setup sized it: the pool's rows as bf16 core-layout blocks in
// cnegb.
template <typename T>
static cudaError_t launch_stage_wide(const NegSetup& s, const T* table,
                                     const int* pool, __nv_bfloat16* cnegb,
                                     float* dneg, int d, int KP,
                                     cudaStream_t stream, bool pdl) {
  return launch_kernel(wide_stage_instance<T>(d), dim3(s.stage_grid),
                       dim3(STAGE_THREADS), 0, stream, pdl, 0, table, pool,
                       cnegb, dneg, d, KP);
}

// stage_pool_kernel's launch on `stream` (with PDL when `pdl`), as
// stage_setup sized it.
template <typename T>
static cudaError_t launch_stage(const NegSetup& s, const T* table,
                                const int* pool, float* cneg, float* dneg,
                                int d, int KP, cudaStream_t stream, bool pdl) {
  return launch_kernel(stage_instance<T>(d), dim3(s.stage_grid),
                       dim3(STAGE_THREADS), 0, stream, pdl, 0, table, pool,
                       cneg, dneg, d, KP, s.stage_ts);
}

// apply_pool_bf16_kernel<SR, E>, the instance a row of d elements takes.
template <bool SR>
static inline auto apply_instance(int d) {
  return d % 8 == 0 ? apply_pool_bf16_kernel<SR, 8>
                    : apply_pool_bf16_kernel<SR, 2>;
}

// pool_chains_kernel's shared-memory cap (the largest pool's), for pools of
// KP ids: KP past POOL_CHAIN_MAX is refused.
static cudaError_t chains_setup(int KP) {
  if (KP < 1 || KP > POOL_CHAIN_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(pool_chains_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)pool_chain_smem(POOL_CHAIN_MAX));
}

// Sizes K3's pool write of KP rows of d elements (d even), one team a pool
// draw, and its pools' chains (pool_chains_kernel's shared-memory cap).
// KP past POOL_CHAIN_MAX is refused.
static cudaError_t apply_setup(NegSetup& s, int d, int KP) {
  if (d < 2 || d % 2) return cudaErrorInvalidValue;
  const cudaError_t err = chains_setup(KP);
  if (err != cudaSuccess) return err;
  s.apply_ts = pool_team(d, d % 8 == 0 ? 8 : 2);
  const int per = APPLY_THREADS / s.apply_ts;
  s.apply_grid = (KP + per - 1) / per;
  return cudaSuccess;
}

// pool_chains_kernel's launch on `stream`, without PDL: the chains of
// n_pools pools of KP ids into `chains` (info [n_pools][KP][2], then order
// [n_pools][KP]: pool_chain_info, pool_chain_order).
static cudaError_t launch_chains(const int* pools, int n_pools, int KP,
                                 int* chains, cudaStream_t stream) {
  return launch_kernel(pool_chains_kernel, dim3(n_pools),
                       dim3(CHAIN_THREADS), pool_chain_smem(KP), stream,
                       false, 0, pools, KP, chains,
                       chains + (size_t)2 * n_pools * KP);
}

// Where pool b's info and order lie in a `chains` buffer of n_pools pools.
static inline const int* pool_chain_info(const int* chains, int b, int KP) {
  return chains + (size_t)2 * b * KP;
}
static inline const int* pool_chain_order(const int* chains, int b,
                                          int n_pools, int KP) {
  return chains + (size_t)2 * n_pools * KP + (size_t)b * KP;
}

// apply_pool_bf16_kernel's launch on `stream` (with PDL when `pdl`) for
// pool b of the n_pools in `chains`, as apply_setup sized it; lr and the SR
// seed from `args`, or `lr`, `seed` where it is null.
template <bool SR>
static cudaError_t launch_apply_bf16(const NegSetup& s, __nv_bfloat16* table,
                                     const int* pool, const float* dneg,
                                     const int* chains, int b, int n_pools,
                                     int d, int KP, const StepArgs* args,
                                     float lr, unsigned seed, int g,
                                     cudaStream_t stream, bool pdl) {
  return launch_kernel(apply_instance<SR>(d), dim3(s.apply_grid),
                       dim3(APPLY_THREADS), 0, stream, pdl, 0, table, pool,
                       dneg, pool_chain_info(chains, b, KP),
                       pool_chain_order(chains, b, n_pools, KP), d, KP,
                       s.apply_ts, args, lr, seed, g);
}

// Internal linkage for the pass structs (here and in star_pos.cuh): the
// kernels are `static`, so each translation unit has its own copy, and the
// struct's members must launch and set up the copy of their own unit.  With
// external linkage the library's link keeps one definition of each member,
// so an init() from one unit could raise the shared-memory cap of its copy
// while an inlined launch() starts another unit's (cudaErrorInvalidValue).
namespace {

// The negative pass of one instance: init() (checks the shapes, sets the
// kernel's shared memory, sizes the grid), then launch() once per group or
// tile of `nslots` slots.
template <bool BF16, typename T>
struct NegativePass : NegSetup {
  static_assert(BF16 || std::is_same<T, float>::value,
                "bf16 tables take the bf16 pass");

  cudaError_t init(int d, int KP, int nslots) {
    if (d < 1 || KP < 1 || nslots % NEG_MS) return cudaErrorInvalidValue;
    if (!BF16 || d <= MAX_DIM)  // (stage())
      stage_setup<T>(*this, d, KP);
    else
      stage_wide_setup(*this, KP);
    if (d > MAX_DIM) {  // the wide kernels
      threads = WIDE_THREADS;
      // the cap is the kernel's largest shared memory (past NEG_WHOLE), so
      // a plan of one width never lowers it below what another launches
      cudaError_t e;
      if constexpr (BF16) {
        smem = negative_bf16_wide_smem_bytes<T>(d);
        e = size(negative_bf16_wide_kernel<T>,
                 negative_bf16_wide_smem_bytes<T>(NEG_WHOLE + 1), KP, nslots);
      } else {
        smem = negative_f32_wide_smem_bytes(d);
        e = size(negative_f32_wide_kernel,
                 negative_f32_wide_smem_bytes(NEG_WHOLE + 1), KP, nslots);
      }
      if (n_wide_slabs(d) > 1) {  // at most NEG_PMAX chunks a CTA
        const int nch = (KP + NEG_KC - 1) / NEG_KC;
        const int need = (nch + NEG_PMAX - 1) / NEG_PMAX;
        if (ny < need) ny = (need + cluster - 1) / cluster * cluster;
        grid.y = ny;
      }
      return e;
    }
    smem = BF16 ? negative_bf16_smem_bytes(d) : negative_f32_smem_bytes(d);
    // the cap is the template's largest d (128 or MAX_DIM), so plans of
    // other widths on one instance never lower it below what they launch
    const int top = d <= 128 ? 128 : MAX_DIM;
    const size_t cap =
        BF16 ? negative_bf16_smem_bytes(top) : negative_f32_smem_bytes(top);
    if constexpr (BF16)
      return d <= 128 ? size(negative_bf16_kernel<16, T>, cap, KP, nslots)
                      : size(negative_bf16_kernel<24, T>, cap, KP, nslots);
    else
      return d <= 128 ? size(negative_f32_kernel<2>, cap, KP, nslots)
                      : size(negative_f32_kernel<3>, cap, KP, nslots);
  }

  // Sets the kernel's shared-memory cap and sizes the grid to the CTAs of
  // it that fit on the card at once (its occupancy times the SMs; for the
  // f32 pass, whole clusters: a cluster's CTAs share one GPC, so fewer may
  // fit).
  template <typename K>
  cudaError_t size(K kernel, size_t cap, int KP, int nslots) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cap);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (e != cudaSuccess) return e;
    const int tiles = nslots / NEG_MS, nch = (KP + NEG_KC - 1) / NEG_KC;
    ny = neg_pool_splits(tiles, nch, (per_sm > 0 ? per_sm : 1) * sms);
    if constexpr (!BF16) {
      if (threads == WIDE_THREADS) return wide_clusters(kernel, tiles);
      cluster = negf_cluster(ny);
      ny = (ny + cluster - 1) / cluster * cluster;
      int fit = 0;  // clusters of this size that fit on the card at once
      if (cluster > 1) {
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = config(dim3(1, cluster), 0, attr);
        e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
        if (e != cudaSuccess) return e;
      }
      // no more clusters a tile than fit at once (their CTAs walk more chunks)
      if (fit >= tiles && tiles * (ny / cluster) > fit)
        ny = fit / tiles * cluster;
    }
    grid = dim3(tiles, ny);
    return cudaSuccess;
  }

  // The wide f32 pass's clusters (one CTA an SM): the largest of 8, 4, 2
  // CTAs whose clusters all fit on the card at once (a cluster's CTAs share
  // one GPC, whose SMs need not be a multiple of 8), else 1; ny rounded up
  // to a multiple of it.
  template <typename K>
  cudaError_t wide_clusters(K kernel, int tiles) {
    for (int c = NEGF_CMAX; c > 1; c /= 2) {
      if (c > ny) continue;
      const int y = (ny + c - 1) / c * c;
      int fit = 0;
      cluster = c;
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = config(dim3(1, c), 0, attr);
      const cudaError_t e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
      if (e != cudaSuccess) return e;
      if (tiles * (y / c) <= fit) {
        ny = y;
        grid = dim3(tiles, ny);
        return cudaSuccess;
      }
    }
    cluster = 1;
    grid = dim3(tiles, ny);
    return cudaSuccess;
  }

  // The f32 pass's launch: `g` in clusters of `cluster` CTAs along y.
  cudaLaunchConfig_t config(dim3 g, cudaStream_t stream,
                            cudaLaunchAttribute& attr) const {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = g;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = cluster;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  // Stages the pool `pool` (KP rows of `table`) for the pass into cneg and
  // zeroes dneg on `stream` (with PDL when `pdl`): f32 rows
  // (stage_pool_kernel), or bf16 rows for the bf16 pass past MAX_DIM
  // (stage_pool_bf16_kernel).  A launch adds one to
  // launched[PASS_STAGE_POOL, PASS_STAGE_POOL_BF16_TABLES or
  // PASS_STAGE_POOL_BF16] (null: not counted).  Returns the launch's error.
  cudaError_t stage(const T* table, const int* pool, float* cneg, float* dneg,
                    int d, int KP, cudaStream_t stream, bool pdl,
                    int* launched) const {
    const bool wide = BF16 && d > MAX_DIM;
    const cudaError_t e =
        wide ? launch_stage_wide(*this, table, pool,
                                 reinterpret_cast<__nv_bfloat16*>(cneg), dneg,
                                 d, KP, stream, pdl)
             : launch_stage(*this, table, pool, cneg, dneg, d, KP, stream,
                            pdl);
    if (e == cudaSuccess && launched != nullptr)
      ++launched[wide ? PASS_STAGE_POOL_BF16
                 : std::is_same<T, float>::value
                     ? PASS_STAGE_POOL
                     : PASS_STAGE_POOL_BF16_TABLES];
    return e;
  }

  // Launches the pass on `stream` (with PDL when `pdl`); returns the
  // launch's error.
  cudaError_t launch(const T* table, const int* ids, const float* nt,
                     const float* cneg, int d, int KP, float negw, float* dphi,
                     float* dneg, double* stats, cudaStream_t stream,
                     bool pdl = false) const {
    const dim3 b(threads);
    if constexpr (BF16)
      return d > MAX_DIM
                 ? launch_kernel(negative_bf16_wide_kernel<T>, grid, b, smem,
                                 stream, pdl, 0, table, ids, nt, cneg, d, KP,
                                 ny, negw, dphi, dneg, stats)
             : d <= 128
                 ? launch_kernel(negative_bf16_kernel<16, T>, grid, b, smem,
                                 stream, pdl, 0, table, ids, nt, cneg, d, KP,
                                 ny, negw, dphi, dneg, stats)
                 : launch_kernel(negative_bf16_kernel<24, T>, grid, b, smem,
                                 stream, pdl, 0, table, ids, nt, cneg, d, KP,
                                 ny, negw, dphi, dneg, stats);
    else if (d > MAX_DIM)
      return launch_kernel(negative_f32_wide_kernel, grid, b, smem, stream,
                           pdl, cluster, table, ids, nt, cneg, d, KP, ny,
                           negw, dphi, dneg, stats);
    else
      return d <= 128
                 ? launch_kernel(negative_f32_kernel<2>, grid, b, smem, stream,
                                 pdl, cluster, table, ids, nt, cneg, d, KP, ny,
                                 negw, dphi, dneg, stats)
                 : launch_kernel(negative_f32_kernel<3>, grid, b, smem, stream,
                                 pdl, cluster, table, ids, nt, cneg, d, KP, ny,
                                 negw, dphi, dneg, stats);
  }
};

}  // namespace

}  // namespace come

#define COME_CHECK_LAUNCH()                       \
  do {                                            \
    cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)
