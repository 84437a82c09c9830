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
// Past MAX_DIM both work in column slabs (negative_f32_slab_kernel,
// negative_bf16_slab_kernel; see the note at SLAB).
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
// them with rmw_bf16_pair: one read-modify-write per slot and element pair,
// each half rounded by its own 16 random bits as the TPU's _pack_row does
// (pallas_walk_sgns.py:76-88), or truncated without them.
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
// before it has.  So what a kernel does before its wait may touch only
// what the kernel just before it neither writes nor reads (atomic adds to
// stats excepted: they commute), and a trigger makes no write visible:
// only the wait does.  In the walk and star loops that is what the step's
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
// pass runs beside it; the bf16 pass triggers once its dphi is merged, and
// the other kernels once their last write is issued.  Each kernel's note
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
constexpr int MAX_DIM = 192;   // the widest d whose rows the passes stage
                               // whole; past it they work in column slabs

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

// p[0] += u0, p[1] += u1 on a bf16 pair (4-byte aligned) as one atomic
// read-modify-write: each half is widened exactly to f32, the update added
// in f32 (__fadd_rn: no contraction with the caller's product), and the
// sum written back as (bits + r) >> 16 with r < 2^16 (stochastic rounding;
// r = 0 truncates).  Returns the number of CAS retries (other threads
// writing the same pair in between).
static __device__ __forceinline__ unsigned rmw_bf16_pair(__nv_bfloat16* p,
                                                         float u0, float u1,
                                                         unsigned r0,
                                                         unsigned r1) {
  unsigned* a = reinterpret_cast<unsigned*>(p);
  unsigned old = *reinterpret_cast<volatile unsigned*>(a), retries = 0;
  while (true) {
    const float lo = __uint_as_float(old << 16);
    const float hi = __uint_as_float(old & 0xffff0000u);
    const unsigned nlo = (__float_as_uint(__fadd_rn(lo, u0)) + r0) >> 16;
    const unsigned nhi = (__float_as_uint(__fadd_rn(hi, u1)) + r1) >> 16;
    const unsigned prev = atomicCAS(a, old, nlo | (nhi << 16));
    if (prev == old) return retries;
    old = prev;
    ++retries;
  }
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

// Column slabs.  Past MAX_DIM the band, star and negative passes, f32 and
// bf16 (their whole rows would not fit in shared memory, nor a warp's dphi
// in registers), stage their rows SLAB columns
// at a time: a row pointer then points at the slab's first column, d is
// the slab's width w (the last slab may be narrower), and 16-byte accesses
// need the table's d % 4 == 0 (`vec`), not w's.  Each pass sweeps the
// slabs twice: once to sum every dot product's slab parts (sweep A), then,
// with the coefficients made from the sums, once more to form each slab's
// part of the updates (sweep B), re-reading the rows from L2.
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

// cneg[k] = table[pool[k]] (widened to f32); dneg[k] = 0.
// grid KP, block 128.  PDL: the pool id (the call's, staged by the head
// kernel, two or more kernels before) is read before the wait; the table
// row (the last scatter's) and cneg/dneg (the last block's passes) after.
template <typename T>
static __global__ void stage_pool_kernel(const T* table, const int* pool,
                                         float* __restrict__ cneg,
                                         float* __restrict__ dneg, int d) {
  const int k = blockIdx.x;
  const size_t src = (size_t)step_ld(pool + k) * d, dst = (size_t)k * d;
  pdl_wait();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    cneg[dst + j] = to_f32(step_ld(table + src + j));
    dneg[dst + j] = 0.0f;
  }
  pdl_trigger();
}

// table[pool[k]] -= lr * dneg[k], atomic: a pool may repeat a row; lr from
// the argument block `args` (null: `lr`).  grid KP, block 128.  PDL: the
// pool id and lr (the head's) before the wait; dneg (the negative pass's)
// and the table row (the scatter's) after.
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

// K3's pool write at a block end: table[pool[k]] += -lr * dneg[k] as one
// rounded RMW per element pair (rmw_bf16_pair), pool rows in any order
// (a row drawn twice is rounded once per draw).  SR takes the low 16 bits
// of sr_bits(sr_key(seed, g), (GROUP + k) * d + j): the pool has its own
// counter range past the group's 1024 slots (the TPU reads its 1024-row
// draw buffer at row k, pallas_walk_sgns.py:418 against :603, past its end
// for KP > 1024).  lr and seed from the argument block.  Adds the CAS
// retries to *retries.  grid KP, block 64.  PDL: as apply_pool_kernel.
template <bool SR>
static __global__ void apply_pool_bf16_kernel(__nv_bfloat16* table,
                                              const int* pool,
                                              const float* dneg, int d,
                                              const StepArgs* args, int g,
                                              double* retries) {
  const int k = blockIdx.x;
  const size_t dst = (size_t)step_ld(pool + k) * d, src = (size_t)k * d;
  const float lr = step_ld(&args->lr);
  const unsigned key = SR ? sr_key(step_ld(&args->seed), (unsigned)g) : 0u;
  pdl_wait();
  unsigned n = 0;
  for (int j = 2 * threadIdx.x; j < d; j += 2 * blockDim.x) {
    unsigned r0 = 0, r1 = 0;
    if (SR) {
      const unsigned c = (unsigned)((GROUP + k) * d + j);
      r0 = mix32(c ^ key) & 0xffffu;
      r1 = mix32((c + 1) ^ key) & 0xffffu;
    }
    n += rmw_bf16_pair(table + dst + j,
                       __fmul_rn(step_ld(dneg + src + j), -lr),
                       __fmul_rn(step_ld(dneg + src + j + 1), -lr), r0, r1);
  }
  pdl_trigger();
  if (n) atomicAdd(retries, (double)n);
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

// ------------------------------------------ f32 pass in column slabs

// The slab form of the f32 pass (d > MAX_DIM): a CTA walks at most
// NEGS_PMAX pool chunks, since it keeps every chunk's g in shared memory
// between its two sweeps; the sizing raises the pool splits to that.
constexpr int NEGS_PMAX = 4;

static inline size_t negative_slab_smem_bytes() {
  return sizeof(float) * ((size_t)(NEG_MS + NEG_KC) * SLAB_STRIDE +
                          NEGS_PMAX * NEG_KC * NEGF_GT + NEG_MS);
}

// What negative_f32_kernel computes, for any d, with the rows staged one
// column slab at a time (SLAB columns; see the note at SLAB).  A CTA takes
// the 64-slot tile blockIdx.x and its m <= NEGS_PMAX pool chunks
// blockIdx.y, blockIdx.y + ny, ...:
//   sweep A, for each slab: the tile's rows staged, then each chunk's rows
//     staged in turn, and each chunk's [64 x 32] score tile takes the
//     slab's part, held in registers (thread t's 4 x 4 scores are
//     negative_f32_kernel's);
//   g and the loss from the whole scores, kept by pool row in shared
//     memory, one [32][64 + 4] tile a chunk;
//   sweep B, for each slab: the tile's rows and each chunk's re-staged;
//     the slab's columns of dphi accumulate over the chunks in registers,
//     and of each chunk's dneg are added atomically, once per chunk; then
//     the cluster merges the slab's dphi partials as negative_f32_kernel
//     merges its (f64 sums in rank order, one add a slot and column).
// Thread tiles: dphi of slots 8 rg + r (r < 8) and dneg of pool rows 4 rg
// + r (r < 4) at the slab's columns 4 cg + 64 p (p < 2), as NP = 2.  grid
// (slots / 64, ny), block NEG_THREADS, clusters of C along y.  A tile
// whose slots all have nt = 0 returns at once.  PDL as negative_f32_kernel.
static __global__ void __launch_bounds__(NEG_THREADS, 2)
negative_f32_slab_kernel(const float* table,
                         const int* ids,
                         const float* nt,
                         const float* cneg, int d, int KP,
                         int ny, float negw, float* __restrict__ dphi,
                         float* __restrict__ dneg,
                         double* __restrict__ stats) {
  extern __shared__ float4 negs_smem[];
  constexpr int sa = SLAB_STRIDE;
  float* ph = reinterpret_cast<float*>(negs_smem);  // [MS][sa]: a slab
  float* cn = ph + NEG_MS * sa;                     // [KC][sa]: a slab
  float* gt = cn + NEG_KC * sa;      // [PMAX][KC][GT]: g by pool row
  float* nts = gt + NEGS_PMAX * NEG_KC * NEGF_GT;  // [MS]
  __shared__ int rows[NEG_MS];
  const int base = blockIdx.x * NEG_MS, t = threadIdx.x;
  const int nch = (KP + NEG_KC - 1) / NEG_KC;
  const int py = blockIdx.y;  // this CTA's pool split: chunks py, py + ny..
  const int m = py < nch ? (nch - 1 - py) / ny + 1 : 0;
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
  auto stage_ph = [&](const Slab& sl) {
    stage_rows<NEG_THREADS, 8, float>(
        NEG_MS, sl.w, sl.wp,
        [&](int i) { return table + (size_t)rows[i] * d + sl.s0; },
        [&](int i, int c, float4 v) {
          *reinterpret_cast<float4*>(ph + i * sa + c) = v;
        },
        vec);
  };
  auto stage_cn = [&](int ch, const Slab& sl) {
    stage_rows<NEG_THREADS, 4, float>(
        NEG_KC, sl.w, sl.wp,
        [&](int j) {
          const int k = ch * NEG_KC + j;
          return k < KP ? cneg + (size_t)k * d + sl.s0 : nullptr;
        },
        [&](int j, int c, float4 v) {
          *reinterpret_cast<float4*>(cn + j * sa + c) = v;
        },
        vec);
  };
  const int sr = t >> 3, sc = t & 7, rg = t >> 4, cg = t & 15;
  const int ns = n_slabs(d);

  // sweep A: scores of slots 4 sr + r against pool rows sc + 8 c of each
  // chunk, summed over the slabs
  float s[NEGS_PMAX][4][4];
#pragma unroll
  for (int k = 0; k < NEGS_PMAX; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[k][r][c] = 0.0f;
  for (int n = 0; n < ns; ++n) {
    const Slab sl(n, d);
    __syncthreads();  // the last slab's reads of ph
    stage_ph(sl);
#pragma unroll
    for (int k = 0; k < NEGS_PMAX; ++k) {
      if (k >= m) break;
      __syncthreads();  // ph staged; the last chunk's reads of cn
      stage_cn(py + k * ny, sl);
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < sl.wp; kk += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[r] = *reinterpret_cast<const float4*>(ph + (4 * sr + r) * sa + kk);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          b[c] = *reinterpret_cast<const float4*>(cn + (sc + 8 * c) * sa + kk);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[k][r][c] = fmaf(a[r].x, b[c].x, s[k][r][c]);
            s[k][r][c] = fmaf(a[r].y, b[c].y, s[k][r][c]);
            s[k][r][c] = fmaf(a[r].z, b[c].z, s[k][r][c]);
            s[k][r][c] = fmaf(a[r].w, b[c].w, s[k][r][c]);
          }
      }
    }
  }
  // g = sigmoid(s) * w and the loss -w * log(sigmoid(-s)), by pool row
  float loss = 0.0f;
#pragma unroll
  for (int k = 0; k < NEGS_PMAX; ++k) {
    if (k >= m) break;
    const int j0 = (py + k * ny) * NEG_KC;
    float* g = gt + k * NEG_KC * NEGF_GT;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float w = negw * nts[4 * sr + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = s[k][r][c];
        const float wj = j0 + sc + 8 * c < KP ? w : 0.0f;
        const float ex = expf(-fabsf(x));
        s[k][r][c] = (x >= 0.0f ? 1.0f : ex) / (1.0f + ex) * wj;
        loss -= wj * (fminf(-x, 0.0f) - log1pf(ex));
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(g + (sc + 8 * c) * NEGF_GT + 4 * sr) =
          make_float4(s[k][0][c], s[k][1][c], s[k][2][c], s[k][3][c]);
  }

  // sweep B: each slab's columns of dphi and dneg
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  for (int n = 0; n < ns; ++n) {
    const Slab sl(n, d);
    __syncthreads();  // g written; the last slab's merge read ph
    stage_ph(sl);
    float4 acc[8][2];  // dphi of slots 8 rg + r
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p) acc[r][p] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < m; ++k) {
      const int j0 = (py + k * ny) * NEG_KC;
      const float* g = gt + k * NEG_KC * NEGF_GT;
      __syncthreads();  // ph staged; the last chunk's reads of cn
      stage_cn(py + k * ny, sl);
      __syncthreads();
      // dphi[8 rg + r, cols] += G[8 rg + r, chunk] . C[chunk, cols]
#pragma unroll 4
      for (int j = 0; j < NEG_KC; ++j) {
        const float4 g0 =
            *reinterpret_cast<const float4*>(g + j * NEGF_GT + 8 * rg);
        const float4 g1 =
            *reinterpret_cast<const float4*>(g + j * NEGF_GT + 8 * rg + 4);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int c = 4 * cg + 64 * p;
          if (c >= sl.wp) break;
          const float4 cv = *reinterpret_cast<const float4*>(cn + j * sa + c);
#pragma unroll
          for (int r = 0; r < 8; ++r) fma4(gv[r], cv, acc[r][p]);
        }
      }
      // dneg[j0 + 4 rg + r, cols] += G^T[., tile] . Phi[tile, cols]
      float4 qv[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int p = 0; p < 2; ++p) qv[r][p] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = 0; i < NEG_MS; ++i) {
        float gv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = g[(4 * rg + r) * NEGF_GT + i];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int c = 4 * cg + 64 * p;
          if (c >= sl.wp) break;
          const float4 pv = *reinterpret_cast<const float4*>(ph + i * sa + c);
#pragma unroll
          for (int r = 0; r < 4; ++r) fma4(gv[r], pv, qv[r][p]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + 4 * rg + r;
        if (j >= KP) continue;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int c = 4 * cg + 64 * p;
          if (c < sl.wp)
            atomic_add4(dneg + (size_t)j * d + sl.s0, sl.w, c, qv[r][p], vec);
        }
      }
    }
    // the cluster's partials of the slab's dphi, summed on chip
    __syncthreads();  // the reads of ph
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = 4 * cg + 64 * p;
        if (c < sl.wp)
          *reinterpret_cast<float4*>(ph + (8 * rg + r) * sa + c) = acc[r][p];
      }
    cluster.sync();
    const int rows_q = NEG_MS / C, n4 = sl.wp / 4;
    for (int idx = t; idx < rows_q * n4; idx += NEG_THREADS) {
      const int i = q * rows_q + idx / n4, c = 4 * (idx % n4);
      if (nts[i] == 0.0f) continue;  // no pairs: exactly zero update
      float4 v[NEGF_CMAX];
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
    cluster.sync();  // no CTA restages ph while another reads its partial
  }
  block_add<NEG_THREADS>(loss, &stats[0]);
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

// ------------------------------------------ bf16 pass in column slabs

// Staged bf16 slab rows: SLAB + 8 elements apart (an odd multiple of 16
// bytes, as neg_dp's strides), g by slot NEG_KC + 8 apart.
constexpr int NEGB_SA = SLAB + 8;
constexpr int NEGB_SK = NEG_KC + 8;

static inline size_t negative_bf16_slab_smem_bytes() {
  return 2 * ((size_t)(NEG_MS + NEG_KC) * NEGB_SA +
              NEGS_PMAX * NEG_MS * NEGB_SK) +
         sizeof(float) * NEG_MS;
}

// What negative_bf16_kernel computes, for any d, with the rows staged one
// column slab at a time (SLAB columns; see the note at SLAB), in the
// structure of negative_f32_slab_kernel.  A CTA takes the 64-slot tile
// blockIdx.x and its m <= NEGS_PMAX pool chunks blockIdx.y, blockIdx.y +
// ny, ...:
//   sweep A, for each slab: the tile's rows staged as bf16, then each
//     chunk's in turn, and each chunk's score fragments take the slab's
//     part by mma.m16n8k16 into f32 accumulators held across the slabs
//     (warp w: slots 16w.., 4 x 4 floats a chunk), so no partial score is
//     rounded: the sum is the one f32 sum the TPU's bf16-operand product
//     forms, its slab parts added in column order as the whole-row loop
//     adds its k-steps;
//   g and the loss from the whole scores, g rounded to bf16 as the TPU
//     rounds gneg and kept by slot in shared memory, one [64][32 + 8]
//     tile a chunk;
//   sweep B, for each slab: the tile's rows and each chunk's re-staged;
//     the slab's columns of the warp's dphi accumulate over the chunks in
//     registers in negative_bf16_kernel's NTILE 16 form (SLAB = 128
//     columns) and are added once, after the last chunk; each chunk's dneg
//     of the slab is added atomically, once per chunk.
// Only the slabs are staged, so shared memory is 47 KB at every d.  (Whole
// bf16 rows would fit well past 192, 72 KB for 96 rows at d 384, but not
// at any d, and dphi would still need slabs: its registers are the limit.)
// A ragged last slab is zero-padded to the mma depth (16) in shared memory.
// grid (slots / 64, ny), block NEG_THREADS.  A tile whose slots all have
// nt = 0 returns at once.  PDL as negative_bf16_kernel: it triggers once
// the last slab's dphi is added.
template <typename T>
static __global__ void __launch_bounds__(NEG_THREADS, 3)
negative_bf16_slab_kernel(const T* table,
                          const int* ids,
                          const float* nt,
                          const float* cneg, int d, int KP,
                          int ny, float negw, float* __restrict__ dphi,
                          float* __restrict__ dneg,
                          double* __restrict__ stats) {
  extern __shared__ float4 negb_smem[];
  constexpr int sa = NEGB_SA, sk = NEGB_SK;
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(negb_smem);  // [MS][sa]
  __nv_bfloat16* cn = ph + NEG_MS * sa;                              // [KC][sa]
  __nv_bfloat16* gs = cn + NEG_KC * sa;  // [PMAX][MS][sk]: g by slot
  float* nts = reinterpret_cast<float*>(gs + NEGS_PMAX * NEG_MS * sk);
  __shared__ int rows[NEG_MS];
  const int base = blockIdx.x * NEG_MS, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int fr = lane >> 2, fc = 2 * (lane & 3);  // fragment row, column
  const int nch = (KP + NEG_KC - 1) / NEG_KC;
  const int py = blockIdx.y;  // this CTA's pool split: chunks py, py + ny..
  const int m = py < nch ? (nch - 1 - py) / ny + 1 : 0;
  const bool vec = d % 4 == 0;
  if (t < NEG_MS) rows[t] = step_ld(ids + base + t);
  pdl_wait();
  float own = 0.0f;
  if (t < NEG_MS) {
    own = step_ld(nt + base + t);  // the pass just before's output
    nts[t] = own;
  }
  if (!__syncthreads_or(own != 0.0f)) return;  // no slot of the tile scores
  // a slab's columns, zero-padded to the mma depth
  auto depth = [](const Slab& sl) { return (sl.w + 15) & ~15; };
  auto stage_ph = [&](const Slab& sl) {
    stage_rows<NEG_THREADS, 8, T>(
        NEG_MS, sl.w, depth(sl),
        [&](int i) { return table + (size_t)rows[i] * d + sl.s0; },
        [&](int i, int c, float4 v) { put_bf16(ph + i * sa + c, v); }, vec);
  };
  auto stage_cn = [&](int ch, const Slab& sl) {
    stage_rows<NEG_THREADS, 4, float>(
        NEG_KC, sl.w, depth(sl),
        [&](int j) {
          const int k = ch * NEG_KC + j;
          return k < KP ? cneg + (size_t)k * d + sl.s0 : nullptr;
        },
        [&](int j, int c, float4 v) { put_bf16(cn + j * sa + c, v); }, vec);
  };
  const int ns = n_slabs(d), r0 = 16 * warp;

  // sweep A: scores of the warp's 16 slots against each chunk's 32 rows,
  // summed over the slabs
  float s[NEGS_PMAX][NEG_KC / 8][4];
#pragma unroll
  for (int k = 0; k < NEGS_PMAX; ++k)
#pragma unroll
    for (int n = 0; n < NEG_KC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[k][n][e] = 0.0f;
  for (int n = 0; n < ns; ++n) {
    const Slab sl(n, d);
    const int dk = depth(sl);
    __syncthreads();  // the last slab's reads of ph
    stage_ph(sl);
#pragma unroll
    for (int k = 0; k < NEGS_PMAX; ++k) {
      if (k >= m) break;
      __syncthreads();  // ph staged; the last chunk's reads of cn
      stage_cn(py + k * ny, sl);
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < SLAB; k0 += 16) {
        if (k0 >= dk) break;
        unsigned a[4];
        frag_a<false>(a, ph, sa, r0, k0);
#pragma unroll
        for (int c = 0; c < NEG_KC / 8; ++c) {
          unsigned b[2];
          frag_b<false>(b, cn, sa, 8 * c, k0);
          mma_bf16(s[k][c], a, b);
        }
      }
    }
  }
  // g = sigmoid(s) * w and the loss -w * log(sigmoid(-s)), by slot
  float loss = 0.0f;
#pragma unroll
  for (int k = 0; k < NEGS_PMAX; ++k) {
    if (k >= m) break;
    const int j0 = (py + k * ny) * NEG_KC;
    __nv_bfloat16* g = gs + k * NEG_MS * sk;
#pragma unroll
    for (int c = 0; c < NEG_KC / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // fragment rows fr and fr + 8
        const int i = r0 + fr + 8 * h, j = 8 * c + fc;
        const float w = negw * nts[i];
        float gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[k][c][2 * h + e];
          const float wj = j0 + j + e < KP ? w : 0.0f;
          const float ex = expf(-fabsf(x));
          gv[e] = (x >= 0.0f ? 1.0f : ex) / (1.0f + ex) * wj;
          loss -= wj * (fminf(-x, 0.0f) - log1pf(ex));
        }
        *reinterpret_cast<__nv_bfloat162*>(g + i * sk + j) =
            __floats2bfloat162_rn(gv[0], gv[1]);
      }
  }

  // sweep B: each slab's columns of dphi and dneg
  const int ir = r0 + fr;
  const bool ok = nts[ir] != 0.0f, ok8 = nts[ir + 8] != 0.0f;
  const int mr = 16 * (warp & 1);  // dneg: the chunk rows of this warp
  for (int n = 0; n < ns; ++n) {
    const Slab sl(n, d);
    const int ntiles = depth(sl) / 8, half = ntiles / 2;
    const int n0 = (warp >> 1) * half;  // dneg: this warp's column tiles
    __syncthreads();  // g written; the last slab's reads of ph
    stage_ph(sl);
    float acc[SLAB / 8][4];  // the slab's dphi of the warp's 16 rows
#pragma unroll
    for (int c = 0; c < SLAB / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
    for (int k = 0; k < m; ++k) {
      const int j0 = (py + k * ny) * NEG_KC;
      const __nv_bfloat16* g = gs + k * NEG_MS * sk;
      __syncthreads();  // ph staged; the last chunk's reads of cn
      stage_cn(py + k * ny, sl);
      __syncthreads();
      // dphi[r0.., slab] += G[r0.., chunk] . C[chunk, slab]
#pragma unroll
      for (int k0 = 0; k0 < NEG_KC; k0 += 16) {
        unsigned a[4];
        frag_a<false>(a, g, sk, r0, k0);
#pragma unroll
        for (int c = 0; c < SLAB / 8; ++c) {
          if (c >= ntiles) break;
          unsigned b[2];
          frag_b<true>(b, cn, sa, 8 * c, k0);
          mma_bf16(acc[c], a, b);
        }
      }
      // dneg[chunk rows mr.., this warp's slab columns] += G^T . Phi
      float q[SLAB / 16][4];
#pragma unroll
      for (int c = 0; c < SLAB / 16; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) q[c][e] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < NEG_MS; k0 += 16) {
        unsigned a[4];
        frag_a<true>(a, g, sk, mr, k0);
#pragma unroll
        for (int c = 0; c < SLAB / 16; ++c) {
          if (c >= half) break;
          unsigned b[2];
          frag_b<true>(b, ph, sa, 8 * (n0 + c), k0);
          mma_bf16(q[c], a, b);
        }
      }
      const int jr = j0 + mr + fr;
#pragma unroll
      for (int c = 0; c < SLAB / 16; ++c) {
        if (c >= half) break;
        red_tile(dneg + (size_t)j0 * d + sl.s0, d, sl.w, vec, mr + fr,
                 jr < KP, jr + 8 < KP, 8 * (n0 + c) + fc, q[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < SLAB / 8; ++c) {
      if (c >= ntiles) break;
      red_tile(dphi + (size_t)base * d + sl.s0, d, sl.w, vec, ir, ok, ok8,
               8 * c + fc, acc[c]);
    }
  }
  pdl_trigger();
  block_add<NEG_THREADS>(loss, &stats[0]);
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

// What sizing a negative pass finds: its grid, shared memory and pool
// splits, and (f32) its cluster size.  A recorded step keeps one
// (step_graph.cuh), so the sizing runs once per plan, not per step.
struct NegSetup {
  dim3 grid;
  size_t smem = 0;
  int ny = 1;
  int cluster = 1;  // CTAs along y that merge dphi on chip (f32)
};

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
    if (d > MAX_DIM) {  // column slabs, at most NEGS_PMAX chunks a CTA
      // the slab kernels' shared memory is the same at every d, so the cap
      // a plan of one width sets serves every other
      cudaError_t e;
      if constexpr (BF16) {
        smem = negative_bf16_slab_smem_bytes();
        e = size(negative_bf16_slab_kernel<T>, smem, KP, nslots);
      } else {
        smem = negative_slab_smem_bytes();
        e = size(negative_f32_slab_kernel, smem, KP, nslots);
      }
      const int nch = (KP + NEG_KC - 1) / NEG_KC;
      const int need = (nch + NEGS_PMAX - 1) / NEGS_PMAX;
      if (ny < need) ny = (need + cluster - 1) / cluster * cluster;
      grid.y = ny;
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
                                                        NEG_THREADS, smem);
    if (e != cudaSuccess) return e;
    const int tiles = nslots / NEG_MS, nch = (KP + NEG_KC - 1) / NEG_KC;
    ny = neg_pool_splits(tiles, nch, (per_sm > 0 ? per_sm : 1) * sms);
    if constexpr (!BF16) {
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

  // The f32 pass's launch: `g` in clusters of `cluster` CTAs along y.
  cudaLaunchConfig_t config(dim3 g, cudaStream_t stream,
                            cudaLaunchAttribute& attr) const {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = g;
    cfg.blockDim = dim3(NEG_THREADS);
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

  // Launches the pass on `stream` (with PDL when `pdl`); returns the
  // launch's error.
  cudaError_t launch(const T* table, const int* ids, const float* nt,
                     const float* cneg, int d, int KP, float negw, float* dphi,
                     float* dneg, double* stats, cudaStream_t stream,
                     bool pdl = false) const {
    const dim3 b(NEG_THREADS);
    if constexpr (BF16)
      return d > MAX_DIM
                 ? launch_kernel(negative_bf16_slab_kernel<T>, grid, b, smem,
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
      return launch_kernel(negative_f32_slab_kernel, grid, b, smem, stream,
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
