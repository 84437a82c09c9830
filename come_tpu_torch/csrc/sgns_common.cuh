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
// launch it.
//
//   * f32 (negative_f32_kernel: K1, K2, K5, K6, K7): a shared-memory tiled
//     SIMT product in full f32, one CTA per (128-slot block, 64-row pool
//     chunk), partial sums merged by float atomics.  Its checks allow no
//     TF32, so it stays off the tensor cores.
//   * bf16 (negative_bf16_kernel: K1b, K4 with bf16, K2b, P3; K3 on bf16
//     tables): the TPU's mxu_bf16=True mode, where every product operand is
//     bf16 and every sum f32, which is exactly what mma.sync.m16n8k16 bf16
//     with f32 accumulation computes.  A CTA stages 64 slots' rows and each
//     32-row pool chunk as bf16 (half the bytes; 16-byte loads, many in
//     flight per thread) and runs the three products on the tensor cores (4
//     warps of 16 rows), reading the transposed operands of dphi and dneg
//     through ldmatrix .trans instead of keeping transposed copies.  g is
//     made in f32 from the f32 score, rounded to bf16 as the TPU rounds
//     gneg, and kept in shared memory.  A CTA walks several pool chunks,
//     loading the next chunk's rows while it computes the current one, and
//     keeps its dphi in registers across them, so the grid is (slots / 64)
//     x (pool splits), sized to the CTAs that fit on the card at once (3 per
//     SM for d <= 128); dphi and dneg are merged by 16-byte f32 atomics
//     (two lanes pool their mma fragments).  What bounds it on the card is
//     not the mma work but the latency of each chunk's steps and the
//     merging of partial sums (PERF.md).
//
// K3 (bf16 tables) reads rows through to_f32 (the stage kernel and the bf16
// negative kernel are templated on the table's element type) and writes
// them with rmw_bf16_pair: one read-modify-write per slot and element pair,
// each half rounded by its own 16 random bits as the TPU's _pack_row does
// (pallas_walk_sgns.py:76-88), or truncated without them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace come {

constexpr int BLK = 128;       // slots per block (one walk / one star row)
constexpr int GROUP = 1024;    // slots per group (8 blocks), TPU order unit
constexpr int NBLK = GROUP / BLK;
constexpr int KC = 64;         // pool rows per negative-pass CTA
constexpr int THREADS = 256;   // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int KMAX = 8;        // d <= 32 * KMAX for per-lane accumulators
constexpr int MAX_DIM = 192;   // shared-memory bound of the kernels below

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
// 8-byte load of bf16 (c and the row's start a multiple of 4 elements).
static __device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
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
template <int NT, int U, typename T, typename Row>
static __device__ __forceinline__ void load_batch(float4 (&v)[U], int b,
                                                  int nrows, int d, int dp,
                                                  Row row) {
  const int n4 = dp / 4;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int idx = b + NT * u, i = idx / n4, c = 4 * (idx - i * n4);
    v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const T* p = idx < nrows * n4 ? row(i) : nullptr;
    if (p == nullptr || c >= d) continue;
    if (d % 4 == 0) {
      v[u] = load4(p + c);
    } else {
      v[u].x = to_f32(p[c]);
      if (c + 1 < d) v[u].y = to_f32(p[c + 1]);
      if (c + 2 < d) v[u].z = to_f32(p[c + 2]);
      if (c + 3 < d) v[u].w = to_f32(p[c + 3]);
    }
  }
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
                                                  Row row, Store store) {
  for (int b = threadIdx.x; b < nrows * (dp / 4); b += NT * U) {
    float4 v[U];
    load_batch<NT, U, T>(v, b, nrows, d, dp, row);
    store_batch<NT, U>(v, b, nrows, dp, store);
  }
}

// cneg[k] = table[pool[k]] (widened to f32); dneg[k] = 0.
// grid KP, block 128.
template <typename T>
static __global__ void stage_pool_kernel(const T* __restrict__ table,
                                         const int* __restrict__ pool,
                                         float* __restrict__ cneg,
                                         float* __restrict__ dneg, int d) {
  const int k = blockIdx.x;
  const size_t src = (size_t)pool[k] * d, dst = (size_t)k * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    cneg[dst + j] = to_f32(table[src + j]);
    dneg[dst + j] = 0.0f;
  }
}

// table[pool[k]] -= lr * dneg[k], atomic: a pool may repeat a row.
// grid KP, block 128.
static __global__ void apply_pool_kernel(float* __restrict__ table,
                                         const int* __restrict__ pool,
                                         const float* __restrict__ dneg,
                                         int d, float lr) {
  const int k = blockIdx.x;
  const size_t dst = (size_t)pool[k] * d, src = (size_t)k * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    atomicAdd(&table[dst + j], -lr * dneg[src + j]);
}

// K3's pool write at a block end: table[pool[k]] += -lr * dneg[k] as one
// rounded RMW per element pair (rmw_bf16_pair), pool rows in any order
// (a row drawn twice is rounded once per draw).  SR takes the low 16 bits
// of sr_bits(sr_key(seed, g), (GROUP + k) * d + j): the pool has its own
// counter range past the group's 1024 slots (the TPU reads its 1024-row
// draw buffer at row k, pallas_walk_sgns.py:418 against :603, past its end
// for KP > 1024).  Adds the CAS retries to *retries.  grid KP, block 64.
template <bool SR>
static __global__ void apply_pool_bf16_kernel(__nv_bfloat16* __restrict__ table,
                                              const int* __restrict__ pool,
                                              const float* __restrict__ dneg,
                                              int d, float lr, unsigned seed,
                                              int g, double* retries) {
  const int k = blockIdx.x;
  const size_t dst = (size_t)pool[k] * d, src = (size_t)k * d;
  const unsigned key = SR ? sr_key(seed, (unsigned)g) : 0u;
  unsigned n = 0;
  for (int j = 2 * threadIdx.x; j < d; j += 2 * blockDim.x) {
    unsigned r0 = 0, r1 = 0;
    if (SR) {
      const unsigned c = (unsigned)((GROUP + k) * d + j);
      r0 = mix32(c ^ key) & 0xffffu;
      r1 = mix32((c + 1) ^ key) & 0xffffu;
    }
    n += rmw_bf16_pair(table + dst + j, __fmul_rn(dneg[src + j], -lr),
                       __fmul_rn(dneg[src + j + 1], -lr), r0, r1);
  }
  if (n) atomicAdd(retries, (double)n);
}

// Shared-memory bytes of negative_f32_kernel for width d.
static inline size_t negative_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(BLK + KC) * (d + 1) + (size_t)BLK * (KC + 1));
}

// f32 negative pass of one 128-slot block against one KC-row pool chunk.
// grid (blocks, ceil(KP / KC)), block THREADS.
//   phi[i]  = table[ids[i]]           (the slot's staged row)
//   s[i,j]  = phi[i] . cneg[j]
//   g[i,j]  = sigmoid(s) * negw * nt[i]
//   dphi[i] += g[i,:] @ cneg          (atomic: KP / KC chunks add)
//   dneg[j] += g[:,j]^T @ phi         (atomic: every block of the R-block)
// and adds -negw * nt[i] * log(sigmoid(-s)) to stats[0].
// Thread tiles: scores 8 rows x 4 columns; dphi 8 rows x 8 columns and
// dneg 4 rows x 8 columns per 128-column chunk of d.  Rows are stored with
// stride d+1 so column walks by neighbouring threads hit distinct banks.
static __global__ void __launch_bounds__(THREADS)
negative_f32_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids, const float* __restrict__ nt,
                    const float* __restrict__ cneg, int d, int KP, float negw,
                    float* __restrict__ dphi, float* __restrict__ dneg,
                    double* __restrict__ stats) {
  extern __shared__ float smem[];
  const int ds = d + 1;
  float* ph = smem;                 // [BLK][ds]
  float* cn = ph + BLK * ds;        // [KC][ds]
  float* gs = cn + KC * ds;         // [BLK][KC + 1]
  __shared__ float nts[BLK];
  const int base = blockIdx.x * BLK;
  const int j0 = blockIdx.y * KC;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  for (int idx = threadIdx.x; idx < BLK * d; idx += THREADS) {
    const int i = idx / d, k = idx - i * d;
    ph[i * ds + k] = table[(size_t)ids[base + i] * d + k];
  }
  for (int idx = threadIdx.x; idx < KC * d; idx += THREADS) {
    const int j = idx / d, k = idx - j * d;
    cn[j * ds + k] = (j0 + j < KP) ? cneg[(size_t)(j0 + j) * d + k] : 0.0f;
  }
  if (threadIdx.x < BLK) nts[threadIdx.x] = nt[base + threadIdx.x];
  __syncthreads();

  // scores and their gradient weights
  float s[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
  for (int k = 0; k < d; ++k) {
    float a[8], b[4];
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = ph[(ty * 8 + r) * ds + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = cn[(tx + 16 * c) * ds + k];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
  }
  float loss = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty * 8 + r;
    const float w = negw * nts[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      float g = 0.0f;
      if (j0 + j < KP && w != 0.0f) {
        g = sigmoid_f(s[r][c]) * w;
        loss -= w * log_sigmoid_f(-s[r][c]);
      }
      gs[i * (KC + 1) + j] = g;
    }
  }
  __syncthreads();

  for (int kc = 0; kc < d; kc += 128) {
    // dphi[i, k] += sum_j g[i, j] * cneg[j, k]
    float o[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) o[r][c] = 0.0f;
    for (int j = 0; j < KC; ++j) {
      float g[8], cv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) g[r] = gs[(ty * 8 + r) * (KC + 1) + j];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int k = kc + tx + 16 * c;
        cv[c] = (k < d) ? cn[j * ds + k] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) o[r][c] = fmaf(g[r], cv[c], o[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty * 8 + r;
      if (nts[i] == 0.0f) continue;  // no pairs: exactly zero update
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int k = kc + tx + 16 * c;
        if (k < d) atomicAdd(&dphi[(size_t)(base + i) * d + k], o[r][c]);
      }
    }
    // dneg[j, k] += sum_i g[i, j] * phi[i, k]
    float q[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) q[r][c] = 0.0f;
    for (int i = 0; i < BLK; ++i) {
      float g[4], pv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) g[r] = gs[i * (KC + 1) + ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int k = kc + tx + 16 * c;
        pv[c] = (k < d) ? ph[i * ds + k] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) q[r][c] = fmaf(g[r], pv[c], q[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty * 4 + r;
      if (j >= KP) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int k = kc + tx + 16 * c;
        if (k < d) atomicAdd(&dneg[(size_t)j * d + k], q[r][c]);
      }
    }
  }
  block_add(loss, &stats[0]);
}

// ------------------------------------------- bf16 pass on the tensor cores

constexpr int NEG_MS = 64;        // slots per CTA (4 warps x 16 rows)
constexpr int NEG_KC = 32;        // pool rows per chunk
constexpr int NEG_THREADS = 128;

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
static __device__ __forceinline__ void red_tile(float* out, int d, int r,
                                                bool ok_r, bool ok_r8,
                                                int col, const float c[4]) {
  const float x0 = __shfl_xor_sync(0xffffffffu, c[0], 1);
  const float x1 = __shfl_xor_sync(0xffffffffu, c[1], 1);
  const float x2 = __shfl_xor_sync(0xffffffffu, c[2], 1);
  const float x3 = __shfl_xor_sync(0xffffffffu, c[3], 1);
  if (d % 4 == 0) {
    const bool odd = threadIdx.x & 1;
    const int row = odd ? r + 8 : r, c0 = odd ? col - 2 : col;
    if ((odd ? ok_r8 : ok_r) && c0 < d)
      atomicAdd(reinterpret_cast<float4*>(out + (size_t)row * d + c0),
                odd ? make_float4(x2, x3, c[2], c[3])
                    : make_float4(c[0], c[1], x0, x1));
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (col + e >= d) continue;
    if (ok_r) atomicAdd(out + (size_t)r * d + col + e, c[e]);
    if (ok_r8) atomicAdd(out + (size_t)(r + 8) * d + col + e, c[2 + e]);
  }
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
// the current one is computed.
template <int NTILE, typename T>
static __global__ void __launch_bounds__(NEG_THREADS, NTILE == 16 ? 3 : 2)
negative_bf16_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                     const float* __restrict__ nt,
                     const float* __restrict__ cneg, int d, int KP, int ny,
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
  // a row's 4 elements rounded to bf16, one 8-byte store
  auto put = [](__nv_bfloat16* m, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(m) = u;
  };
  constexpr int CU = NTILE / 2;  // a chunk's pieces per thread
  float4 next[CU];
  load_batch<NEG_THREADS, CU, float>(next, threadIdx.x, NEG_KC, d, dp,
                                     pool_row(blockIdx.y));

  if (threadIdx.x < NEG_MS) {
    rows[threadIdx.x] = ids[base + threadIdx.x];
    nts[threadIdx.x] = nt[base + threadIdx.x];
  }
  __syncthreads();
  stage_rows<NEG_THREADS, 8, T>(
      NEG_MS, d, dp, [&](int i) { return table + (size_t)rows[i] * d; },
      [&](int i, int c, float4 v) { put(ph + i * sa + c, v); });

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
        [&](int j, int c, float4 v) { put(cn + j * sa + c, v); });
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
  block_add<NEG_THREADS>(loss, &stats[0]);
}

// The negative pass of one instance: init() once per call (checks the
// shapes, sets the kernel's shared memory, sizes the grid), then launch()
// once per group or tile of `nslots` slots.
template <bool BF16, typename T>
struct NegativePass {
  static_assert(BF16 || std::is_same<T, float>::value,
                "bf16 tables take the bf16 pass");
  dim3 grid;
  size_t smem = 0;
  int ny = 1;

  cudaError_t init(int d, int KP, int nslots) {
    if (d < 1 || d > MAX_DIM || KP < 1) return cudaErrorInvalidValue;
    if constexpr (BF16) {
      if (nslots % NEG_MS) return cudaErrorInvalidValue;
      smem = negative_bf16_smem_bytes(d);
      int dev = 0, sms = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
      // as many CTAs as fit at once (3 per SM for d <= 128, 2 above), each
      // walking `per` chunks of the pool
      const int fit = (d <= 128 ? 3 : 2) * sms;
      const int tiles = nslots / NEG_MS, nch = (KP + NEG_KC - 1) / NEG_KC;
      const int per = (nch * tiles + fit - 1) / fit;
      ny = (nch + per - 1) / per;
      grid = dim3(tiles, ny);
      return d <= 128 ? set_smem(negative_bf16_kernel<16, T>)
                      : set_smem(negative_bf16_kernel<24, T>);
    } else {
      if (nslots % BLK) return cudaErrorInvalidValue;
      smem = negative_smem_bytes(d);
      grid = dim3(nslots / BLK, (KP + KC - 1) / KC);
      return set_smem(negative_f32_kernel);
    }
  }

  template <typename K>
  cudaError_t set_smem(K kernel) const {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }

  void launch(const T* table, const int* ids, const float* nt,
              const float* cneg, int d, int KP, float negw, float* dphi,
              float* dneg, double* stats, cudaStream_t stream) const {
    if constexpr (BF16) {
      if (d <= 128)
        negative_bf16_kernel<16, T><<<grid, NEG_THREADS, smem, stream>>>(
            table, ids, nt, cneg, d, KP, ny, negw, dphi, dneg, stats);
      else
        negative_bf16_kernel<24, T><<<grid, NEG_THREADS, smem, stream>>>(
            table, ids, nt, cneg, d, KP, ny, negw, dphi, dneg, stats);
    } else {
      negative_f32_kernel<<<grid, THREADS, smem, stream>>>(
          table, ids, nt, cneg, d, KP, negw, dphi, dneg, stats);
    }
  }
};

}  // namespace come

#define COME_CHECK_LAUNCH()                       \
  do {                                            \
    cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)
