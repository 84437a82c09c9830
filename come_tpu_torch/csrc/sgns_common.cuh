// Pieces shared by the two SGNS kernels (walk_sgns.cu, star_sgns.cu).
//
// Both TPU kernels end the same way: every staged slot scores all KP rows
// of a shared negative pool (weight negw * n_t, n_t = the slot's positive
// pair count), the pool is staged once per R-group block, its gradient
// accumulates over the block and is applied at the block end, and every
// slot's update is added back into its table row.  The device functions and
// kernels here are `static`, so each translation unit keeps its own copy.
//
// Card bound: the negative pass is [128 x KP] x d multiply-adds three times
// per 128-slot block (scores, dphi, dneg) and is compute; the gathers and
// the atomic scatter are row traffic (2 x d x 4 bytes per slot).  This
// first design runs the negative pass as a shared-memory tiled f32 SIMT
// product, one CTA per (128-slot block, 64-row pool chunk), and merges the
// partial sums with float atomics.
//
// The BF16 instance of negative_kernel is the TPU kernels' mxu_bf16=True
// mode (pallas_walk_sgns.py:344-360, pallas_star_sgns.py:117, :167-180):
// every product operand is rounded to bf16 (round to nearest even) where
// the TPU casts it to mxu_t, and every sum stays f32.  A product of two
// bf16 values is exact in f32, so only the order of the f32 sums differs
// from the TPU.  The rounding costs a few conversions per staged element;
// the pass stays SIMT (a bf16 tensor-core pass is a later speed step).
//
// K3 (bf16 tables) reads rows through to_f32 (the stage and negative
// kernels are templated on the table's element type; their f32 instances
// are K1's, K2's, K6's and K7's, unchanged) and writes them with
// rmw_bf16_pair: one read-modify-write per slot and element pair, each
// half rounded by its own 16 random bits as the TPU's _pack_row does
// (pallas_walk_sgns.py:76-88), or truncated without them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Sum `v` over the CTA (all THREADS threads must call) and add the total
// to `*dst` from thread 0.
static __device__ void block_add(float v, double* dst) {
  __shared__ float part[NWARPS];
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < NWARPS; ++w) s += part[w];
    atomicAdd(dst, s);
  }
  __syncthreads();
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

// Shared-memory floats of negative_kernel for width d.
static inline size_t negative_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(BLK + KC) * (d + 1) + (size_t)BLK * (KC + 1));
}

// Negative pass of one 128-slot block against one KC-row pool chunk.
// grid (blocks, ceil(KP / KC)), block THREADS.
//   phi[i]  = table[ids[i]]           (the slot's staged row)
//   s[i,j]  = phi[i] . cneg[j]
//   g[i,j]  = sigmoid(s) * negw * nt[i]
//   dphi[i] += g[i,:] @ cneg          (atomic: KP / KC chunks add)
//   dneg[j] += g[:,j]^T @ phi         (atomic: every block of the R-block)
// and adds -negw * nt[i] * log(sigmoid(-s)) to stats[0].  BF16 rounds phi
// and cneg as they are staged and g after the multiply by negw * nt, as
// the TPU rounds phi_m, cneg_m and gneg_m; the loss takes the f32 s.
// Thread tiles: scores 8 rows x 4 columns; dphi 8 rows x 8 columns and
// dneg 4 rows x 8 columns per 128-column chunk of d.  Rows are stored with
// stride d+1 so column walks by neighbouring threads hit distinct banks.
template <bool BF16, typename T>
static __global__ void __launch_bounds__(THREADS)
negative_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                const float* __restrict__ nt, const float* __restrict__ cneg,
                int d, int KP, float negw, float* __restrict__ dphi,
                float* __restrict__ dneg, double* __restrict__ stats) {
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
    ph[i * ds + k] = mxu<BF16>(to_f32(table[(size_t)ids[base + i] * d + k]));
  }
  for (int idx = threadIdx.x; idx < KC * d; idx += THREADS) {
    const int j = idx / d, k = idx - j * d;
    cn[j * ds + k] =
        (j0 + j < KP) ? mxu<BF16>(cneg[(size_t)(j0 + j) * d + k]) : 0.0f;
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
        g = mxu<BF16>(sigmoid_f(s[r][c]) * w);
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

}  // namespace come

#define COME_CHECK_LAUNCH()                       \
  do {                                            \
    cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)
