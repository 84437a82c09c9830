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
//          per occurrence, as the TPU's sequential slot loop does, here by
//          a 32-bit atomicCAS per bf16 pair in any order.  The draws are a
//          counter hash (sgns_common.cuh: mix32), not the TPU's PRNG, so
//          the plain version rounds alike.  The TPU's u32 row-pair packing
//          exists only for VMEM indexing and is not ported.
// Semantics are the TPU kernel's, group by group in order: for each group
// of 8 walks (1024 slots, walk j at slots j*128 .. j*128+L-1) the rows are
// read from the tables as the previous group left them, and
//   * at an R-block start the pool rows are staged and dneg is zeroed;
//   * centre t trains contexts u of its own walk with 0 < |u-t| <= wrow[t]
//     (u, t < L): g = sigmoid(phi_t . ctx_u) - 1, dphi_t += g ctx_u,
//     dctx_u += g phi_t, n_t = number of such u;
//   * every slot scores the staged pool with weight negw * n_t
//     (sgns_common.cuh: negative_kernel);
//   * each slot adds -lr*dphi to node_emb[v] and -lr*dctx to ctx_emb[v]
//     with atomicAdd, so duplicate rows sum exactly as the TPU's
//     sequential read-modify-writes do (in another order);
//   * at an R-block end the pool gradient is applied (atomic: pools are
//     drawn with replacement).
// The window draws come in as `wrow` (the TPU drew them in-kernel), so the
// kernel, its plain PyTorch version and the numpy oracle see the same ones.
//
// What bounds it on the H100: the negative pass (3 x 128 x KP x d
// multiply-adds per walk) is compute; the positive band is at most 2W
// dot products per centre and is small; the gathers and the scatter are
// row traffic (halved by K3's bf16 rows); walk generation is 79 dependent
// CSR loads per walk.  This first design computes only the band entries
// the mask keeps (warp per centre, lanes across d), runs the negative pass as a tiled SIMT product
// over 8 x ceil(KP/64) CTAs per group (bf16 by rounding its operands, not
// on tensor cores), and keeps the group-sequential order with
// stream-ordered launches; the host makes one call per macro step and the
// loop over groups runs here.  The walks do not depend on the tables, so
// one launch generates every group's walks (one thread per walk) before the
// group loop, which is what the TPU's per-group generation computes.

#include <type_traits>

#include "sgns_common.cuh"

namespace come {

static inline size_t walk_pos_smem_bytes(int d, int W) {
  return sizeof(float) * ((size_t)2 * BLK * (d + 1) + (size_t)BLK * (2 * W + 1));
}

// Positive band of one walk.  grid NBLK (one CTA per walk), block THREADS.
// Writes (overwrites) dphi, dctx and nt for the walk's 128 slots and adds
// the positive loss and the pair count to stats.  BF16 rounds the staged
// rows and each g (not with PAIRED: the TPU's paired pass is f32); PAIRED
// trains only u = t^1 (W must be 1, wrow is not read).  T is the tables'
// element type.
template <bool BF16, bool PAIRED, typename T>
static __global__ void __launch_bounds__(THREADS)
walk_pos_kernel(const T* __restrict__ emb_in,
                const T* __restrict__ emb_out,
                const int* __restrict__ walks, const int* __restrict__ wrow,
                int d, int L, int W, float* __restrict__ dphi,
                float* __restrict__ dctx, float* __restrict__ nt,
                double* __restrict__ stats) {
  constexpr bool RND = BF16 && !PAIRED;
  extern __shared__ float smem[];
  const int ds = d + 1, bw = 2 * W + 1;
  float* phi = smem;             // [BLK][ds]
  float* ctx = phi + BLK * ds;   // [BLK][ds]
  float* gb = ctx + BLK * ds;    // [BLK][2W+1]: g[t, u] at gb[t*bw + u-t+W]
  const int base = blockIdx.x * BLK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < BLK * d; idx += THREADS) {
    const int t = idx / d, k = idx - t * d;
    const size_t row = (size_t)walks[base + t] * d + k;
    phi[t * ds + k] = mxu<RND>(to_f32(emb_in[row]));
    ctx[t * ds + k] = mxu<RND>(to_f32(emb_out[row]));
  }
  for (int idx = threadIdx.x; idx < BLK * bw; idx += THREADS) gb[idx] = 0.0f;
  __syncthreads();

  float loss = 0.0f, pairs = 0.0f;
  for (int t = warp; t < BLK; t += NWARPS) {
    float acc[KMAX];
#pragma unroll
    for (int m = 0; m < KMAX; ++m) acc[m] = 0.0f;
    int n = 0;
    if (t < L) {
      const int w = PAIRED ? 1 : min(wrow[base + t], W);
      const int lo = max(0, t - w), hi = min(L - 1, t + w);
      for (int u = lo; u <= hi; ++u) {
        if (u == t || (PAIRED && u != (t ^ 1))) continue;
        float p = 0.0f;
#pragma unroll
        for (int m = 0; m < KMAX; ++m) {
          const int k = lane + 32 * m;
          if (k < d) p = fmaf(phi[t * ds + k], ctx[u * ds + k], p);
        }
        const float s = warp_sum(p);
        const float g = mxu<RND>(sigmoid_f(s) - 1.0f);
        if (lane == 0) {
          gb[t * bw + (u - t + W)] = g;
          loss -= log_sigmoid_f(s);
        }
#pragma unroll
        for (int m = 0; m < KMAX; ++m) {
          const int k = lane + 32 * m;
          if (k < d) acc[m] = fmaf(g, ctx[u * ds + k], acc[m]);
        }
        ++n;
      }
    }
#pragma unroll
    for (int m = 0; m < KMAX; ++m) {
      const int k = lane + 32 * m;
      if (k < d) dphi[(size_t)(base + t) * d + k] = acc[m];
    }
    if (lane == 0) {
      nt[base + t] = (float)n;
      pairs += (float)n;
    }
  }
  __syncthreads();  // the whole band of g is in gb

  // dctx[u] = sum_t g[t, u] phi[t]  (gb is zero outside each t's window;
  // PAIRED: only t = u^1 has u in its band)
  for (int u = warp; u < BLK; u += NWARPS) {
    float acc[KMAX];
#pragma unroll
    for (int m = 0; m < KMAX; ++m) acc[m] = 0.0f;
    if (u < L) {
      const int lo = max(0, u - W), hi = min(L - 1, u + W);
      for (int t = lo; t <= hi; ++t) {
        if (t == u || (PAIRED && t != (u ^ 1))) continue;
        const float g = gb[t * bw + (u - t + W)];
#pragma unroll
        for (int m = 0; m < KMAX; ++m) {
          const int k = lane + 32 * m;
          if (k < d) acc[m] = fmaf(g, phi[t * ds + k], acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < KMAX; ++m) {
      const int k = lane + 32 * m;
      if (k < d) dctx[(size_t)(base + u) * d + k] = acc[m];
    }
  }
  block_add(loss, &stats[0]);
  block_add(pairs, &stats[1]);
}

// emb_in[v] -= lr*dphi[t], emb_out[v] -= lr*dctx[t] for the group's real
// slots (position < L; padded positions carry exactly zero updates).
// grid GROUP, block 128.
static __global__ void walk_scatter_kernel(float* __restrict__ emb_in,
                                           float* __restrict__ emb_out,
                                           const int* __restrict__ walks,
                                           const float* __restrict__ dphi,
                                           const float* __restrict__ dctx,
                                           int d, int L, float lr) {
  const int t = blockIdx.x;
  if (t % BLK >= L) return;
  const size_t dst = (size_t)walks[t] * d, src = (size_t)t * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    atomicAdd(&emb_in[dst + k], -lr * dphi[src + k]);
    atomicAdd(&emb_out[dst + k], -lr * dctx[src + k]);
  }
}

// K3's slot writes: for each real slot t of group g (position < L), one
// rounded RMW of emb_in[v] by -lr*dphi[t] and of emb_out[v] by -lr*dctx[t]
// per element pair (rmw_bf16_pair; the products by __fmul_rn, as the TPU's
// dphi * (-lr) at :365).  SR draws 32 bits per (t, k) from
// sr_bits(sr_key(seed, g), t*d + k): the low 16 round the node write, the
// high 16 the ctx write (:377-394).  Adds the CAS retries to *retries.
// grid GROUP, block 64.
template <bool SR>
static __global__ void walk_scatter_bf16_kernel(
    __nv_bfloat16* __restrict__ emb_in, __nv_bfloat16* __restrict__ emb_out,
    const int* __restrict__ walks, const float* __restrict__ dphi,
    const float* __restrict__ dctx, int d, int L, float lr, unsigned seed,
    int g, double* retries) {
  const int t = blockIdx.x;
  if (t % BLK >= L) return;
  const size_t dst = (size_t)walks[t] * d, src = (size_t)t * d;
  const unsigned key = SR ? sr_key(seed, (unsigned)g) : 0u;
  unsigned n = 0;
  for (int k = 2 * threadIdx.x; k < d; k += 2 * blockDim.x) {
    unsigned b0 = 0, b1 = 0;
    if (SR) {
      const unsigned c = (unsigned)(t * d + k);
      b0 = mix32(c ^ key);
      b1 = mix32((c + 1) ^ key);
    }
    n += rmw_bf16_pair(emb_in + dst + k, __fmul_rn(dphi[src + k], -lr),
                       __fmul_rn(dphi[src + k + 1], -lr), b0 & 0xffffu,
                       b1 & 0xffffu);
    n += rmw_bf16_pair(emb_out + dst + k, __fmul_rn(dctx[src + k], -lr),
                       __fmul_rn(dctx[src + k + 1], -lr), b0 >> 16, b1 >> 16);
  }
  if (n) atomicAdd(retries, (double)n);
}

// Walk generation (TPU GEN_WALKS, pallas_walk_sgns.py:182-201).  One thread
// per walk w of nwalks: slot w*128 holds starts[w]; hop t (1 <= t < L)
// reads b = bits[w*128 + t] as 32 bits and moves from v to
//   indices[indptr[v] + min(int(u * float(deg)), max(deg - 1, 0))],
//   u = float((b >> 8) & 0xFFFFFF) * 2^-24   (both products in f32),
// and a node of degree 0 stays where it is.  Slots at positions >= L are 0.
// grid ceil(nwalks / 128), block 128.
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

// The group loop shared by both C entries.  T = float: K1/K1b/K5 (atomic
// f32 scatter); T = __nv_bfloat16: K3 (rounded RMW scatter, SR with a
// per-step seed).  `retries` collects K3's CAS retries.
template <bool BF16, bool PAIRED, typename T, bool SR>
static int walk_groups(T* emb_in, T* emb_out, const int* walks,
                       const int* wrow, const int* pools, double* stats,
                       float* cneg, float* dneg, float* dphi, float* dctx,
                       float* nt, int d, int G, int L, int W, int KP, int R,
                       float lr, float negw, unsigned seed, double* retries,
                       cudaStream_t stream) {
  constexpr bool TB16 = !std::is_same<T, float>::value;
  if (d > MAX_DIM || L > BLK || W < 1 || R < 1 || (PAIRED && (W != 1 || L % 2)) ||
      (TB16 && d % 2))
    return (int)cudaErrorInvalidValue;
  const size_t pos_smem = walk_pos_smem_bytes(d, W);
  const size_t neg_smem = negative_smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      walk_pos_kernel<BF16, PAIRED, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pos_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(negative_kernel<BF16, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)neg_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 neg_grid(NBLK, (KP + KC - 1) / KC);
  for (int g = 0; g < G; ++g) {
    const int* pool = pools + (size_t)(g / R) * KP;
    const int* wg = walks + (size_t)g * GROUP;
    if (g % R == 0) {
      stage_pool_kernel<T><<<KP, 128, 0, stream>>>(emb_out, pool, cneg, dneg, d);
      COME_CHECK_LAUNCH();
    }
    walk_pos_kernel<BF16, PAIRED, T><<<NBLK, THREADS, pos_smem, stream>>>(
        emb_in, emb_out, wg, PAIRED ? nullptr : wrow + (size_t)g * GROUP, d,
        L, W, dphi, dctx, nt, stats);
    COME_CHECK_LAUNCH();
    negative_kernel<BF16, T><<<neg_grid, THREADS, neg_smem, stream>>>(
        emb_in, wg, nt, cneg, d, KP, negw, dphi, dneg, stats);
    COME_CHECK_LAUNCH();
    const bool end = g % R == R - 1 || g == G - 1;
    if constexpr (TB16) {
      walk_scatter_bf16_kernel<SR><<<GROUP, 64, 0, stream>>>(
          emb_in, emb_out, wg, dphi, dctx, d, L, lr, seed, g, retries);
      COME_CHECK_LAUNCH();
      if (end) {
        apply_pool_bf16_kernel<SR><<<KP, 64, 0, stream>>>(
            emb_out, pool, dneg, d, lr, seed, g, retries);
        COME_CHECK_LAUNCH();
      }
    } else {
      walk_scatter_kernel<<<GROUP, 128, 0, stream>>>(emb_in, emb_out, wg,
                                                     dphi, dctx, d, L, lr);
      COME_CHECK_LAUNCH();
      if (end) {
        apply_pool_kernel<<<KP, 128, 0, stream>>>(emb_out, pool, dneg, d, lr);
        COME_CHECK_LAUNCH();
      }
    }
  }
  return 0;
}

// Dispatch on the runtime modes: tables_bf16 (K3, with sr) excludes
// paired and implies K1b's rounding.
static int walk_groups_mode(int bf16, int paired, int tables_bf16, int sr,
                            void* emb_in, void* emb_out, const int* walks,
                            const int* wrow, const int* pools, double* stats,
                            double* retries, float* cneg, float* dneg,
                            float* dphi, float* dctx, float* nt, int d, int G,
                            int L, int W, int KP, int R, float lr, float negw,
                            unsigned seed, cudaStream_t stream) {
#define COME_WALK_GROUPS(B, P, T, S)                                          \
  walk_groups<B, P, T, S>((T*)emb_in, (T*)emb_out, walks, wrow, pools, stats, \
                          cneg, dneg, dphi, dctx, nt, d, G, L, W, KP, R, lr,  \
                          negw, seed, retries, stream)
  if (tables_bf16) {
    if (paired) return (int)cudaErrorInvalidValue;
    return sr ? COME_WALK_GROUPS(true, false, __nv_bfloat16, true)
              : COME_WALK_GROUPS(true, false, __nv_bfloat16, false);
  }
  if (paired)
    return bf16 ? COME_WALK_GROUPS(true, true, float, false)
                : COME_WALK_GROUPS(false, true, float, false);
  return bf16 ? COME_WALK_GROUPS(true, false, float, false)
              : COME_WALK_GROUPS(false, false, float, false);
#undef COME_WALK_GROUPS
}

}  // namespace come

using namespace come;

// One walk-kernel macro step over G groups.  All buffers are device
// pointers:
//   emb_in, emb_out [V, d] f32, or bf16 with tables_bf16 (updated in place)
//   walks           [G * 1024] i32 (walk j of group g at g*1024 + j*128)
//   wrow            [G * 1024] i32 window draws (not read when paired)
//   pools           [ceil(G / R), KP] i32
//   stats           [2] f64, accumulates (loss, pairs)
//   retries         [1] f64, accumulates K3's CAS retries (not read by K1,
//                   K1b, K5)
//   cneg, dneg      [KP, d] f32 scratch
//   dphi, dctx      [1024, d] f32 scratch;  nt [1024] f32 scratch
// bf16 != 0 selects K1b's rounding, paired != 0 K5 (W must be 1, L even),
// tables_bf16 != 0 K3 (d even; stochastic rounding from sr_seed when
// sr != 0, else truncation).  Returns 0 or the first CUDA error code.
// Launches on `stream`, does not synchronise and allocates nothing.
extern "C" int come_walk_sgns_step(void* emb_in, void* emb_out,
                                   const int* walks, const int* wrow,
                                   const int* pools, double* stats,
                                   double* retries, float* cneg, float* dneg,
                                   float* dphi, float* dctx, float* nt, int d,
                                   int G, int L, int W, int KP, int R,
                                   int bf16, int paired, int tables_bf16,
                                   int sr, unsigned sr_seed, float lr,
                                   float negw, void* stream_ptr) {
  return walk_groups_mode(bf16, paired, tables_bf16, sr, emb_in, emb_out,
                          walks, wrow, pools, stats, retries, cneg, dneg,
                          dphi, dctx, nt, d, G, L, W, KP, R, lr, negw,
                          sr_seed, (cudaStream_t)stream_ptr);
}

// K4: generate the walks of G groups into `slots` [G * 1024] i32 from
// starts [G * 8] i32, bits [G * 1024] u32 and the CSR (indptr [V + 1],
// indices [E] i32), then run the group loop on them (bf16, tables_bf16,
// sr as above).  Other buffers as come_walk_sgns_step.
extern "C" int come_walk_sgns_gen_step(void* emb_in, void* emb_out,
                                       const int* starts, const unsigned* bits,
                                       const int* indptr, const int* indices,
                                       int* slots, const int* wrow,
                                       const int* pools, double* stats,
                                       double* retries, float* cneg,
                                       float* dneg, float* dphi, float* dctx,
                                       float* nt, int d, int G, int L, int W,
                                       int KP, int R, int bf16,
                                       int tables_bf16, int sr,
                                       unsigned sr_seed, float lr, float negw,
                                       void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (L < 1 || L > BLK) return (int)cudaErrorInvalidValue;
  const int nwalks = G * NBLK;
  walk_gen_kernel<<<(nwalks + 127) / 128, 128, 0, stream>>>(
      starts, bits, indptr, indices, nwalks, L, slots);
  COME_CHECK_LAUNCH();
  return walk_groups_mode(bf16, 0, tables_bf16, sr, emb_in, emb_out, slots,
                          wrow, pools, stats, retries, cneg, dneg, dphi, dctx,
                          nt, d, G, L, W, KP, R, lr, negw, sr_seed, stream);
}
