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
//     (sgns_common.cuh: NegativePass);
//   * each slot adds -lr*dphi to node_emb[v] and -lr*dctx to ctx_emb[v];
//     a row's slots are summed in f64 and added once (walk_scatter_kernel),
//     which rounds no worse than the TPU's sequential read-modify-writes;
//   * at an R-block end the pool gradient is applied (atomic: pools are
//     drawn with replacement).
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
// The negative pass runs on the tensor cores in the bf16 modes
// (sgns_common.cuh).  Groups keep their order with stream-ordered launches;
// the host makes one call per macro step and the loop over groups runs
// here.  The walks do not depend on the tables, so one launch generates
// every group's walks (one thread per walk) before the group loop, which is
// what the TPU's per-group generation computes.

#include <type_traits>

#include "sgns_common.cuh"

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
template <bool BF16, bool PAIRED, typename T>
static __global__ void __launch_bounds__(THREADS)
walk_pos_kernel(const T* __restrict__ emb_in,
                const T* __restrict__ emb_out,
                const int* __restrict__ walks, const int* __restrict__ wrow,
                int d, int L, int W, float* __restrict__ dphi,
                float* __restrict__ dctx, float* __restrict__ dphin,
                float* __restrict__ nt, double* __restrict__ stats) {
  constexpr bool RND = BF16 && !PAIRED;
  const int t0 = blockIdx.x * STRIP, base = blockIdx.y * BLK;
  if (t0 >= L) {  // padding slots: exact zeros, no pairs
    for (int idx = threadIdx.x; idx < STRIP * d; idx += THREADS) {
      const size_t o = (size_t)(base + t0) * d + idx;
      dphi[o] = 0.0f;
      dctx[o] = 0.0f;
      dphin[o] = 0.0f;
    }
    if (threadIdx.x < STRIP) nt[base + t0 + threadIdx.x] = 0.0f;
    return;
  }
  const int t1 = min(t0 + STRIP, L), no = t1 - t0;  // the strip's centres
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
    rows[r] = walks[base + lo + r];
    wr[r] = PAIRED ? 1 : min(wrow[base + lo + r], W);
  }
  for (int idx = threadIdx.x; idx < 2 * STRIP * RM; idx += THREADS)
    ga[idx] = 0.0f;  // ga and gb
  if (threadIdx.x == 0) npairs = 0;
  __syncthreads();
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

  // the pairs: (centre in the strip, any staged u), then (staged centre
  // outside the strip, u in the strip); a warp appends its pairs with one
  // shared atomic
  const int lane = threadIdx.x & 31;
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
    if (lane == 0 && m) at = atomicAdd(&npairs, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (ok) plist[at + __popc(m & ((1u << lane) - 1))] = rt << 16 | ru;
  }
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
  // n_t: the contexts in t's window inside the walk (PAIRED: its partner)
  float pairs = 0.0f;
  if (threadIdx.x < STRIP) {
    const int t = t0 + threadIdx.x;
    if (t < t1) {
      const int w = wr[t - lo];
      pairs = PAIRED ? 1.0f : (float)(min(L - 1, t + w) - max(0, t - w));
    }
    nt[base + t] = pairs;
  }
  block_add(loss, &stats[0]);
  block_add(pairs, &stats[1]);
}

// emb_in[v] -= lr*(dphi[t] + dphin[t]), emb_out[v] -= lr*dctx[t] for the
// group's real slots (position < L; padded positions carry exactly zero
// updates).  The positive and the negative part add once here, as the plain
// version adds them.  Each term is the f32 product the plain version's
// index_add_ forms; the terms of one row (a walk may repeat a node, and a
// hub fills many slots) are summed in f64, in slot order, by the block of
// the row's first slot, which adds the sum to the row with one rounding.
// Per-term f32 atomics would round each add at the running sum's magnitude,
// in an order that varies from run to run.  Blocks of later slots of a row
// return.  grid GROUP, block SCATTER_THREADS.
constexpr int SCATTER_THREADS = 128;
static __global__ void __launch_bounds__(SCATTER_THREADS)
walk_scatter_kernel(float* __restrict__ emb_in, float* __restrict__ emb_out,
                    const int* __restrict__ walks,
                    const float* __restrict__ dphi,
                    const float* __restrict__ dphin,
                    const float* __restrict__ dctx, int d, int L, float lr) {
  constexpr int NWORD = GROUP / 32;
  __shared__ unsigned same[NWORD];  // bit s: slot s is real and holds v
  __shared__ int first[NWORD];      // slots of the row in words before w
  __shared__ int slots[GROUP];      // the row's slots, in order
  const int t = blockIdx.x, lane = threadIdx.x & 31;
  if (t % BLK >= L) return;
  const int v = walks[t];
  bool earlier = false;
  for (int s = threadIdx.x; s < GROUP; s += SCATTER_THREADS) {
    const bool m = s % BLK < L && walks[s] == v;
    const unsigned b = __ballot_sync(0xffffffffu, m);
    if (lane == 0) same[s / 32] = b;
    earlier |= m && s < t;
  }
  if (__syncthreads_or(earlier)) return;  // not the row's first slot
  if (threadIdx.x < 32) {  // exclusive prefix of the words' counts
    const int c = __popc(same[lane]);
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    first[lane] = x - c;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < GROUP; s += SCATTER_THREADS) {
    const unsigned b = same[s / 32];
    if (b >> lane & 1u)
      slots[first[s / 32] + __popc(b & ((1u << lane) - 1u))] = s;
  }
  __syncthreads();
  const int n = first[NWORD - 1] + __popc(same[NWORD - 1]);
  const size_t dst = (size_t)v * d;
  for (int k = threadIdx.x; k < d; k += SCATTER_THREADS) {
    double a = 0.0, c = 0.0;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const size_t src = (size_t)slots[i] * d + k;
      a += (double)__fmul_rn(__fadd_rn(dphi[src], dphin[src]), -lr);
      c += (double)__fmul_rn(dctx[src], -lr);
    }
    emb_in[dst + k] = (float)((double)emb_in[dst + k] + a);
    emb_out[dst + k] = (float)((double)emb_out[dst + k] + c);
  }
}

// K3's slot writes: for each real slot t of group g (position < L), one
// rounded RMW of emb_in[v] by -lr*(dphi[t] + dphin[t]) and of emb_out[v] by
// -lr*dctx[t]
// per element pair (rmw_bf16_pair; the products by __fmul_rn, as the TPU's
// dphi * (-lr) at :365).  SR draws 32 bits per (t, k) from
// sr_bits(sr_key(seed, g), t*d + k): the low 16 round the node write, the
// high 16 the ctx write (:377-394).  Adds the CAS retries to *retries.
// grid GROUP, block 64.
template <bool SR>
static __global__ void walk_scatter_bf16_kernel(
    __nv_bfloat16* __restrict__ emb_in, __nv_bfloat16* __restrict__ emb_out,
    const int* __restrict__ walks, const float* __restrict__ dphi,
    const float* __restrict__ dphin, const float* __restrict__ dctx, int d,
    int L, float lr, unsigned seed,
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
    n += rmw_bf16_pair(emb_in + dst + k,
                       __fmul_rn(__fadd_rn(dphi[src + k], dphin[src + k]), -lr),
                       __fmul_rn(__fadd_rn(dphi[src + k + 1], dphin[src + k + 1]),
                                 -lr),
                       b0 & 0xffffu,
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
  if (d > MAX_DIM || L < 1 || L > BLK || W < 1 || R < 1 ||
      (PAIRED && (W != 1 || L % 2)) ||
      (TB16 && d % 2))
    return (int)cudaErrorInvalidValue;
  const size_t pos_smem = walk_pos_smem_bytes(d, L, W);
  cudaError_t e = cudaFuncSetAttribute(
      walk_pos_kernel<BF16, PAIRED, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pos_smem);
  if (e != cudaSuccess) return (int)e;
  NegativePass<BF16, T> neg;
  e = neg.init(d, KP, GROUP);
  if (e != cudaSuccess) return (int)e;
  float* dphin = dphi + (size_t)GROUP * d;  // the negative pass's part
  for (int g = 0; g < G; ++g) {
    const int* pool = pools + (size_t)(g / R) * KP;
    const int* wg = walks + (size_t)g * GROUP;
    if (g % R == 0) {
      stage_pool_kernel<T><<<KP, 128, 0, stream>>>(emb_out, pool, cneg, dneg, d);
      COME_CHECK_LAUNCH();
    }
    walk_pos_kernel<BF16, PAIRED, T>
        <<<dim3(NSTRIP, NBLK), THREADS, pos_smem, stream>>>(
            emb_in, emb_out, wg, PAIRED ? nullptr : wrow + (size_t)g * GROUP,
            d, L, W, dphi, dctx, dphin, nt, stats);
    COME_CHECK_LAUNCH();
    neg.launch(emb_in, wg, nt, cneg, d, KP, negw, dphin, dneg, stats, stream);
    COME_CHECK_LAUNCH();
    const bool end = g % R == R - 1 || g == G - 1;
    if constexpr (TB16) {
      walk_scatter_bf16_kernel<SR><<<GROUP, 64, 0, stream>>>(
          emb_in, emb_out, wg, dphi, dphin, dctx, d, L, lr, seed, g, retries);
      COME_CHECK_LAUNCH();
      if (end) {
        apply_pool_bf16_kernel<SR><<<KP, 64, 0, stream>>>(
            emb_out, pool, dneg, d, lr, seed, g, retries);
        COME_CHECK_LAUNCH();
      }
    } else {
      walk_scatter_kernel<<<GROUP, SCATTER_THREADS, 0, stream>>>(
          emb_in, emb_out, wg, dphi, dphin, dctx, d, L, lr);
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
//   dphi            [2, 1024, d] f32 scratch: the positive pass's part of
//                   each slot's update, then the negative pass's
//   dctx            [1024, d] f32 scratch;  nt [1024] f32 scratch
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
