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
// (4 x d x 4 bytes per pair).  This design reuses the walk and star
// kernels' f32 negative pass (sgns_common.cuh: ceil(TP/128) x 2 tiles of 64
// slots per tile of pairs, their pool chunks spread to fill the card; the
// masked tail's all-empty tiles return at once), computes the positive
// scores one warp per pair with lanes across
// d (TP/8 CTAs, so the row loads of many pairs are in flight at once), and
// keeps the tile order with stream-ordered launches; the host makes one
// call per micro-step and the loop over tiles runs here.  The table
// pointers are not __restrict__: K7 passes one table as both.

#include "sgns_common.cuh"

namespace come {

// Positive term of one tile, one warp per pair.  grid ceil(TP/128) * 128 /
// NWARPS, block THREADS; rows i >= TP of the last 128-row chunk are
// written as empty (nt = 0).  Overwrites dphi, dcpos and nt, zeroes dphin
// (which the negative pass then adds to), and adds the positive loss and the
// pair count to stats.
static __global__ void __launch_bounds__(THREADS)
fused_pos_kernel(const float* emb_in, const float* emb_out,
                 const int* __restrict__ c, const int* __restrict__ x,
                 const int* __restrict__ m, int d, int TP,
                 float* __restrict__ dphi, float* __restrict__ dcpos,
                 float* __restrict__ dphin, float* __restrict__ nt,
                 double* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const bool valid = i < TP && m[i] != 0;  // warp-uniform
  float ph[KMAX], cp[KMAX];
  float p = 0.0f, loss = 0.0f, pairs = 0.0f, g = 0.0f;
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    const int k = lane + 32 * q;
    ph[q] = cp[q] = 0.0f;
    if (valid && k < d) {
      ph[q] = emb_in[(size_t)c[i] * d + k];
      cp[q] = emb_out[(size_t)x[i] * d + k];
      p = fmaf(ph[q], cp[q], p);
    }
  }
  if (valid) {
    const float s = warp_sum(p);
    g = sigmoid_f(s) - 1.0f;
    if (lane == 0) {
      loss = -log_sigmoid_f(s);
      pairs = 1.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    const int k = lane + 32 * q;
    if (k < d) {
      dphi[(size_t)i * d + k] = g * cp[q];
      dcpos[(size_t)i * d + k] = g * ph[q];
      dphin[(size_t)i * d + k] = 0.0f;
    }
  }
  if (lane == 0) nt[i] = valid ? 1.0f : 0.0f;
  block_add(loss, &stats[0]);
  block_add(pairs, &stats[1]);
}

// emb_in[c[i]] -= lr*(dphi[i] + dphin[i]), emb_out[x[i]] -= lr*dcpos[i] for
// the tile's valid pairs (the positive and the negative part of dphi add
// once here, as the plain version adds them).  grid TP, block 128.
static __global__ void fused_scatter_kernel(float* emb_in, float* emb_out,
                                            const int* __restrict__ c,
                                            const int* __restrict__ x,
                                            const float* __restrict__ dphi,
                                            const float* __restrict__ dphin,
                                            const float* __restrict__ dcpos,
                                            const float* __restrict__ nt,
                                            int d, float lr) {
  const int i = blockIdx.x;
  if (nt[i] == 0.0f) return;
  const size_t ci = (size_t)c[i] * d, xi = (size_t)x[i] * d,
               src = (size_t)i * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    atomicAdd(&emb_in[ci + k], -lr * (dphi[src + k] + dphin[src + k]));
    atomicAdd(&emb_out[xi + k], -lr * dcpos[src + k]);
  }
}

// The micro-step over n_tiles tiles; emb_in == emb_out for K7.
//   c, x, m  [n_tiles * TP + 128] i32 (pairs zero-padded; the extra 128
//            ids keep the negative pass's last 128-row chunk in range)
//   pool     [KP] i32;  stats [2] f64, accumulates (loss, pairs)
//   cneg, dneg [KP, d] f32 scratch
//   dphi       [2, ceil(TP/128)*128, d] f32 scratch: the positive part of
//              each pair's centre update, then the negative pass's
//   dcpos [ceil(TP/128)*128, d], nt [ceil(TP/128)*128] f32 scratch
static int fused_sgns(float* emb_in, float* emb_out, const int* c,
                      const int* x, const int* m, const int* pool,
                      double* stats, float* cneg, float* dneg, float* dphi,
                      float* dcpos, float* nt, int d, int n_tiles, int TP,
                      int KP, float lr, float negw, cudaStream_t stream) {
  if (d > MAX_DIM || d < 1 || TP < 1 || KP < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (TP + BLK - 1) / BLK;
  NegativePass<false, float> neg;
  cudaError_t e = neg.init(d, KP, chunks * BLK);
  if (e != cudaSuccess) return (int)e;
  float* dphin = dphi + (size_t)chunks * BLK * d;  // the negative pass's part
  stage_pool_kernel<<<KP, 128, 0, stream>>>(emb_out, pool, cneg, dneg, d);
  COME_CHECK_LAUNCH();
  for (int t = 0; t < n_tiles; ++t) {
    const size_t off = (size_t)t * TP;
    fused_pos_kernel<<<chunks * BLK / NWARPS, THREADS, 0, stream>>>(
        emb_in, emb_out, c + off, x + off, m + off, d, TP, dphi, dcpos, dphin,
        nt, stats);
    COME_CHECK_LAUNCH();
    neg.launch(emb_in, c + off, nt, cneg, d, KP, negw, dphin, dneg, stats,
               stream);
    COME_CHECK_LAUNCH();
    fused_scatter_kernel<<<TP, 128, 0, stream>>>(
        emb_in, emb_out, c + off, x + off, dphi, dphin, dcpos, nt, d, lr);
    COME_CHECK_LAUNCH();
  }
  apply_pool_kernel<<<KP, 128, 0, stream>>>(emb_out, pool, dneg, d, lr);
  COME_CHECK_LAUNCH();
  return 0;
}

}  // namespace come

using namespace come;

// K6: one O1 micro-step; emb_in, emb_out [V, d] f32 updated in place.  The
// other buffers are as fused_sgns above.  Returns 0 or the first CUDA
// error code; launches on `stream`, does not synchronise, allocates nothing.
extern "C" int come_fused_sgns_step(float* emb_in, float* emb_out,
                                    const int* c, const int* x, const int* m,
                                    const int* pool, double* stats,
                                    float* cneg, float* dneg, float* dphi,
                                    float* dcpos, float* nt, int d,
                                    int n_tiles, int TP, int KP, float lr,
                                    float negw, void* stream_ptr) {
  return fused_sgns(emb_in, emb_out, c, x, m, pool, stats, cneg, dneg, dphi,
                    dcpos, nt, d, n_tiles, TP, KP, lr, negw,
                    (cudaStream_t)stream_ptr);
}

// K7: K6 on one tied table emb [V, d] (both pair ends and the pool).
extern "C" int come_fused_sgns_step_tied(float* emb, const int* c,
                                         const int* x, const int* m,
                                         const int* pool, double* stats,
                                         float* cneg, float* dneg,
                                         float* dphi, float* dcpos, float* nt,
                                         int d, int n_tiles, int TP, int KP,
                                         float lr, float negw,
                                         void* stream_ptr) {
  return fused_sgns(emb, emb, c, x, m, pool, stats, cneg, dneg, dphi, dcpos,
                    nt, d, n_tiles, TP, KP, lr, negw,
                    (cudaStream_t)stream_ptr);
}
