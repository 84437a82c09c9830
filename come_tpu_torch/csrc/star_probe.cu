// P3: the star kernel's section-cost probe for Hopper.
//
// Replaces scripts/probe_star.py (_kern :33, step :163, pallas_call :211),
// which timed ops/pallas_star_sgns.py's kernel in its mxu_bf16 mode with
// sections switched off, to attribute a group's time to them by
// subtraction.  Here it is K2b's group loop (star_sgns.cu) cut into the same
// five sections, each its own stream-ordered launch per group:
//   GATHER  phi[t] = emb[slots[t]] for the group's 1024 slots
//           (probe_rows.cuh, U rows in flight per warp);
//   MATH    the positive pass on phi (star_pos.cuh) and, with NEG, the
//           shared negative pass on phi (NegativePass): dphi, nt, loss;
//   NEG     the negative pass inside MATH;
//   SCATTER emb[slots[t]] -= lr * dphi[t] for EVERY slot, as the TPU probe
//           writes all 1024 (K2's scatter skips slots without pairs, whose
//           dphi is exactly zero: the tables agree, the cost may not);
//   POOL    stage the pool rows at an R-block start, apply their gradient
//           at its end.
// MATH reads phi through an identity index, so with every section on the
// step computes what K2b computes on the same inputs (the sums' order aside:
// atomics).  Sections off leave their buffers as the wrapper made them:
// phi, dphi, nt, cneg and dneg are zeroed once per call (the TPU's scratch
// would hold whatever was there).  The variants are not meaningful
// training steps; they exist to locate the cost.
//
// What bounds it: as K2b (the negative pass is compute, the gather and
// scatter are row traffic); the probe only separates the sections.

#include "probe_rows.cuh"
#include "sgns_common.cuh"
#include "star_pos.cuh"

namespace come {

enum Section { GATHER = 1, MATH = 2, NEG = 4, SCATTER = 8, POOL = 16 };

template <bool BF16, int U>
static int star_probe_groups(float* emb, const int* slots, const int* meta,
                             const int* pools, const int* iota,
                             double* stats, float* phi, float* cneg,
                             float* dneg, float* dphi, float* nt, int d,
                             int G, int KP, int R, int sections, float lr,
                             float negw, cudaStream_t stream) {
  if (d > MAX_DIM || d % 4 || R < 1) return (int)cudaErrorInvalidValue;
  StarPosPass<BF16> pos;
  cudaError_t e = pos.init(d);
  if (e != cudaSuccess) return (int)e;
  NegativePass<BF16, float> neg;
  e = neg.init(d, KP, GROUP);
  if (e != cudaSuccess) return (int)e;
  e = rows_allow_smem<U>(d);
  if (e != cudaSuccess) return (int)e;
  const bool pool_on = sections & POOL, math_on = sections & MATH;
  for (int g = 0; g < G; ++g) {
    const int* pool = pools + (size_t)(g / R) * KP;
    const int* sg = slots + (size_t)g * GROUP;
    if (pool_on && g % R == 0) {
      stage_pool_kernel<<<KP, 128, 0, stream>>>(emb, pool, cneg, dneg, d);
      COME_CHECK_LAUNCH();
    }
    if (sections & GATHER) {
      e = launch_rows<U>(false, emb, sg, phi, GROUP, d, 0.0f, stream);
      if (e != cudaSuccess) return (int)e;
    }
    if (math_on) {
      pos.launch(phi, iota, meta + (size_t)g * GROUP, d, dphi, nullptr, nt,
                 stats, stream);
      COME_CHECK_LAUNCH();
      if (sections & NEG) {
        neg.launch(phi, iota, nt, cneg, d, KP, negw, dphi, dneg, stats,
                   stream);
        COME_CHECK_LAUNCH();
      }
    }
    if (sections & SCATTER) {
      e = launch_rows<U>(true, emb, sg, dphi, GROUP, d, -lr, stream);
      if (e != cudaSuccess) return (int)e;
    }
    if (pool_on && (g % R == R - 1 || g == G - 1)) {
      apply_pool_kernel<<<KP, 128, 0, stream>>>(emb, pool, dneg, d, lr);
      COME_CHECK_LAUNCH();
    }
  }
  return 0;
}

template <bool BF16>
static int star_probe_unroll(int unroll, float* emb, const int* slots,
                             const int* meta, const int* pools,
                             const int* iota, double* stats, float* phi,
                             float* cneg, float* dneg, float* dphi, float* nt,
                             int d, int G, int KP, int R, int sections,
                             float lr, float negw, cudaStream_t stream) {
  // (the parentheses keep the template's comma inside one macro argument)
  COME_ROWS_DISPATCH(unroll, return (star_probe_groups<BF16, U>(
      emb, slots, meta, pools, iota, stats, phi, cneg, dneg, dphi, nt, d, G,
      KP, R, sections, lr, negw, stream)));
  return 0;
}

}  // namespace come

using namespace come;

// One probe step over G groups.  All buffers are device pointers:
//   emb          [V, d] f32 (updated in place), d a multiple of 4
//   slots, meta  [G * 1024] i32 (meta -2 at pads)
//   pools        [ceil(G / R), KP] i32
//   iota         [1024] i32, iota[t] = t
//   stats        [2] f64, accumulates (loss, pairs)
//   phi, dphi    [1024, d] f32; nt [1024] f32; cneg, dneg [KP, d] f32: all
//                zeroed by the caller
// bf16 != 0 rounds as K2b; sections is a mask of Section; unroll is the
// rows in flight per warp of the gather and scatter (8, 16, 32, 64, 128).
// Returns 0 or the first CUDA error code.  Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int come_star_probe_step(float* emb, const int* slots,
                                    const int* meta, const int* pools,
                                    const int* iota, double* stats,
                                    float* phi, float* cneg, float* dneg,
                                    float* dphi, float* nt, int d, int G,
                                    int KP, int R, int bf16, int sections,
                                    int unroll, float lr, float negw,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return bf16 ? star_probe_unroll<true>(unroll, emb, slots, meta, pools, iota,
                                        stats, phi, cneg, dneg, dphi, nt, d,
                                        G, KP, R, sections, lr, negw, stream)
              : star_probe_unroll<false>(unroll, emb, slots, meta, pools,
                                         iota, stats, phi, cneg, dneg, dphi,
                                         nt, d, G, KP, R, sections, lr, negw,
                                         stream);
}
