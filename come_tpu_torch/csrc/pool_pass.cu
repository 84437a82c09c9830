// The pool stage, the bf16 passes' stage past MAX_DIM, K3's pool chains and
// K3's pool write alone, on given buffers: the C entries that hold each
// against its plain version (ops/pool_pass.py) and time it, outside the
// step loops that launch them (walk_sgns.cu, star_sgns.cu).  The kernels
// are sgns_common.cuh's: stage_pool_kernel<T, VEC> (the TPU's _stage_pool,
// pallas_walk_sgns.py:216), stage_pool_bf16_kernel<T, VEC> (the same with
// mxu_bf16's rounding, as the bf16 wide negative pass reads it),
// pool_chains_kernel and apply_pool_bf16_kernel<SR, E> (its _apply_pool on
// bf16 tables, :405), each sized as the loops size it.
// Each launches on the caller's stream without PDL, does not synchronise
// and allocates nothing.

#include "sgns_common.cuh"

using namespace come;

// cneg [KP, d] f32 = table[pool] widened, dneg [KP, d] f32 = 0, from a
// table [V, d] of f32 (bf16 == 0) or bf16 and pool [KP] i32.  Returns 0 or
// the CUDA error code.
extern "C" int come_pool_stage(const void* table, const int* pool, float* cneg,
                               float* dneg, int d, int KP, int bf16,
                               void* stream_ptr) {
  if (d < 1 || KP < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  NegSetup s;
  if (bf16) {
    stage_setup<__nv_bfloat16>(s, d, KP);
    return (int)launch_stage(s, static_cast<const __nv_bfloat16*>(table), pool,
                             cneg, dneg, d, KP, stream, false);
  }
  stage_setup<float>(s, d, KP);
  return (int)launch_stage(s, static_cast<const float*>(table), pool, cneg,
                           dneg, d, KP, stream, false);
}

// cnegb [KP * wide_row(d)] bf16 = table[pool] rounded to bf16 in the bf16
// wide pass's core-layout blocks (whole chunks of NEG_KC rows as blocks a
// slab of NEG_WHOLE columns, zeros past d; the rows of a last, partial
// chunk plain, wide_row(d) each), dneg [KP, d] f32 = 0, from a table
// [V, d] of f32 (bf16 == 0) or bf16 and pool [KP] i32.  Returns 0 or the
// CUDA error code.
extern "C" int come_pool_stage_wide_bf16(const void* table, const int* pool,
                                         void* cnegb, float* dneg, int d,
                                         int KP, int bf16, void* stream_ptr) {
  if (d < 1 || KP < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  auto* out = static_cast<__nv_bfloat16*>(cnegb);
  NegSetup s;
  stage_wide_setup(s, KP);
  if (bf16)
    return (int)launch_stage_wide(s, static_cast<const __nv_bfloat16*>(table),
                                  pool, out, dneg, d, KP, stream, false);
  return (int)launch_stage_wide(s, static_cast<const float*>(table), pool,
                                out, dneg, d, KP, stream, false);
}

// The chains of n_pools pools of KP ids (pools [n_pools, KP] i32) into
// chains [3 * n_pools * KP] i32: info [n_pools][KP][2] (k's sorted place,
// and its row's draws at its first draw, else 0), then order [n_pools][KP]
// (the k at each sorted place).  Returns 0 or the CUDA error code.
extern "C" int come_pool_chains(const int* pools, int n_pools, int KP,
                                int* chains, void* stream_ptr) {
  if (n_pools < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = chains_setup(KP);
  if (e == cudaSuccess)
    e = launch_chains(pools, n_pools, KP, chains, (cudaStream_t)stream_ptr);
  return (int)e;
}

// K3's pool write at the end of a block whose last group is g: table [V, d]
// bf16 (d even, updated in place), pool [KP] i32, dneg [KP, d] f32, chains
// the pool's (come_pool_chains of it, n_pools 1); table[pool[k]] =
// round(f32(row) + dneg[k] * -lr) for k in order, by stochastic rounding
// from `seed` (sr != 0) or truncation.  Returns 0 or the CUDA error code.
extern "C" int come_pool_apply_bf16(void* table, const int* pool,
                                    const float* dneg, const int* chains,
                                    int d, int KP, int g, float lr, int sr,
                                    unsigned seed, void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  NegSetup s;
  __nv_bfloat16* t = static_cast<__nv_bfloat16*>(table);
  cudaError_t e = apply_setup(s, d, KP);
  if (e == cudaSuccess)
    e = sr ? launch_apply_bf16<true>(s, t, pool, dneg, chains, 0, 1, d, KP,
                                     nullptr, lr, seed, g, stream, false)
           : launch_apply_bf16<false>(s, t, pool, dneg, chains, 0, 1, d, KP,
                                      nullptr, lr, 0u, g, stream, false);
  return (int)e;
}
