// Star (fan-out) tied SGNS macro step (O2) for Hopper, f32 table.
//
// Replaces the Pallas kernel come_tpu/ops/pallas_star_sgns.py::_star_kernel
// as called by fused_star_sgns_step (K2), and its mxu_bf16=True mode (K2b:
// phi_bm and g_m rounded to bf16 at :135, :156, and the negative pass's
// operands, sgns_common.cuh; every sum f32).  Slots come in groups of 1024 (eight
// 128-slot rows of the star layout, sampling/stars.py); groups run in
// order, each reading the table as the previous group left it:
//   * at an R-block start the pool rows are staged and dneg is zeroed;
//   * slots a, b of one 128-slot row pair when they share a segment and
//     exactly one of them is the hub (meta = seg*2 + hub, -2 at pads);
//     for each such pair g = sigmoid(phi_a . phi_b) - 1 and the tied
//     update is dphi_a += g phi_b from both the source and the context
//     side (g is symmetric), n_a = number of partners;
//   * every slot scores the staged pool with weight negw * n_a
//     (sgns_common.cuh: NegativePass);
//   * each real slot's update is added to its row, emb[v] = emb[v] -
//     lr * (dphi + dphin) rounded in f32, slot by slot in slot order as
//     the TPU's read-modify-write loop does (:186-195);
//   * at an R-block end the pool gradient is applied, a row's draws in
//     draw order (:197-204 _apply_pool).
// The writes are by owned rows (owned_writes.cuh): once a step, after the
// head kernel, pool_chains_kernel sorts the step's pools, slot_chains_kernel
// each group's real slots (meta != PAD_META: the layout's pads carry node 0
// and join no chain) and fold_chains_kernel finds which rows each block's
// last group writes through both; then each group's scatter
// (star_scatter_kernel) gives every distinct row of the group one warp,
// which applies the row's slots in slot order with plain stores, and the
// group that ends an R-block takes star_block_end_scatter_kernel instead,
// whose launch also has a team a pool draw: the pool's rows in draw order,
// a row in both owned by its slot team, which applies its slots first,
// then its draws.  So no star step takes an atomic in its writes, every
// write of the table is in a fixed order, and the pool write takes no
// launch of its own.
//
// What bounds it on the H100: as in walk_sgns.cu the negative pass
// (3 x 128 x KP x d multiply-adds per row) is compute and the gather and
// scatter are row traffic.  The star pass is small work (about 1000 pairs
// x 3 x d multiply-adds a group), so what bounds it is latency: it scores
// only the pairs the mask keeps, each once, spread over 128 CTAs a group
// that each own the segments whose hub lies in their 8-slot strip
// (star_pos.cuh: StarPosPass), instead of the TPU's dense [128, 128]
// block.  The negative pass is the walk kernel's (sgns_common.cuh: FFMA
// for K2, the tensor cores for K2b).  K2b's star pass rounds the staged
// rows and each pair's g as they are made, a few conversions per element.
// Past d 192 K2 and K2b hold their owned star rows whole where a row's 128
// rows fit (star_pos_wide_kernel: K2 to d 440, K2b to 880), else stage
// them one column slab of 128 at a time (star_pos_slab_kernel); the
// negative pass is its wide kernel
// (sgns_common.cuh: NEG_WHOLE).
// The group loop is recorded once as a CUDA graph that the card replays
// (step_graph.cuh), behind a head kernel that copies the call's slots,
// meta and pools into the plan's buffers and the step's chains, each kernel
// after the first two under programmatic dependent launch (sgns_common.cuh).

#include "sgns_common.cuh"
#include "owned_writes.cuh"
#include "star_pos.cuh"
#include "step_graph.cuh"

namespace come {

// The star slot writes of a group that ends no R-block
// (pallas_star_sgns.py:186-195): for each distinct row v of the group's
// real slots, emb[v] = __fadd_rn(emb[v], __fmul_rn(__fadd_rn(dphi[t],
// dphin[t]), -lr)) for its slots t in slot order, by one owner a row
// (owned_writes.cuh: f32_owner, star_write; its chains info, order are
// slot_chains_kernel's of the group).  A slot without pairs adds an exact
// zero (the star pass writes its dphi and dphin as zeros), so it is applied
// like the others.  grid: GROUP slots' teams of a warp
// (launch_star_scatter), block SCATTER_F32_THREADS.  PDL: the chains, the
// slots and lr (two or more kernels before it) before the wait; dphi,
// dphin (the star and negative passes') and the table after it.
template <int E>
static __global__ void __launch_bounds__(SCATTER_F32_THREADS)
star_scatter_kernel(float* emb, const int* slots, const float* dphi,
                    const float* dphin, const int* info, const int* order,
                    int d, const StepArgs* args, float lr_in) {
  const float lr = args != nullptr ? step_ld(&args->lr) : lr_in;
  const int i = blockIdx.x * (SCATTER_F32_THREADS / 32) + threadIdx.x / 32;
  const F32Owner<> o = f32_owner<false>(i, slots, info, order, BLK, nullptr,
                                        nullptr, nullptr, 0, nullptr,
                                        nullptr);
  pdl_wait();
  if (o.n > 0) star_write<E>(o, emb, dphi, dphin, nullptr, d, lr);
  pdl_trigger();
}

// The star slot writes of the group that ends an R-block, with the
// block's pool write folded in (pallas_star_sgns.py:197-204 after the
// slot loop): the GROUP slots' teams, then one team a draw of the pool
// `pool` (KP draws, chains pinfo, porder; the group's fold chains
// fold_slot, fold_draw): a row's draws in draw order, emb[v] =
// __fadd_rn(emb[v], __fmul_rn(dneg[k], -lr)), after its slots where the
// group's slots write it too.  grid: GROUP + KP teams, block
// SCATTER_F32_THREADS.  PDL as star_scatter_kernel; dneg after the wait.
template <int E>
static __global__ void __launch_bounds__(SCATTER_F32_THREADS)
star_block_end_scatter_kernel(float* emb, const int* slots,
                              const float* dphi, const float* dphin,
                              const int* info, const int* order,
                              const int* pool, const float* dneg,
                              const int* pinfo, const int* porder,
                              const int* fold_slot, const int* fold_draw,
                              int KP, int d, const StepArgs* args,
                              float lr_in) {
  const float lr = args != nullptr ? step_ld(&args->lr) : lr_in;
  const int i = blockIdx.x * (SCATTER_F32_THREADS / 32) + threadIdx.x / 32;
  const F32Owner<> o = f32_owner<true>(i, slots, info, order, BLK, pool,
                                       pinfo, porder, KP, fold_slot,
                                       fold_draw);
  pdl_wait();
  if (o.n > 0 || o.pn > 0) star_write<E>(o, emb, dphi, dphin, dneg, d, lr);
  pdl_trigger();
}

// The star slot writes of group `slots` on `stream` (with PDL when `pdl`):
// star_scatter_kernel, or with a pool (`pool` not null: the group ends an
// R-block) star_block_end_scatter_kernel with the pool's dneg and chains
// (pinfo, porder) and the group's fold chains (fold_slot, fold_draw).  Its
// chains `info`, `order` (slot_chains_kernel's of the group); lr from
// `args`, or `lr` where it is null.  `launched` (may be null) counts the
// launch under PASS_STAR_SCATTER or PASS_STAR_BLOCK_END_SCATTER.
static cudaError_t launch_star_scatter(
    float* emb, const int* slots, const float* dphi, const float* dphin,
    const int* info, const int* order, const int* pool, const float* dneg,
    const int* pinfo, const int* porder, const int* fold_slot,
    const int* fold_draw, int KP, int d, const StepArgs* args, float lr,
    cudaStream_t stream, bool pdl, int* launched) {
  constexpr int per = SCATTER_F32_THREADS / 32;
  const bool vec = d % 4 == 0;
  cudaError_t e;
  if (pool == nullptr) {
    e = launch_kernel(vec ? star_scatter_kernel<4> : star_scatter_kernel<1>,
                      dim3(GROUP / per), dim3(SCATTER_F32_THREADS), 0, stream,
                      pdl, 0, emb, slots, dphi, dphin, info, order, d, args,
                      lr);
  } else {
    e = launch_kernel(vec ? star_block_end_scatter_kernel<4>
                          : star_block_end_scatter_kernel<1>,
                      dim3((GROUP + KP + per - 1) / per),
                      dim3(SCATTER_F32_THREADS), 0, stream, pdl, 0, emb,
                      slots, dphi, dphin, info, order, pool, dneg, pinfo,
                      porder, fold_slot, fold_draw, KP, d, args, lr);
  }
  if (e == cudaSuccess && launched != nullptr)
    ++launched[pool == nullptr ? PASS_STAR_SCATTER
                                   : PASS_STAR_BLOCK_END_SCATTER];
  return e;
}

// The group loop of one step, launched on `stream` (the recording stream),
// after the head kernel and the step's chains (`chains`: the pools', the
// groups' slots', then the fold chains, as star_chains lays them out):
// slots, meta and pools are the plan's copies.  Every kernel under PDL.
// `launched` receives the route of the star pass it launched (PosRoute),
// and `pool_launched` counts the pool passes and the scatters it launched
// (PoolPass).
template <bool BF16>
static int star_groups(const NegSetup& ns, float* emb, const int* slots,
                       const int* meta, const int* pools, const int* chains,
                       double* stats, float* cneg, float* dneg, float* dphi,
                       float* nt, const StepArgs* args, int d, int G, int KP,
                       int R, float negw, int* launched, int* pool_launched,
                       cudaStream_t stream) {
  StarPosPass<BF16> pos;
  pos.smem = StarPosPass<BF16>::smem_bytes(d);
  NegativePass<BF16, float> neg;
  static_cast<NegSetup&>(neg) = ns;
  float* dphin = dphi + (size_t)GROUP * d;  // the negative pass's part
  const int n_pools = (G + R - 1) / R;
  const int* sc = chains + (size_t)3 * n_pools * KP;  // the slot chains
  const int* fold = sc + (size_t)3 * G * GROUP;       // the fold chains
  cudaError_t e;
  for (int g = 0; g < G; ++g) {
    const int* pool = pools + (size_t)(g / R) * KP;
    const int* sg = slots + (size_t)g * GROUP;
    if (g % R == 0) {
      e = neg.stage(emb, pool, cneg, dneg, d, KP, stream, true,
                    pool_launched);
      if (e != cudaSuccess) return (int)e;
    }
    e = pos.launch(emb, sg, meta + (size_t)g * GROUP, d, dphi, dphin, nt,
                   stats, stream, true);
    if (e != cudaSuccess) return (int)e;
    *launched = pos.launched;
    e = neg.launch(emb, sg, nt, cneg, d, KP, negw, dphin, dneg, stats, stream,
                   true);
    if (e != cudaSuccess) return (int)e;
    const bool end = g % R == R - 1 || g == G - 1;
    e = launch_star_scatter(
        emb, sg, dphi, dphin, slot_info(sc, g), slot_order(sc, g, G),
        end ? pool : nullptr, dneg, pool_chain_info(chains, g / R, KP),
        pool_chain_order(chains, g / R, n_pools, KP),
        fold + (size_t)g * GROUP,
        fold + (size_t)G * GROUP + (size_t)(g / R) * KP, KP, d, args, 0.0f,
        stream, true, pool_launched);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The chains of a star step of G groups, R a block, on `stream` (the
// recording stream, right after the head kernel): pool_chains_kernel over
// its pools (without PDL), slot_chains_kernel over its groups' real slots
// and fold_chains_kernel over its blocks (under PDL), into `chains`: the
// pools' [3 * ceil(G / R) * KP], the slots' [3 * G * GROUP], then the fold
// chains [G * GROUP + ceil(G / R) * KP].  `pool_launched` counts them.
static cudaError_t star_chains(const int* slots, const int* meta,
                               const int* pools, int* chains, int G, int KP,
                               int R, int* pool_launched,
                               cudaStream_t stream) {
  const int n_pools = (G + R - 1) / R;
  cudaError_t e = launch_chains(pools, n_pools, KP, chains, stream);
  if (e != cudaSuccess) return e;
  ++pool_launched[PASS_POOL_CHAINS];
  int* sc = chains + (size_t)3 * n_pools * KP;
  e = launch_slot_chains(slots, meta, G, BLK, sc, stream, true);
  if (e != cudaSuccess) return e;
  ++pool_launched[PASS_STAR_CHAINS];
  e = launch_fold_chains(slots, meta, sc, pools, chains, G, BLK, KP, R,
                         sc + (size_t)3 * G * GROUP, stream, true);
  if (e == cudaSuccess) ++pool_launched[PASS_FOLD_CHAINS];
  return e;
}

// One step in one mode: checks the shapes, sets the kernels up at the
// plan's first step (the star pass's shared-memory cap, the negative pass's
// sizing, the chains' shared-memory caps), records the step if `how` asks
// (the head kernel, the step's chains, then the group loop; step_graph.cuh)
// and replays it with this call's head parameters.  KP past
// POOL_CHAIN_MAX is refused.
template <bool BF16>
static int star_step(StepGraph* p, int how, float* emb, const HeadIn& hin,
                     const HeadBufs& hb, int* chains, double* stats,
                     float* cneg, float* dneg, float* dphi, float* nt, int d,
                     int G, int KP, int R, float negw, cudaStream_t stream) {
  if (p == nullptr || d < 1 || G < 1 || R < 1 || chains == nullptr)
    return (int)cudaErrorInvalidValue;
  if (p->mode < 0) {
    StarPosPass<BF16> pos;
    cudaError_t e = pos.init(d);
    if (e != cudaSuccess) return (int)e;
    NegativePass<BF16, float> neg;
    e = neg.init(d, KP, GROUP);
    if (e == cudaSuccess) e = fold_setup(KP);
    if (e != cudaSuccess) return (int)e;
    p->neg = neg;
    p->mode = BF16;
  } else if (p->mode != (int)BF16) {
    return (int)cudaErrorInvalidValue;  // a plan serves one mode
  }
  return run_step(
      p, how, stream,
      [&](cudaStream_t cap) -> int {
        cudaError_t e = launch_head(hin, hb, cap);
        if (e == cudaSuccess)
          e = star_chains(hb.dst[0], hb.dst[1], hb.dst[2], chains, G, KP, R,
                          p->pool, cap);
        if (e != cudaSuccess) return (int)e;
        return star_groups<BF16>(p->neg, emb, hb.dst[0], hb.dst[1],
                                 hb.dst[2], chains, stats, cneg, dneg, dphi,
                                 nt, hb.args, d, G, KP, R, negw, &p->route,
                                 p->pool, cap);
      },
      step_head_kernel, hin, hb);
}

}  // namespace come

using namespace come;

// One O2 macro step over G groups through the plan's graph slot `graph`
// (come_step_graph_new): `record` 1 records the step and instantiates the
// slot's graph (the plan's first step), 2 records it and updates the
// instance (the table moved), 0 replays it; every call sets the head
// kernel's parameters (the call's slots, meta and pools, lr) and launches
// the instance on `stream`.  All buffers are device pointers:
//   emb          [V, d] f32 (updated in place)
//   slots, meta  [G * 1024] i32 (meta -2 at pads)
//   pools        [ceil(G / R), KP] i32
//   stats        [2] f64 scratch: the step's (loss, pairs)
//   cneg, dneg   [KP, d] f32 scratch;  nt [1024] f32 scratch
//   dphi         [2, 1024, d] f32 scratch: the star pass's part of each
//                slot's update, then the negative pass's
//   slots_buf, meta_buf, pools_buf: the plan's copies of slots, meta and
//                pools, which the loop reads
//   args         the plan's argument block (sgns_common.cuh: StepArgs)
//   chains       [4 * ceil(G / R) * KP + 4 * G * 1024] i32 scratch: the
//                pools' chains (sgns_common.cuh: pool_chains_kernel), the
//                groups' slot chains (owned_writes.cuh: slot_chains_kernel
//                on the meta), then the block ends' fold chains
//                (fold_chains_kernel: 1024 a group, then KP a pool)
// bf16 != 0 selects K2b's rounding; a plan serves one mode and one
// (d, G, KP, R); its recording holds the table's address and negw.  Returns
// 0 or the first CUDA error code.  Enqueues only: it does not synchronise
// and allocates no device memory.
extern "C" int come_star_sgns_step(void* graph, int record, float* emb,
                                   const int* slots, const int* meta,
                                   const int* pools, double* stats,
                                   float* cneg, float* dneg, float* dphi,
                                   float* nt, int* slots_buf, int* meta_buf,
                                   int* pools_buf, void* args, int* chains,
                                   int d, int G, int KP, int R, int bf16,
                                   float lr, float negw, void* stream_ptr) {
  StepGraph* p = static_cast<StepGraph*>(graph);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n = G * GROUP, np = (G + R - 1) / R * KP;
  const HeadIn hin{{slots, meta, pools, nullptr}, lr, 0u};
  const HeadBufs hb{{slots_buf, meta_buf, pools_buf, nullptr},
                    {n, n, np, 0}, static_cast<StepArgs*>(args), stats};
  return bf16 ? star_step<true>(p, record, emb, hin, hb, chains, stats, cneg,
                                dneg, dphi, nt, d, G, KP, R, negw, stream)
              : star_step<false>(p, record, emb, hin, hb, chains, stats,
                                 cneg, dneg, dphi, nt, d, G, KP, R, negw,
                                 stream);
}

// The star pass a star step of width d takes (sgns_common.cuh: PosRoute):
// 0 d <= 192 (star_pos_kernel), 1 whole rows (star_pos_wide_kernel), 2
// column slabs (star_pos_slab_kernel); bf16 != 0 for K2b (and P3).
extern "C" int come_star_pos_route(int d, int bf16) {
  return star_pos_route(d, bf16 != 0);
}

// The star steps' slot passes alone, on given buffers: the C entries that
// hold each against its plain version (ops/scatter_pass.py) and time it,
// outside the step loop that launches them.  Each launches on the
// caller's stream without PDL, does not synchronise and allocates nothing;
// each returns 0 or the CUDA error code.

// The slot chains of G groups of a star layout (slots, meta [G * 1024]
// i32, meta -2 at pads) into chains [3 * G * 1024] i32: info [G][1024][2]
// (t's sorted place, and its row's slots at its first slot, else 0; pads
// (0, 0)), then order [G][1024] (the real slot at each sorted place, -1
// past them).
extern "C" int come_star_chains(const int* slots, const int* meta, int G,
                                int* chains, void* stream_ptr) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_slot_chains(slots, meta, G, BLK, chains,
                                 (cudaStream_t)stream_ptr, false);
}

// The fold chains of a star step's blocks: slots, meta [G * 1024] i32,
// chains their star chains (come_star_chains, G groups), pools
// [ceil(G / R)][KP] i32 and pool_chains theirs (come_pool_chains, n_pools
// ceil(G / R)), into fold [G * 1024 + ceil(G / R) * KP] i32: fold_slot
// [G][1024], written at each block's last group g = min(b R + R - 1, G - 1)
// only (the place in pool b's chain of the first draw of real slot t's
// row, -1 where the pool does not draw it and at pads), then fold_draw
// [ceil(G / R)][KP] (1 where draw k's row is a real slot's of the block's
// last group, else 0).
extern "C" int come_star_fold_chains(const int* slots, const int* meta,
                                     const int* chains, const int* pools,
                                     const int* pool_chains, int G, int KP,
                                     int R, int* fold, void* stream_ptr) {
  if (G < 1 || R < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = fold_setup(KP);
  if (e == cudaSuccess)
    e = launch_fold_chains(slots, meta, chains, pools, pool_chains, G, BLK,
                           KP, R, fold, (cudaStream_t)stream_ptr, false);
  return (int)e;
}

// The star slot writes of one group alone (star_scatter_kernel), or with
// `pool` not null those of a group that ends an R-block with the block's
// pool write folded in (star_block_end_scatter_kernel): emb [V, d] f32
// (updated in place), slots [1024] i32 (the group's), dphi, dphin [1024, d]
// f32, chains the group's (come_star_chains, G 1); pool [KP] i32, dneg
// [KP, d] f32, pool_chains the pool's (come_pool_chains of it, n_pools 1)
// and fold the group's fold chains (come_star_fold_chains).  For each real
// slot t in slot order, emb[v] = f32(emb[v] + f32(f32(dphi[t] + dphin[t])
// * -lr)); then emb[pool[k]] = f32(emb[pool[k]] + f32(dneg[k] * -lr)) for k
// in draw order.
extern "C" int come_star_scatter(float* emb, const int* slots,
                                 const float* dphi, const float* dphin,
                                 const int* chains, const int* pool,
                                 const float* dneg, const int* pool_chains,
                                 const int* fold, int d, int KP, float lr,
                                 void* stream_ptr) {
  const bool end = pool != nullptr;
  if (d < 1 || (end && KP < 1)) return (int)cudaErrorInvalidValue;
  return (int)launch_star_scatter(
      emb, slots, dphi, dphin, slot_info(chains, 0), slot_order(chains, 0, 1),
      pool, dneg, end ? pool_chain_info(pool_chains, 0, KP) : nullptr,
      end ? pool_chain_order(pool_chains, 0, 1, KP) : nullptr, fold,
      end ? fold + GROUP : nullptr, KP, d, nullptr, lr,
      (cudaStream_t)stream_ptr, false, nullptr);
}
