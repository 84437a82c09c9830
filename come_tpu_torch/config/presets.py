"""Typed configuration with per-dataset presets.

The reference keeps hyperparameters as hard-coded constants / argparse flags
in ``main.py`` [R, SURVEY.md C9 §5 "Config"]; here they are one frozen
dataclass.  Presets mirror BASELINE.json:7-11's five benchmark configs.
Reference defaults (d=128, walks 10x80, window 10, k=5 negatives, lr=0.025,
reg_covar 1e-5, alpha/beta trade-offs ~0.1) per SURVEY.md C9.

This is the PyTorch port's copy of ``come_tpu/config/presets.py``: the same
fields, defaults and preset values (tests assert ``dataclasses.asdict``
equality against the JAX package).  Field comments describe the JAX
package's tiers; the port implements the subset its trainer documents and
raises ``NotImplementedError`` for the rest.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ComEConfig:
    # model
    dim: int = 128
    num_communities: int = 2
    # walk corpus source: "device" = fused on-device lax.scan walker;
    # "host" = C++ multithreaded feeder (come_tpu/native), double-buffered
    # host->device — for graphs kept in host memory
    corpus: str = "device"
    # corpus (reference: num_paths=10, path_length=80, window=10)
    walk_length: int = 80
    walks_per_node: int = 10
    # per-step probability of restarting a walk at its origin (the
    # reference ``random_walk``'s ``alpha`` [R, SURVEY.md C3]; 0 = pure
    # truncated walks, the reference default).  Honored by both the
    # on-device walker (sampling/walks.py) and the C++ host feeder.
    restart_prob: float = 0.0
    window: int = 10
    negative: int = 5
    down_sample: float = 0.0  # word2vec `sample`; 0 = off
    # "per_pair": reference semantics, k fresh negatives per pair (the numpy
    # oracle's model).  "shared": one pool of `shared_negatives` per SGD
    # micro-step, scored via MXU matmuls (GraphVite-style; see
    # losses/sgns_block.py) — the TPU fast path.
    negative_mode: str = "per_pair"
    shared_negatives: int = 1024
    # "auto": fused Pallas SGNS kernel on TPU when tables fit VMEM and
    # negative_mode == "shared"; "never": always the XLA path; "always":
    # force the kernel (interpret-mode off-TPU — tests only).
    pallas: str = "auto"
    # pairs per fused-kernel tile (sequential on TPU; the effective
    # micro-batch granularity inside the kernel).  1024 on hardware —
    # 1-D s32 operands carry XLA layout T(1024) and blocks must match.
    pallas_tile_pairs: int = 1024
    # walk-banded kernel: run the scoring/gradient matmuls in bf16 on the
    # MXU (f32 accumulation, f32 master tables and updates).  ~4x MXU rate
    # on v5e; SGD quality unaffected (validated e2e).  f32 by default so
    # oracle-parity tests stay exact.
    walk_kernel_bf16: bool = False
    # walk-banded kernel: allow bf16-RESIDENT tables (2B/elem, stochastic-
    # rounding SGD writes, f32 gradient math) when f32 tables exceed the
    # VMEM tier — extends the fused path to V ~ 114k @ d=128 (Flickr).
    walk_kernel_bf16_tables: bool = True
    # O2 (edge pass) tier: "auto" picks the fastest eligible tier —
    # star (fused tied star kernel, ops/pallas_star_sgns.py: arcs grouped
    # by source, ~2 pairs/slot and 1 gather+1 scatter per slot) ->
    # paired (walk-banded kernel's edge mode) -> xla.  "star"/"paired"/
    # "xla" force a tier (paired kept for A/B and the verify gate).
    o2_mode: str = "auto"
    # walk-banded kernel: walk-groups per shared negative pool (R).  The
    # pool's accumulated gradient applies at every R-block boundary —
    # small R = fresher negatives + tighter stability, large R = fewer
    # staging row-ops.  The stability envelope scales like the collision
    # bound: keep R * NWL pool-slot updates << V.
    walk_pool_refresh: int = 1
    # banded XLA tier (losses/sgns_banded.py): the walk-banded MXU
    # formulation with HBM-resident tables — carries graphs past the
    # fused kernels' VMEM ceiling (V > ~196k @ d=128).  "auto": used on
    # TPU when the fused walk kernel is ineligible; "never"; "always"
    # (force, incl. CPU — tests).
    banded: str = "auto"
    # walks per banded block (the synchronous update unit; also bounds the
    # [Bc, L, L] score temporaries).  1024 measured best on v5e: the tier
    # is gather/scatter row-rate bound and bigger blocks amortize the
    # per-block fixed costs.
    banded_walk_block: int = 1024
    # duplicate-combining sort+segment-sum scatter (hub rows repeat within
    # a block) vs plain XLA scatter-add.  Off by default: plain scatter
    # measured ~1.5x faster at SBM-like duplication; turn on for
    # heavy-hub power-law batches.
    banded_sorted_scatter: bool = False
    # banded-tier pool stability bound: max walk SLOTS served by one
    # fresh negative pool.  Every trained pair adds ~negative/KP of
    # gradient mass to EVERY pool row; applying a whole 1024-walk
    # block's mass (~2000 stale unit-gradients/row at KP=2048) from one
    # pool measurably diverges at synthetic-10m scale (exponential
    # mean-drift onset ~300 macro steps — docs/PERF.md round-5 note).
    # The effective banded block is min(banded_walk_block,
    # banded_pool_slots / walk_length), each block drawing a FRESH pool
    # — the banded analog of the fused kernel's walk_pool_refresh bound.
    banded_pool_slots: int = 20480
    # fresh-walk generation strategy when the fused walk kernel runs:
    # "scan" = the lax.scan device walker feeds the kernel; "kernel" =
    # walks are generated INSIDE the fused kernel from VMEM-resident CSR
    # (no separate walker pass at all; randomness is one host threefry
    # bit-matrix per macro step).  "kernel" needs the CSR to fit the
    # kernel's VMEM side budget (~12MB: (V+1+E)*4B) and applies to the
    # single-device fused path.
    walk_gen: str = "scan"
    # walk-corpus regeneration cadence for the device corpus: 1 = fresh
    # walks every O1 epoch; N = regenerate every N epochs; 0 = generate
    # ONCE and reuse — the reference's own behavior (deepwalk lineage:
    # write_walks_to_disk runs once at startup and every epoch re-streams
    # the same files, SURVEY.md C3/§3.1).
    walk_regen_epochs: int = 1
    # optimization (reference: lr=0.025, linear decay to min_lr)
    lr: float = 0.025
    min_lr: float = 0.0001
    alpha: float = 1.0  # O2 (edge proximity) loss weight, paper's alpha
    beta: float = 0.1  # O3 (community closure) weight, paper's beta
    pretrain_epochs: int = 2
    outer_iters: int = 5
    o1_epochs_per_iter: int = 1
    o2_epochs_per_iter: int = 1
    o3_steps_per_iter: int = 1
    # batching (framework-side; the reference used thread job chunks)
    batch_walks: int = 256
    batch_edges: int = 65536
    # pairs per SGD micro-step.  Batched synchronous SGD sums duplicate-row
    # updates (hogwild applies them sequentially, which self-stabilizes);
    # keeping row collisions per update bounded is the stability knob
    # (SURVEY.md §7 hard part 1).  Rule of thumb: ~V * 20 / (2 + negative).
    batch_pairs: int = 32768
    # pair compaction budget: ~48% of window-pair slots are masked
    # (reduced window + range); sorting valid pairs first and truncating to
    # this fraction of slots halves SGD work per trained pair.  Slots beyond
    # the budget are dropped (stochastic, ~0 at these batch sizes).
    # 0 disables compaction (default: the argsort costs more than the
    # masked slots it saves on TPU; kept for host-feeder pipelines).
    compact_budget: float = 0.0
    # row exchange for model>1 sharded training (shared-negative mode):
    # "a2a" = bucketed all-to-all (batch ALSO sliced over 'model', traffic
    # ~3*B*d/M — see parallel/exchange.py); "psum" = masked-gather + psum
    # (replicated batch over 'model', traffic ~2*B*d/device — the simple
    # debug/fallback exchange).  "auto" (default) resolves to a2a whenever
    # the mesh has model>1: the id interleave + served-fraction monitoring
    # make the bucketed exchange safe by default (BASELINE.json:5's
    # "boundary rows exchanged all-to-all over ICI").
    row_exchange: str = "auto"
    # double-buffer the row exchange in the row-sharded walk tiers: the
    # NEXT block's rows are gathered while the current block computes
    # (software pipelining inside the scan), at the cost of the gathered
    # rows being one block stale — the same staleness class as the
    # reference's hogwild reads (SURVEY.md §3.2).  Exchange plans (the id
    # all-to-alls) are always hoisted out of the block loop; this flag only
    # controls the stale-read row prefetch.  "auto" (default) resolves per
    # backend/tier from the measured A/B (exchange_overlap_ab): ON on TPU
    # (async ICI collectives hide behind the kernel), and on CPU-virtual
    # meshes ON for the fused-kernel tier but OFF for the banded tier,
    # where the A/B showed a small regression (docs/PERF.md).  True/False
    # force it.
    overlap_exchange: bool | str = "auto"
    # bucket slack for the a2a exchange: capacity = ceil(B/M * slack).
    # Ids past an owner's bucket are skipped that micro-step (reported by
    # the served mask); the trainer interleave-relabels node ids so
    # contiguous shards own decorrelated sets, making overflow ~never fire.
    a2a_capacity_slack: float = 2.0
    # GMM (reference: sklearn GaussianMixture(K, 'full', reg_covar, n_init))
    reg_covar: float = 1e-5
    gmm_n_init: int = 1
    gmm_max_iter: int = 60
    # EM convergence tolerance on the mean log-likelihood (sklearn's `tol`,
    # which the reference inherits); 0 = always run gmm_max_iter iterations
    gmm_tol: float = 1e-3
    # per-node O3 gradient-norm bound (None = reference behavior, no guard)
    o3_grad_clip: float | None = 5.0
    # reference EXP_TABLE clamp emulation; None = exact sigmoid
    max_exp: float | None = None
    seed: int = 0

    def replace(self, **kw) -> "ComEConfig":
        return dataclasses.replace(self, **kw)


PRESETS: dict[str, ComEConfig] = {
    # BASELINE.json config 1: O1-only DeepWalk on Karate (CPU-runnable)
    "karate": ComEConfig(
        dim=16,
        num_communities=2,
        walk_length=20,
        walks_per_node=10,
        window=5,
        batch_walks=34,
        batch_edges=256,
        batch_pairs=128,
        outer_iters=3,
        lr=0.05,
        beta=0.05,
        # 4 restarts: one bad EM local optimum in an outer iteration drags
        # O3 the wrong way and can collapse NMI for that iteration on a
        # 34-node graph (seed-dependent); restarts pick the better fit
        gmm_n_init=4,
        # 34 points in 16-D: without strong covariance regularization the
        # EM fit is near-singular and inv_cov blows up the O3 step
        reg_covar=0.1,
        # tiny data: tol-based EM stopping quits on near-flat early
        # likelihood and degrades the fit; full iterations cost nothing
        gmm_tol=0.0,
        o3_grad_clip=1.0,
    ),
    # config 2/3: BlogCatalog O1+O2(+O3), d=128, k=5, K=39.
    # Production presets default to the fast path (shared negatives +
    # fused kernels — quality validated end-to-end, see docs/PERF.md);
    # set negative_mode='per_pair' for strict reference semantics.
    "blogcatalog": ComEConfig(
        num_communities=39, gmm_n_init=2,
        negative_mode="shared", shared_negatives=512,
    ),
    # config 4: Wikipedia / DBLP eval sweep
    "wikipedia": ComEConfig(
        num_communities=40, gmm_n_init=2,
        negative_mode="shared", shared_negatives=512,
    ),
    "dblp": ComEConfig(
        num_communities=5, gmm_n_init=2,
        negative_mode="shared", shared_negatives=512,
    ),
    # config 5: Flickr / synthetic 10M-edge multi-host
    "flickr": ComEConfig(
        num_communities=195, batch_walks=512,
        negative_mode="shared", shared_negatives=1024,
    ),
    "synthetic-10m": ComEConfig(
        num_communities=64, batch_walks=1024, batch_edges=262144,
        negative_mode="shared", shared_negatives=2048,
    ),
}


def get_config(name: str) -> ComEConfig:
    key = name.lower().replace("-synthetic", "")
    if key in PRESETS:
        return PRESETS[key]
    raise KeyError(f"no preset for {name!r}; have {sorted(PRESETS)}")
