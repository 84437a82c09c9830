"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (each prints one line; any failure raises, so the script exits
non-zero and prints no result line):
  1. device  — requires CUDA; prints nvidia-smi's name and power limit
  2. build   — compiles come_tpu_torch/csrc/*.cu for sm_90a (nvcc)
  3. K1      — one BlogCatalog-shaped O1 macro step through the walk kernel
               and through its plain PyTorch version on clones
 3b. K1b     — the same inputs with mxu_bf16 (bf16 product operands)
  4. K2      — the same for one star O2 macro step (65536 slots)
 4b. K2b     — the same inputs with mxu_bf16
 4c. K4      — one BlogCatalog macro step of 256 walks generated in the
               kernel from starts, 32-bit draws and the CSR (L 80, W 10,
               KP 512); the walks must be the plain version's bit for bit
               and every hop an edge
 4d. K5      — one paired O2 macro step at blogcatalog shapes (512 rows of
               64 edges, 64 groups), f32
 4e. bench shapes — K1b, K4 (bf16) and K2b at the shapes phases 12-13 give
               them: one 2048-walk O1 step (256 groups, R 8, unigram pools
               [32, 512]) and the one star O2 step of batch_edges 524288
               (the whole layout, 344 groups, R 8)
 4h. edges   — the walk kernel against its plain version at EDGE_SHAPES
               (W >= L - 1, L = 1, odd L with W past a strip, d 192 and 2,
               a heavily repeated row, KP 100 and 2048 with R 3), in f32,
               bf16 products and on bf16 tables, each under its mode's check
 4i. star/f32 edges — the star kernel against its plain version, in f32 and
               bf16, at STAR_EDGES (a hub of degree 300 split at fan-out 32,
               a single fat hub filling a row, segments dropped to pads
               mid-row, d 192 and 2, KP 100 with R 3, a ragged last group),
               and K6 and K7 at FUSED_EDGES (KP 100 and 2048, d 192 and 2,
               tiles of 64 and 777 pairs, each with one all-masked tile)
  4f. K3     — the walk kernel on bf16 tables at the large-V path's shapes
               (synthetic-10m: V 500000, d 128, 1024 walks of 80, W 10, KP
               2048, R 1, 128 groups), with stochastic rounding and in
               truncation mode, through walk_sgns_step and walk_sgns_gen_step;
               K3 and K1 (f32 tables, same inputs) timed, and the device
               busy share of one K3 step (its kernels' device time over its
               CUDA-event time)
 4g. P1      — the row-gather floor probe: gather and scatter-add of N =
               2048 and 262144 rows of a [500000, 128] f32 and bf16 table,
               beside index_select / index_add_
               (the K1, K1b bench and K3 lines also give the device
               microseconds per group of each pass of the walk group loop,
               by torch.profiler: band (walk_pos_kernel), negative
               (negative_f32_kernel or negative_bf16_kernel), scatter, stage
               (pool staging) and pool apply, and the K1 and K3 lines the
               device busy share of one step; the K2 and K2b bench lines
               those of the star group loop, star (star_pos_kernel) in the
               band's place, and the K6 line those of a tile: positive,
               negative and scatter; come_tpu_torch/tools/pass_times.py)
  5. main    — come_tpu_torch.main on --dataset blogcatalog (pretrain 1,
               outer 1) on cuda, with the kernels' launch counters reset
               just before and read just after
  6. K6      — one BlogCatalog-width O1 micro-step (32768 window pairs of
               256 real walks, down_sample 1e-3 masks, KP 512, 32 tiles)
               through the fused SGNS kernel and its plain version
  7. K7      — the same on one tied table with 32768 arcs
  8. karate  — the CLI's default karate preset (per-pair negatives): no
               kernel may launch
  9. shared  — karate with shared negatives: O1 through K6, O2 through K7
 10. micro   — the micro-batched main path through the CLI: blogcatalog
               with --down-sample 1e-3 --o2-mode xla (walks per node 2,
               pretrain 0, outer 1): O1 through K6, O2 per arc through K7
 11. paired  — the CLI on --dataset blogcatalog --o2-mode paired (pretrain
               1, outer 1): O1 through K1, O2 through K5, no K2
 12. bench   — ComETrainer with the reference bench's kernel configuration
               (bench.py:174-191: walk_kernel_bf16, walk_pool_refresh 8,
               batch_walks 2048, batch_edges 524288; pretrain 1, outer 1)
               and the walker: K1b and K2b, nothing else
 13. bench gen — the same with walk_gen "kernel" (bench.py:207-216): K4 in
               its bf16 mode and K2b, nothing else
 14. large-v — the CLI on --dataset synthetic-10m at full width, depth cut
               to walks per node 5, pretrain 1, outer 1 (bench.py:124-129's
               cut, walks per node 1, ended at NMI 0.001 on an H100 80GB
               HBM3 at 700 W both with bf16 and f32 tables: the communities
               emerge between 4 and 6 walk passes per node): O1 through
               K3, O2 through K2, nothing
               else; prints the peak device memory and K3's CAS retries
Since PR 5, after phase 14:
 15. probes  — P2 (tools/probe_smem.py: the shared-memory capacity search,
               which must stop at cudaDevAttrMaxSharedMemoryPerBlockOptin
               and be refused above it with cudaErrorInvalidValue), P3
               (tools/probe_star.py: the star kernel's sections at the
               BlogCatalog layout, µs per group by variant and unroll
               beside K2b's, the full variant held against K2b's plain
               version under the bf16 check and every variant against its
               plain version) and P4 (tools/probe_star_floor.py: the seven
               per-group floors, each value exactly its plain version's)
 16. parity  — the parity CLI (evaluation/parity.py) on karate, 3
               iterations, on cuda: K1, K5, K2 and K7 rows against the
               numpy oracle; it must return 0
 17. profile — the karate CLI with shared negatives (K6/K7) under
               --profile-dir into a temporary directory: the trace must
               exist and name a K6 kernel
Phases 5, 8-14 and 15-17 each reset every launch counter just before they
run and read them just after; each wrapper counts only its own launches, by
mode.  Every phase line ends with its seconds.  Then a JSON line of the
kernels (the bf16 modes with their bench-shape checks and their launches in
phases 12-13; K3's launches from phase 14; P1's from its own phase, as it
is a probe and on no path), each with its bound: the larger of the bytes
it must move (each touched row and each input read once, each output
written once) over 3.35 TB/s and the operations its inputs need over 67
TFLOP/s (f32 products) or 989 TFLOP/s (bf16 products; the H100 SXM's
published peaks); and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Tolerance of the kernel checks, on each table element's update (table after
the step minus before): |upd_kernel - upd_plain| <= 1e-6 + 1e-4 |upd_plain|
(f32; atomic merges, whose order varies from run to run, move an update by
~1e-7; a TF32 or bf16 negative pass moves it by 1e-5 to 1e-4 and fails),
loss within rtol 1e-4, pair counts exact; phase 4h's hot-row shape takes
the same check against its plain step in float64 (EDGE_SHAPES' note).  K4 and K5 in f32 take this tolerance.  The bf16 modes take their
own (come_tpu_torch/ops/tolerance.py, where its readings are): a product of
two bf16 values is exact in f32, so the kernel and its plain version differ
only in the order of their f32 sums; where two orders straddle a rounding
boundary a rounded g flips by one bf16 ulp, and flips compound over a
step's groups.  So the relative L2 error of the updates must be <= 4e-4,
every element within 2^-8 of the largest plain update, and the f32 plain
step must lie at least 5x farther from the bf16 plain step than the kernel
does and 2x past the bound, so the check tells a bf16 pass from an f32 one.
Each bf16 line prints the error, the bound and that distance.  Phase 5 must
give finite losses and embeddings, train every edge twice in O2, and reach
NMI >= 0.8; phase 8 NMI >= 0.5 and phase 9 NMI >= 0.3 (the JAX package's
own karate floors); phase 10 finite losses and embeddings and exactly S * B
O2 pairs (S = ceil(2E / batch_edges) batches of B arcs); phase 11 finite
losses, exactly 2 * S * B_r * 64 O2 pairs and NMI >= 0.8; phases 12-13
finite losses and NMI >= 0.8.  K3 takes ops/tolerance.py's K3 check (99%
of touched elements bit-identical, relative L2 error of the updates within
its bound, the f32-table step 5x farther away), loss within rtol 1e-4 and
pair counts exact; P1 the plain version's rows and tables bit for bit and
its checksum to 1e-12.  Phase 14 must give finite losses, one K3 launch
per O1 macro step with a pair count inside what those steps can train,
and NMI >= 0.8.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-6  # on the update of each table element
SEED = 0
# the H100 SXM's published peaks (at its 700 W limit): device memory,
# f32 outside the tensor cores, dense bf16
HBM_BPS, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# NMI after pretrain 1 + outer 1 on the blogcatalog stand-in: 0.9422 on an
# H100 at SEED; the full preset reaches 0.96 (the JAX reference 0.954)
NMI_FLOOR = 0.8
# karate floors of the JAX package's tests (tests/test_trainer_e2e.py:37,
# tests/test_pallas_trainer.py:27)
KARATE_NMI_FLOOR, KARATE_SHARED_NMI_FLOOR = 0.5, 0.3


# Phase 4h's shapes (V, d, B, L, W, KP, R, hot): the whole walk in the band
# (W >= L - 1), one slot per walk, an odd L with W wider than a strip, d at
# its bound 192 and at 2, walks that repeat one row heavily, ragged and
# large pools (KP 100 and 2048, R 3).  On bf16 tables V is at least 20000:
# K3's check holds steps whose walks repeat few rows, since its CAS loops
# write a row's repeats within a group in any order (ops/tolerance.py); its
# float64 emulation of that order fails the check with the hot row (0.52 of
# touched elements identical), so that shape runs in f32 and bf16 only.
# In f32 the hot row's step is held against the plain version run in
# float64 (acc): the plain f32 step's own rounding there reaches 0.91 of
# the f32 bound (worst of 5 runs on an H100), so two f32 steps that round
# in different orders fail it in a share of runs; the kernel, whose scatter
# sums a row's slots in f64, reads 0.18 of it against the float64 step.
EDGE_SHAPES = [
    (3000, 128, 16, 128, 127, 64, 1, False),
    (500, 64, 16, 1, 3, 16, 1, False),
    (2000, 128, 24, 37, 13, 100, 3, False),
    (2000, 192, 16, 80, 10, 128, 1, False),
    (2000, 2, 16, 20, 3, 64, 1, False),
    (2000, 128, 16, 80, 10, 512, 1, True),
    (20000, 128, 24, 80, 10, 2048, 3, False),
]

# Phase 4i's star layouts (V, d, E, KP, R, layout): see star_edge_layout;
# d at its bound 192 and at 2, a ragged and a small pool (KP 100, R 3).
STAR_EDGES = [
    (3000, 128, 20000, 512, 1, "hub"),
    (400, 128, 150, 64, 1, "fat"),
    (3000, 128, 20000, 512, 1, "pads"),
    (2000, 192, 12000, 128, 1, "random"),
    (2000, 2, 12000, 64, 1, "random"),
    (2000, 128, 12000, 100, 3, "random"),
    (2000, 128, 9000, 512, 2, "ragged"),
]
# Phase 4i's K6/K7 shapes (V, d, P, TP, KP): pools of 100 and 2048 rows, d
# 192 and 2, tiles of 64 and 777 pairs; the second tile is all masked.
FUSED_EDGES = [
    (2000, 128, 3000, 64, 100),
    (2000, 128, 3000, 777, 2048),
    (2000, 192, 3000, 777, 512),
    (2000, 2, 3000, 64, 100),
]


def star_edge_layout(V, E, layout, seed, max_fanout=32):
    """(slots, meta) of a star layout on E random edges of V nodes, its
    segments split at ``max_fanout``: "random" as they come; "hub" with
    node 0 joined to 300 more nodes; "fat" only node 0 and 150 neighbours
    at max_fanout 127 (one segment fills a row); "pads" with every third
    segment dropped to pads (pads mid-row); "ragged" cut to 8k + 5 rows (a
    ragged last group).  The tests build their star layouts here too."""
    from come_tpu_torch.sampling import build_star_layout
    from come_tpu_torch.sampling.stars import PAD_META

    rng = np.random.default_rng(seed)
    u = rng.integers(0, V, E)
    v = (u + 1 + rng.integers(0, V - 1, E)) % V
    fanout = max_fanout
    if layout == "hub":
        u = np.concatenate([u, np.zeros(300, np.int64)])
        v = np.concatenate([v, 1 + rng.choice(V - 1, 300, replace=False)])
    elif layout == "fat":
        u, v, fanout = np.zeros(150, np.int64), np.arange(1, 151), 127
    slots, meta = build_star_layout(u, v, V, max_fanout=fanout)
    if layout == "pads":
        seg = np.where(meta >= 0, np.arange(meta.size) // 128 * 128
                       + (meta >> 1), -1)
        drop = np.isin(seg, seg[(meta >= 0) & (meta & 1 == 1)][1::3])
        slots = np.where(drop, 0, slots).astype(np.int32)
        meta = np.where(drop, PAD_META, meta).astype(np.int32)
    elif layout == "ragged":
        rows = meta.size // 128
        keep = 128 * (rows - (rows - 5) % 8)
        slots, meta = slots[:keep], meta[:keep]
    return slots, meta


_LAST = [time.perf_counter()]


def phase(name: str, msg: str) -> None:
    now = time.perf_counter()
    print(f"[{name}] {msg} ({now - _LAST[0]:.1f} s)", flush=True)
    _LAST[0] = now


def bound(flops: float, nbytes: float, bf16: bool):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take for ``flops`` operations on bf16 (or f32) products and ``nbytes``
    bytes moved."""
    t_b = nbytes / HBM_BPS
    t_f = flops / (PEAK_BF16 if bf16 else PEAK_F32)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def n_unique(*ids) -> int:
    return int(torch.unique(torch.cat([i.reshape(-1).long() for i in ids]))
               .numel())


def walk_bound(walks, pools, n_pairs, d, es, bf16, extra_bytes=0):
    """Bound of one walk-kernel step (K1, K1b, K3, K4, K5): every real slot
    scores the pool (3 * KP * d multiply-adds) and each trained pair costs
    3 * d; the node rows and the ctx and pool rows are read and written
    once at ``es`` bytes an element; walks, window draws and pools read
    once as int32."""
    B, L = walks.shape
    G = -(-B // 8)
    real = walks[torch.arange(G * 8, device=walks.device) % B]
    KP = pools.shape[-1]
    flops = 2.0 * (3 * d * float(n_pairs) + 3 * KP * d * real.numel())
    rows = n_unique(real) + n_unique(real, pools)
    nbytes = 2.0 * rows * d * es + 4.0 * (2 * G * 1024 + pools.numel())
    return bound(flops, nbytes + extra_bytes, bf16)


def star_bound(slots, meta, pools, n_pairs, d, bf16, pad_meta):
    """Bound of one star step (K2, K2b): every non-pad slot scores the
    pool, each trained pair costs 3 * d; the tied table's slot and pool
    rows are read and written once; slots, meta and pools read once."""
    real = slots[meta != pad_meta]
    KP = pools.shape[-1]
    flops = 2.0 * (3 * d * float(n_pairs) + 3 * KP * d * real.numel())
    nbytes = (2.0 * n_unique(real, pools) * d * 4
              + 4.0 * (slots.numel() + meta.numel() + pools.numel()))
    return bound(flops, nbytes, bf16)


def pairs_bound(c, x, m, pool, d, tied):
    """Bound of one micro-batched step (K6, K7): every unmasked pair scores
    the pool and its context (3 * (KP + 1) * d multiply-adds); the centre,
    context and pool rows are read and written once; c, x, m and the pool
    read once."""
    keep = m > 0
    n = int(keep.sum())
    flops = 2.0 * 3 * (pool.numel() + 1) * d * n
    if tied:
        rows = n_unique(c[keep], x[keep], pool)
    else:
        rows = n_unique(c[keep]) + n_unique(x[keep], pool)
    nbytes = 2.0 * rows * d * 4 + 4.0 * (3 * c.numel() + pool.numel())
    return bound(flops, nbytes, False)


def compare(name, init, kern, plain):
    """Max abs / rel errors of the kernel's table updates (tables after the
    step minus ``init``) against the plain version's; raises past the
    stated tolerance.  A plain step in float64 (``acc``) is compared in
    float64."""
    *k_tabs, k_loss, k_pairs = kern
    *p_tabs, p_loss, p_pairs = plain
    max_abs = max_rel = 0.0
    for t0, a, b in zip(init, k_tabs, p_tabs):
        t0, a = t0.to(b.dtype), a.to(b.dtype)
        du = b - t0
        err = ((a - t0) - du).abs()
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / du.abs().clamp_min(1e-30)).max()))
        bad = int((err > ATOL + RTOL * du.abs()).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} table updates past "
                                 f"{ATOL} + {RTOL}*|plain update|")
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    if loss_rel > 1e-4 or float(k_pairs) != float(p_pairs):
        raise AssertionError(
            f"{name}: loss {float(k_loss)} vs {float(p_loss)}, pairs "
            f"{float(k_pairs)} vs {float(p_pairs)}")
    if not all(torch.isfinite(t).all() for t in k_tabs):
        raise AssertionError(f"{name}: non-finite table")
    return max_abs, max_rel, loss_rel


def compare_bf16(name, init, kern, plain, f32):
    """The bf16 check (module docstring) of the kernel's step against the
    plain version's, with the plain f32 step's tables ``f32``: returns
    (max abs update error, relative L2 error, f32-vs-bf16 distance, worst
    element error over 2^-8 max|plain update|)."""
    from come_tpu_torch.ops.tolerance import check_bf16

    *k_tabs, k_loss, k_pairs = kern
    *p_tabs, p_loss, p_pairs = plain
    err = check_bf16(name, init, k_tabs, p_tabs, f32)
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    if loss_rel > 1e-4 or float(k_pairs) != float(p_pairs):
        raise AssertionError(
            f"{name}: loss {float(k_loss)} vs {float(p_loss)}, pairs "
            f"{float(k_pairs)} vs {float(p_pairs)}")
    if not all(torch.isfinite(t).all() for t in k_tabs):
        raise AssertionError(f"{name}: non-finite table")
    return err


def bf16_line(err, ms, plain_ms):
    from come_tpu_torch.ops.tolerance import BF16_L2

    return (f"max_abs {err[0]:.3e} rel_l2 {err[1]:.3e} (bound {BF16_L2}; "
            f"f32-vs-bf16 distance {err[2]:.3e}, "
            f"{err[2] / max(err[1], 1e-30):.3g}x the error, "
            f"{err[2] / BF16_L2:.2f}x the bound; worst element "
            f"{err[3]:.3f} of 2^-8 max|plain update|) | kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{smi} | torch {torch.__version__} cuda "
                    f"{torch.version.cuda} | {kind}")
    dev = torch.device("cuda", 0)

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from come_tpu_torch.config import get_config
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.ops import build
    from come_tpu_torch.ops.sgns import (
        fused_sgns_step,
        fused_sgns_step_reference,
        fused_sgns_step_tied,
        fused_sgns_step_tied_reference,
    )
    from come_tpu_torch.ops.star_sgns import (
        star_sgns_step,
        star_sgns_step_reference,
    )
    from come_tpu_torch.ops.row_probe import (
        row_gather_probe,
        row_gather_probe_reference,
        row_scatter_probe,
        row_scatter_probe_reference,
    )
    from come_tpu_torch.ops.floor_probe import floor_probe
    from come_tpu_torch.ops.smem_probe import (
        smem_optin_bytes,
        smem_probe,
        smem_probe_reference,
    )
    from come_tpu_torch.ops.star_probe import star_probe_step
    from come_tpu_torch.ops.walk_sgns import (
        NW,
        NWL,
        cas_retries,
        walk_sgns_gen_step,
        walk_sgns_gen_step_reference,
        walk_sgns_step,
        walk_sgns_step_reference,
        walks_from_bits,
    )
    from come_tpu_torch.sampling import (
        build_alias_table,
        build_star_layout,
        random_walks,
        sample_alias,
        unigram_weights,
    )
    from come_tpu_torch.sampling.stars import PAD_META
    from come_tpu_torch.sampling.windows import (
        skipgram_pairs,
        subsample_keep_probs,
    )
    from come_tpu_torch.tools.pass_times import (
        FUSED_PASSES,
        STAR_PASSES,
        cuda_ms,
        device_us,
        pass_split,
        split_text,
    )
    from come_tpu_torch.trainer import ComETrainer

    # each kernel (mode) and the wrapper attribute that counts its launches
    kernels = {
        "walk_sgns": (walk_sgns_step, "launches"),
        "star_sgns": (star_sgns_step, "launches"),
        "fused_sgns": (fused_sgns_step, "launches"),
        "fused_sgns_tied": (fused_sgns_step_tied, "launches"),
        "walk_sgns_bf16": (walk_sgns_step, "launches_bf16"),
        "star_sgns_bf16": (star_sgns_step, "launches_bf16"),
        "walk_sgns_gen": (walk_sgns_gen_step, "launches"),
        "walk_sgns_gen_bf16": (walk_sgns_gen_step, "launches_bf16"),
        "walk_sgns_paired": (walk_sgns_step, "launches_paired"),
        "walk_sgns_bf16_tables": (walk_sgns_step, "launches_bf16_tables"),
        "walk_sgns_gen_bf16_tables": (walk_sgns_gen_step,
                                      "launches_bf16_tables"),
        "row_gather_probe": (row_gather_probe, "launches"),
        "row_scatter_probe": (row_scatter_probe, "launches"),
        "smem_probe": (smem_probe, "launches"),
        "star_probe": (star_probe_step, "launches"),
        "floor_probe": (floor_probe, "launches"),
    }

    def reset_counts():
        for fn, attr in kernels.values():
            setattr(fn, attr, 0)

    def counts():
        return {name: getattr(fn, attr)
                for name, (fn, attr) in kernels.items()}

    def check_launches(where, launched, ran, idle):
        for name in ran:
            if launched[name] == 0:
                raise AssertionError(f"{where} launched no {name} kernel")
        for name in idle:
            if launched[name] != 0:
                raise AssertionError(f"{where} launched {name} "
                                     f"{launched[name]} times, expected 0")

    # 2. build
    path, secs = build.build(verbose=True)
    build.library()
    phase("build", f"{path.name} built in {secs:.2f} s (nvcc, sm_90a)")

    # 3. K1 at the BlogCatalog preset's shapes
    ds = get_dataset("blogcatalog")
    V, d, B, L, W, KP = ds.graph.num_nodes, 128, 256, 80, 10, 512
    gen = torch.Generator(device=dev).manual_seed(SEED)
    emb_in = torch.randn((V, d), generator=gen, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=gen, device=dev) * 0.1
    csr = ds.graph.to_device(dev)
    starts = torch.randint(0, V, (B,), generator=gen, device=dev)
    walks = random_walks(csr, starts, L, gen)
    G = B // 8
    wrow = torch.randint(1, W + 1, (G * NWL,), generator=gen, device=dev,
                         dtype=torch.int32)
    pools = torch.randint(0, V, (G, KP), generator=gen, device=dev,
                          dtype=torch.int32)
    lr, negw = 0.025, 5.0 / KP

    def k1(fn):
        return fn(emb_in.clone(), emb_out.clone(), walks, wrow, pools, lr,
                  negw, window=W, pool_refresh=1)

    kern = k1(walk_sgns_step)
    plain = k1(walk_sgns_step_reference)
    torch.cuda.synchronize()
    k1_err = compare("K1", (emb_in, emb_out), kern, plain)
    k1_ms = cuda_ms(lambda: k1(walk_sgns_step))
    k1_plain_ms = cuda_ms(lambda: k1(walk_sgns_step_reference))
    k1_bound = walk_bound(walks, pools, float(kern[3]), d, 4, False)
    # the passes of a K1 step and the card's busy share of one: the device
    # time of every kernel the step launches over its CUDA-event time (on
    # tables it updates in place, no clones), as K3's below
    tabs = [emb_in.clone(), emb_out.clone()]

    def k1_step():
        walk_sgns_step(*tabs, walks, wrow, pools, lr, negw, window=W,
                       pool_refresh=1)

    step_ms = cuda_ms(k1_step)
    k1_split, k1_dev_us = pass_split(k1_step, G)
    del tabs
    phase("K1", f"walk_sgns V={V} d={d} B={B} L={L} W={W} KP={KP} R=1 "
                f"G={G}: max_abs {k1_err[0]:.3e} max_rel {k1_err[1]:.3e} "
                f"loss_rel {k1_err[2]:.3e} pairs {float(kern[3]):.0f} | "
                f"kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms "
                f"(tol {ATOL} + {RTOL}*|plain update|) | device us per "
                f"group: {split_text(k1_split)} | one K1 step {step_ms:.3f} "
                f"ms, device busy {k1_dev_us / (step_ms * 1e3):.1%}")

    # 3b. K1b: the same inputs in the bf16 mode
    def k1b(fn):
        return fn(emb_in.clone(), emb_out.clone(), walks, wrow, pools, lr,
                  negw, window=W, pool_refresh=1, mxu_bf16=True)

    kern1b = k1b(walk_sgns_step)
    plain1b = k1b(walk_sgns_step_reference)
    torch.cuda.synchronize()
    k1b_err = compare_bf16("K1b", (emb_in, emb_out), kern1b, plain1b,
                           plain[:2])
    phase("K1b", "walk_sgns bf16, K1's inputs: " + bf16_line(
        k1b_err, cuda_ms(lambda: k1b(walk_sgns_step)),
        cuda_ms(lambda: k1b(walk_sgns_step_reference))))
    del kern1b, plain1b

    # 4. K2 on the stand-in's star layout: one 65536-slot macro step
    u, v = ds.graph.edges_undirected()
    slots, meta = build_star_layout(u, v, V)
    rows = slots.shape[0] // 128
    perm = np.random.default_rng(SEED).permutation(rows)[:512]  # of ~2.7k
    sl = torch.as_tensor(slots.reshape(-1, 128)[perm], device=dev).reshape(-1)
    mt = torch.as_tensor(meta.reshape(-1, 128)[perm], device=dev).reshape(-1)
    G2 = sl.shape[0] // NWL
    pools2 = torch.randint(0, V, (G2, KP), generator=gen, device=dev,
                           dtype=torch.int32)

    def k2(fn):
        return fn(emb_in.clone(), sl, mt, pools2, lr, negw, pool_refresh=1)

    kern2 = k2(star_sgns_step)
    plain2 = k2(star_sgns_step_reference)
    torch.cuda.synchronize()
    k2_err = compare("K2", (emb_in,), kern2, plain2)
    k2_ms = cuda_ms(lambda: k2(star_sgns_step))
    k2_plain_ms = cuda_ms(lambda: k2(star_sgns_step_reference))
    k2_bound = star_bound(sl, mt, pools2, float(kern2[2]), d, False, PAD_META)
    phase("K2", f"star_sgns V={V} d={d} T={sl.shape[0]} KP={KP} R=1 "
                f"G={G2}: max_abs {k2_err[0]:.3e} max_rel {k2_err[1]:.3e} "
                f"loss_rel {k2_err[2]:.3e} pairs {float(kern2[2]):.0f} | "
                f"kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms "
                f"(tol {ATOL} + {RTOL}*|plain update|) | device us per "
                f"group: " + split_text(pass_split(
                    lambda: k2(star_sgns_step), G2, STAR_PASSES)[0]))

    # 4b. K2b: the same inputs in the bf16 mode
    def k2b(fn):
        return fn(emb_in.clone(), sl, mt, pools2, lr, negw, pool_refresh=1,
                  mxu_bf16=True)

    kern2b = k2b(star_sgns_step)
    plain2b = k2b(star_sgns_step_reference)
    torch.cuda.synchronize()
    k2b_err = compare_bf16("K2b", (emb_in,), kern2b, plain2b, plain2[:1])
    phase("K2b", "star_sgns bf16, K2's inputs: " + bf16_line(
        k2b_err, cuda_ms(lambda: k2b(star_sgns_step)),
        cuda_ms(lambda: k2b(star_sgns_step_reference))))
    del kern, plain, kern2, plain2, kern2b, plain2b

    # 4c. K4: a macro step of B walks generated in the kernel
    bits = torch.randint(-2**31, 2**31, (G * NWL,), generator=gen,
                         device=dev, dtype=torch.int32)

    def k4(fn):
        return fn(emb_in.clone(), emb_out.clone(), starts, bits, csr.indptr,
                  csr.indices, wrow, pools, lr, negw, walk_length=L,
                  window=W, pool_refresh=1, return_walks=True)

    src = torch.repeat_interleave(torch.arange(V, device=dev),
                                  csr.degrees.long())
    arc_keys = torch.sort(src * V + csr.indices.long()).values

    def check_walks(name, kw, pw):
        """K4's walks: the plain version's bit for bit, every hop an edge
        (or a stay at a node of degree 0)."""
        if not torch.equal(kw, pw):
            raise AssertionError(f"{name}: {int((kw != pw).sum())} generated "
                                 f"walk slots differ from the plain version's")
        here, nxt = kw[:, :-1].long(), kw[:, 1:].long()
        hop = here * V + nxt
        found = arc_keys[torch.searchsorted(arc_keys, hop).clamp_max(
            arc_keys.numel() - 1)]
        stay = (here == nxt) & (csr.degrees.long()[here] == 0)
        if not bool(((found == hop) | stay).all()):
            raise AssertionError(f"{name}: a generated hop is not an edge")

    *kern4, kw4 = k4(walk_sgns_gen_step)
    *plain4, pw4 = k4(walk_sgns_gen_step_reference)
    torch.cuda.synchronize()
    check_walks("K4", kw4, pw4)
    k4_err = compare("K4", (emb_in, emb_out), kern4, plain4)
    k4_ms = cuda_ms(lambda: k4(walk_sgns_gen_step))
    k4_plain_ms = cuda_ms(lambda: k4(walk_sgns_gen_step_reference))
    phase("K4", f"walk_sgns_gen V={V} d={d} B={B} L={L} W={W} KP={KP} "
                f"G={G}: walks bit-identical ({kw4.numel()} slots, every hop "
                f"an edge), max_abs {k4_err[0]:.3e} max_rel {k4_err[1]:.3e} "
                f"loss_rel {k4_err[2]:.3e} pairs {float(kern4[3]):.0f} | "
                f"kernel {k4_ms:.3f} ms, plain {k4_plain_ms:.3f} ms "
                f"(tol {ATOL} + {RTOL}*|plain update|)")
    del kern4, plain4

    # 4d. K5: one paired macro step, 512 rows of 64 shuffled edges
    eperm = torch.as_tensor(np.random.default_rng(SEED).permutation(
        u.shape[0])[:512 * 64], device=dev)
    uu, vv = (torch.as_tensor(a, device=dev)[eperm] for a in (u, v))
    rows = torch.stack([uu, vv], 1).reshape(512, 128)
    pools5 = torch.randint(0, V, (64, KP), generator=gen, device=dev,
                           dtype=torch.int32)

    def k5(fn):
        return fn(emb_in.clone(), emb_out.clone(), rows, None, pools5, lr,
                  negw, window=1, pool_refresh=1, paired=True)

    kern5 = k5(walk_sgns_step)
    plain5 = k5(walk_sgns_step_reference)
    torch.cuda.synchronize()
    k5_err = compare("K5", (emb_in, emb_out), kern5, plain5)
    k5_ms = cuda_ms(lambda: k5(walk_sgns_step))
    k5_plain_ms = cuda_ms(lambda: k5(walk_sgns_step_reference))
    k5_bound = walk_bound(rows, pools5, float(kern5[3]), d, 4, False)
    phase("K5", f"walk_sgns paired V={V} d={d} rows=512 KP={KP} R=1 G=64: "
                f"max_abs {k5_err[0]:.3e} max_rel {k5_err[1]:.3e} loss_rel "
                f"{k5_err[2]:.3e} pairs {float(kern5[3]):.0f} | kernel "
                f"{k5_ms:.3f} ms, plain {k5_plain_ms:.3f} ms (tol {ATOL} + "
                f"{RTOL}*|plain update|)")
    del kern5, plain5

    # 4e. K1b, K4 (bf16) and K2b at the shapes the bench path (phases 12
    # and 13) gives them: one 2048-walk O1 step (256 groups, R 8, unigram
    # pools [32, 512]) and the one star O2 step of batch_edges 524288 (the
    # whole layout in rps = ceil(NR / 8) * 8 rows, R 8)
    BB, RB = 2048, 8
    GB = BB // NW
    accept, alias = (torch.as_tensor(a, device=dev) for a in
                     build_alias_table(unigram_weights(ds.graph.degrees)))
    starts_b = torch.randint(0, V, (BB,), generator=gen, device=dev)
    walks_b = random_walks(csr, starts_b, L, gen)
    bits_b = torch.randint(-2**31, 2**31, (GB * NWL,), generator=gen,
                           device=dev, dtype=torch.int32)
    wrow_b = torch.randint(1, W + 1, (GB * NWL,), generator=gen, device=dev,
                           dtype=torch.int32)
    pools_b = sample_alias(accept, alias, gen, (-(-GB // RB), KP))

    def k1b_bench(fn, bf16=True):
        return fn(emb_in.clone(), emb_out.clone(), walks_b, wrow_b, pools_b,
                  lr, negw, window=W, pool_refresh=RB, mxu_bf16=bf16)

    kern, plain, f32 = (k1b_bench(walk_sgns_step),
                        k1b_bench(walk_sgns_step_reference),
                        k1b_bench(walk_sgns_step_reference, False))
    torch.cuda.synchronize()
    k1bb_err = compare_bf16("K1b (bench)", (emb_in, emb_out), kern, plain,
                            f32[:2])
    k1bb_bound = walk_bound(walks_b, pools_b, float(kern[3]), d, 4, True)
    k1bb_ms = cuda_ms(lambda: k1b_bench(walk_sgns_step))
    k1bb_plain_ms = cuda_ms(lambda: k1b_bench(walk_sgns_step_reference))
    phase("K1b bench", f"walk_sgns bf16 B={BB} R={RB} G={GB} pools "
                       f"{tuple(pools_b.shape)}: "
                       + bf16_line(k1bb_err, k1bb_ms, k1bb_plain_ms)
                       + " | device us per group: "
                       + split_text(pass_split(
                           lambda: k1b_bench(walk_sgns_step), GB)[0]))

    def k4_bench(fn, bf16=True):
        return fn(emb_in.clone(), emb_out.clone(), starts_b, bits_b,
                  csr.indptr, csr.indices, wrow_b, pools_b, lr, negw,
                  walk_length=L, window=W, pool_refresh=RB, mxu_bf16=bf16,
                  return_walks=True)

    *kern, kw = k4_bench(walk_sgns_gen_step)
    *plain, pw = k4_bench(walk_sgns_gen_step_reference)
    *f32, _ = k4_bench(walk_sgns_gen_step_reference, False)
    torch.cuda.synchronize()
    check_walks("K4 (bench)", kw, pw)
    k4b_err = compare_bf16("K4 (bench)", (emb_in, emb_out), kern, plain,
                           f32[:2])
    # K4 also reads starts, and per hop two offsets and one neighbour
    k4b_bound = walk_bound(kw, pools_b, float(kern[3]), d, 4, True,
                           4.0 * BB + 12.0 * BB * (L - 1))
    k4b_ms = cuda_ms(lambda: k4_bench(walk_sgns_gen_step))
    k4b_plain_ms = cuda_ms(lambda: k4_bench(walk_sgns_gen_step_reference))
    phase("K4 bench", f"walk_sgns_gen bf16 B={BB} R={RB} G={GB}: walks "
                      f"bit-identical ({kw.numel()} slots, every hop an "
                      f"edge), " + bf16_line(k4b_err, k4b_ms, k4b_plain_ms))

    lay_s, lay_m = slots.reshape(-1, 128), meta.reshape(-1, 128)
    NR = lay_s.shape[0]
    rps = -(-max(8, min(-(-524288 // 128), NR)) // 8) * 8
    if rps < NR:
        raise AssertionError(f"bench O2: {NR} layout rows need more than "
                             f"one step of {rps}")
    rperm = np.random.default_rng(SEED).permutation(NR)
    sl_b = torch.as_tensor(np.pad(lay_s[rperm], ((0, rps - NR), (0, 0))),
                           device=dev).reshape(-1)
    mt_b = torch.as_tensor(np.pad(lay_m[rperm], ((0, rps - NR), (0, 0)),
                                  constant_values=PAD_META),
                           device=dev).reshape(-1)
    G2B = rps * 128 // NWL
    pools2_b = sample_alias(accept, alias, gen, (-(-G2B // RB), KP))

    def k2b_bench(fn, bf16=True):
        return fn(emb_in.clone(), sl_b, mt_b, pools2_b, lr, negw,
                  pool_refresh=RB, mxu_bf16=bf16)

    kern, plain, f32 = (k2b_bench(star_sgns_step),
                        k2b_bench(star_sgns_step_reference),
                        k2b_bench(star_sgns_step_reference, False))
    torch.cuda.synchronize()
    k2bb_err = compare_bf16("K2b (bench)", (emb_in,), kern, plain, f32[:1])
    k2bb_bound = star_bound(sl_b, mt_b, pools2_b, float(kern[2]), d, True,
                            PAD_META)
    k2bb_ms = cuda_ms(lambda: k2b_bench(star_sgns_step))
    k2bb_plain_ms = cuda_ms(lambda: k2b_bench(star_sgns_step_reference))
    phase("K2b bench", f"star_sgns bf16 T={sl_b.numel()} R={RB} G={G2B} "
                       f"pools {tuple(pools2_b.shape)} (one step): "
                       + bf16_line(k2bb_err, k2bb_ms, k2bb_plain_ms)
                       + " | device us per group: "
                       + split_text(pass_split(
                           lambda: k2b_bench(star_sgns_step), G2B,
                           STAR_PASSES)[0]))
    del emb_in, emb_out, kern, plain, f32
    torch.cuda.empty_cache()

    # 4h. the walk kernel at the shapes that stress its band strips (8
    # centres) and its bf16 negative tiles (64 slots x 32 pool rows), in
    # f32, in bf16 products and on bf16 tables (K3, SR), each held to its
    # mode's check
    from come_tpu_torch.ops.tolerance import check_k3

    edge_lines = []
    for (Ve, de, Be, Le, We, KPe, Re, hot) in EDGE_SHAPES:
        for mode in ("f32", "bf16", "bf16_tables"):
            if hot and mode == "bf16_tables":
                continue  # outside K3's check (EDGE_SHAPES' note)
            Vm = max(Ve, 20000) if mode == "bf16_tables" else Ve
            ge = torch.Generator(device=dev).manual_seed(Vm + de + Le)
            init = [torch.randn((Vm, de), generator=ge, device=dev) * 0.1
                    for _ in range(2)]
            if mode == "bf16_tables":
                init = [t.to(torch.bfloat16) for t in init]
            we = torch.randint(0, Vm, (Be, Le), generator=ge, device=dev,
                               dtype=torch.int32)
            if hot:
                we[:, ::2] = 7
            Ge = -(-Be // NW)
            wre = torch.randint(1, We + 1, (Ge * NWL,), generator=ge,
                                device=dev, dtype=torch.int32)
            pe = torch.randint(0, Vm, (-(-Ge // Re), KPe), generator=ge,
                               device=dev, dtype=torch.int32)

            def edge(fn, tables, **kw):
                return fn(*[t.clone() for t in tables], we, wre, pe, lr,
                          5.0 / KPe, window=We, pool_refresh=Re, **kw)

            bf = mode == "bf16"
            seed = 77 if mode == "bf16_tables" else None
            kern = edge(walk_sgns_step, init, mxu_bf16=bf, sr_seed=seed)
            if hot and mode == "f32":  # float64 (EDGE_SHAPES' note)
                plain = edge(walk_sgns_step_reference,
                             [t.double() for t in init], acc=torch.float64)
            else:
                plain = edge(walk_sgns_step_reference, init, mxu_bf16=bf,
                             sr_seed=seed)
            torch.cuda.synchronize()
            name = f"edge {mode} V={Vm} d={de} L={Le} W={We} KP={KPe} R={Re}"
            if Le == 1:  # no pairs: nothing may move
                if float(kern[3]) != 0.0 or not all(
                        torch.equal(a, b) for a, b in zip(kern[:2], init)):
                    raise AssertionError(f"{name}: tables moved without pairs")
                err = 0.0
            elif mode == "f32":
                err = compare(name, init, kern, plain)[0]
            elif mode == "bf16":
                err = compare_bf16(name, init, kern, plain, edge(
                    walk_sgns_step_reference, init)[:2])[1]
            else:
                if float(kern[3]) != float(plain[3]) or abs(
                        float(kern[2]) - float(plain[2])) > 1e-4 * abs(
                        float(plain[2])):
                    raise AssertionError(f"{name}: loss or pairs differ")
                err = check_k3(name, init, kern[:2], plain[:2], edge(
                    walk_sgns_step_reference, [t.float() for t in init],
                    mxu_bf16=True)[:2])[3]
            tag = " hot" if hot else ""
            edge_lines.append(f"L{Le} W{We} d{de} KP{KPe}{tag} {mode} "
                              f"{err:.3g}")
            del kern, plain, init
    phase("edges", "walk kernel vs plain (f32 max_abs, bf16 rel_l2, "
                   "bf16_tables identical share): " + "; ".join(edge_lines))
    torch.cuda.empty_cache()

    # 4i. the star kernel at layouts that stress its strips (fat and split
    # hubs, pads mid-row, a ragged last group) and the f32 negative pass's
    # tiles (d 192 and 2, KP 100 and 2048, ragged and all-masked tiles), in
    # f32 and bf16 products, each held to its mode's check
    edge_lines = []
    for (Ve, de, Ee, KPe, Re, layout) in STAR_EDGES:
        se, me = (torch.as_tensor(a, device=dev) for a in
                  star_edge_layout(Ve, Ee, layout, Ve + de))
        ge = torch.Generator(device=dev).manual_seed(Ve + de)
        init = torch.randn((Ve, de), generator=ge, device=dev) * 0.1
        Ge = -(-se.numel() // NWL)
        pe = torch.randint(0, Ve, (-(-Ge // Re), KPe), generator=ge,
                           device=dev, dtype=torch.int32)

        def star_edge(fn, bf):
            return fn(init.clone(), se, me, pe, lr, 5.0 / KPe,
                      pool_refresh=Re, mxu_bf16=bf)

        name = f"star edge {layout} V={Ve} d={de} KP={KPe} R={Re} G={Ge}"
        plain = star_edge(star_sgns_step_reference, False)
        err = compare(name, (init,), star_edge(star_sgns_step, False), plain)
        err_b = compare_bf16(name + " bf16", (init,),
                             star_edge(star_sgns_step, True),
                             star_edge(star_sgns_step_reference, True),
                             plain[:1])
        edge_lines.append(f"{layout} d{de} KP{KPe} R{Re} G{Ge} pairs "
                          f"{float(plain[2]):.0f}: f32 {err[0]:.3g}, bf16 "
                          f"{err_b[1]:.3g}")
    for (Ve, de, Pe, TPe, KPe) in FUSED_EDGES:
        ge = torch.Generator(device=dev).manual_seed(Ve + Pe + de)
        init = [torch.randn((Ve, de), generator=ge, device=dev) * 0.1
                for _ in range(2)]
        ce, xe, pe = (torch.randint(0, Ve, (n,), generator=ge, device=dev,
                                    dtype=torch.int32) for n in (Pe, Pe, KPe))
        me = (torch.rand(Pe, generator=ge, device=dev) < 0.6).float()
        me[TPe:2 * TPe] = 0.0
        kw = dict(tile_pairs=TPe)
        name = f"fused edge d={de} P={Pe} TP={TPe} KP={KPe}"
        err6 = compare("K6 " + name, init, fused_sgns_step(
            *[t.clone() for t in init], ce, xe, pe, me, lr, 5.0 / KPe, **kw),
            fused_sgns_step_reference(*[t.clone() for t in init], ce, xe, pe,
                                      me, lr, 5.0 / KPe, **kw))
        err7 = compare("K7 " + name, init[:1], fused_sgns_step_tied(
            init[0].clone(), ce, xe, pe, me, lr, 5.0 / KPe, **kw),
            fused_sgns_step_tied_reference(init[0].clone(), ce, xe, pe, me,
                                           lr, 5.0 / KPe, **kw))
        edge_lines.append(f"K6/K7 d{de} TP{TPe} KP{KPe}: {err6[0]:.3g}, "
                          f"{err7[0]:.3g}")
    phase("star/f32 edges", "vs plain (f32 max_abs, bf16 rel_l2): "
                            + "; ".join(edge_lines))
    torch.cuda.empty_cache()

    def large_v_kernels():
        """Phases 4f-4g in their own scope (the BlogCatalog phases' names
        stay as they were); returns what the kernels line reads."""
        t_ds = time.perf_counter()
        # 4f. K3 at the large-V path's shapes: one synthetic-10m macro step
        from come_tpu_torch.ops.tolerance import K3_L2, check_k3

        big = get_dataset("synthetic-10m")
        t_ds = time.perf_counter() - t_ds
        csr10 = big.graph.to_device(dev)
        V, d, B, L, W, KP, R = big.graph.num_nodes, 128, 1024, 80, 10, 2048, 1
        G = B // NW
        acc10, ali10 = (torch.as_tensor(a, device=dev) for a in
                        build_alias_table(unigram_weights(big.graph.degrees)))
        init = [(torch.randn((V, d), generator=gen, device=dev) * 0.1).to(
            torch.bfloat16) for _ in range(2)]
        starts10 = torch.randint(0, V, (B,), generator=gen, device=dev)
        bits10 = torch.randint(-2**31, 2**31, (G * NWL,), generator=gen,
                               device=dev, dtype=torch.int32)
        walks10 = walks_from_bits(starts10, bits10, csr10.indptr, csr10.indices,
                                  L)
        wrow10 = torch.randint(1, W + 1, (G * NWL,), generator=gen, device=dev,
                               dtype=torch.int32)
        pools10 = sample_alias(acc10, ali10, gen, (G, KP))
        negw10 = 5.0 / KP

        def k3(fn, tables, **kw):
            return fn(*[t.clone() for t in tables], walks10, wrow10, pools10, lr,
                      negw10, window=W, pool_refresh=R, **kw)

        def k3_gen(fn, tables, **kw):
            return fn(*[t.clone() for t in tables], starts10, bits10,
                      csr10.indptr, csr10.indices, wrow10, pools10, lr, negw10,
                      walk_length=L, window=W, pool_refresh=R, **kw)

        def k3_check(name, kern, plain, f32):
            if float(kern[3]) != float(plain[3]) or abs(
                    float(kern[2]) - float(plain[2])) > 1e-4 * abs(float(plain[2])):
                raise AssertionError(
                    f"{name}: loss {float(kern[2])} vs {float(plain[2])}, pairs "
                    f"{float(kern[3])} vs {float(plain[3])}")
            if kern[0].dtype != torch.bfloat16 or not all(
                    torch.isfinite(t).all() for t in kern[:2]):
                raise AssertionError(f"{name}: tables not finite bf16")
            return check_k3(name, init, kern[:2], plain[:2], f32[:2])

        f32_10 = k3(walk_sgns_step_reference, [t.float() for t in init],
                    mxu_bf16=True)
        k3_lines = []
        retries = cas_retries(dev)
        for entry, fn, plain_fn, step_fn in (
                ("step", walk_sgns_step, walk_sgns_step_reference, k3),
                ("gen", walk_sgns_gen_step, walk_sgns_gen_step_reference, k3_gen)):
            for mode, seed in (("SR", 12345), ("truncation", None)):
                retries.zero_()
                kern = step_fn(fn, init, sr_seed=seed)
                plain = step_fn(plain_fn, init, sr_seed=seed)
                torch.cuda.synchronize()
                err = k3_check(f"K3 {entry} {mode}", kern, plain, f32_10)
                if entry == "step" and mode == "SR":
                    k3_err, k3_retries = err, float(retries)
                    k3_bound = walk_bound(walks10, pools10, float(kern[3]), d, 2,
                                          True)
                k3_lines.append(
                    f"{entry} {mode}: identical {err[3]:.5f} rel_l2 {err[1]:.3e} "
                    f"(bound {K3_L2}) f32-table distance {err[2]:.3e} "
                    f"({err[2] / max(err[1], 1e-30):.1f}x) max_abs {err[0]:.3e} "
                    f"CAS retries {float(retries):.0f}")
                del kern, plain
        k3_ms = cuda_ms(lambda: k3(walk_sgns_step, init, sr_seed=7))
        k3_plain_ms = cuda_ms(lambda: k3(walk_sgns_step_reference, init,
                                         sr_seed=7))
        init32 = [t.float() for t in init]
        k1_10_ms = cuda_ms(lambda: k3(walk_sgns_step, init32))
        k1_10_bound = walk_bound(walks10, pools10, float(f32_10[3]), d, 4, False)
        # the passes of a K3 step, and the card's busy share of one: the
        # device time of every kernel the step launches over the step's
        # CUDA-event time (on tables it updates in place, no clones)
        tabs = [t.clone() for t in init]

        def k3_step():
            walk_sgns_step(*tabs, walks10, wrow10, pools10, lr, negw10,
                           window=W, pool_refresh=R, sr_seed=7)

        step_ms = cuda_ms(k3_step)
        k3_split, k3_dev_us = pass_split(k3_step, G)
        k3_split = split_text(k3_split)
        busy = k3_dev_us / (step_ms * 1e3)
        del tabs
        phase("K3", f"walk_sgns bf16 tables V={V} d={d} B={B} L={L} W={W} "
                    f"KP={KP} R={R} G={G} (graph built in {t_ds:.1f} s): "
                    + "; ".join(k3_lines)
                    + f" | K3 {k3_ms:.3f} ms (plain {k3_plain_ms:.3f}, bound "
                    f"{k3_bound[0]:.4f} by {k3_bound[1]}), K1 on f32 tables "
                    f"{k1_10_ms:.3f} ms (bound {k1_10_bound[0]:.4f} by "
                    f"{k1_10_bound[1]}) | K3 device us per group: {k3_split} "
                    f"| one K3 step {step_ms:.3f} ms, device busy "
                    f"{busy:.1%}")
        del init32, f32_10
        torch.cuda.empty_cache()

        # 4g. P1: gather and scatter-add of N rows of a [500000, 128] table
        reset_counts()
        p1 = {}
        for dtype, es in ((torch.float32, 4), (torch.bfloat16, 2)):
            table = torch.randn((V, d), generator=gen, device=dev).to(dtype)
            for N, reps in ((2048, 16), (262144, 4)):
                # each timed call takes a fresh set of rows, so a set cached in
                # L2 by the call before does not stand in for device memory
                sets = [torch.randperm(V, generator=gen, device=dev)[:N].to(
                    torch.int32) for _ in range(reps)]
                idx = sets[0]
                upd = torch.randn((N, d), generator=gen, device=dev).to(dtype)
                rows_k, cs_k = row_gather_probe(table, idx)
                rows_p, cs_p = row_gather_probe_reference(table, idx)
                tk = row_scatter_probe(table.clone(), idx, upd)
                tp = row_scatter_probe_reference(table.clone(), idx, upd)
                torch.cuda.synchronize()
                if not (torch.equal(rows_k, rows_p) and torch.equal(tk, tp)) or \
                        abs(float(cs_k) - float(cs_p)) > 1e-12 * abs(float(cs_p)):
                    raise AssertionError(f"P1 {dtype} N={N}: rows, checksum "
                                         f"{float(cs_k)} vs {float(cs_p)} or "
                                         f"scatter-add differ")
                del tk, tp
                sets64 = [i.long() for i in sets]

                def per_call(fn, ids):
                    return cuda_ms(lambda: [fn(i) for i in ids]) / len(ids)

                g_ms = per_call(lambda i: row_gather_probe(table, i), sets)
                g_plain = per_call(
                    lambda i: row_gather_probe_reference(table, i), sets)
                g_lib = per_call(lambda i: torch.index_select(table, 0, i),
                                 sets64)
                s_ms = per_call(lambda i: row_scatter_probe(table, i, upd), sets)
                s_lib = per_call(lambda i: table.index_add_(0, i, upd), sets64)
                # the device readings only inform: the check is above and
                # the kernels line takes the CUDA-event times
                dev_us = [
                    device_us(lambda i: row_gather_probe(table, i), sets,
                              "row_gather", required=False),
                    device_us(lambda i: torch.index_select(table, 0, i),
                              sets64, required=False),
                    device_us(lambda i: row_scatter_probe(table, i, upd),
                              sets, "row_scatter", required=False),
                    device_us(lambda i: table.index_add_(0, i, upd),
                              sets64, required=False),
                ]
                gb = 2.0 * N * d * es + 4.0 * N
                sb = 3.0 * N * d * es + 4.0 * N
                p1[(es, N)] = dict(
                    g_ms=g_ms, g_plain=g_plain, g_lib=g_lib, s_ms=s_ms,
                    s_lib=s_lib, dev_us=dev_us, g_bound=bound(0.0, gb, False),
                    s_bound=bound(float(N * d), sb, False),
                    cs_err=abs(float(cs_k) - float(cs_p)))
                def us(t, nbytes=None):
                    """A device reading; a rate past the card's peak means
                    the profiler lost some of the session's records."""
                    if t is None:
                        return "not measured"
                    if nbytes is None:
                        return f"{t:.2f} us"
                    if nbytes / (t * 1e-6) > HBM_BPS:
                        return f"not measured ({t:.2f} us is past the peak)"
                    return (f"{t:.2f} us ({nbytes / t / 1e3:.1f} GB/s, "
                            f"{nbytes / (t * 1e-6) / HBM_BPS:.1%} of 3.35 "
                            f"TB/s)")

                du = dev_us
                phase("P1", f"{str(dtype)[6:]} rows of {d * es} B, N={N}: "
                            f"checksum {float(cs_k):.6f} (plain "
                            f"{float(cs_p):.6f}) | per call (CUDA events): "
                            f"gather {g_ms * 1e3:.2f} us, index_select "
                            f"{g_lib * 1e3:.2f} us, plain {g_plain * 1e3:.2f}"
                            f" us, scatter-add {s_ms * 1e3:.2f} us, "
                            f"index_add_ {s_lib * 1e3:.2f} us | device "
                            f"(profiler): gather {us(du[0], gb)}, "
                            f"index_select {us(du[1])}, scatter-add "
                            f"{us(du[2], sb)}, index_add_ {us(du[3])}")
            del table
        p1_launches = counts()
        torch.cuda.empty_cache()

        return dict(k3_err=k3_err, k3_ms=k3_ms, k3_plain_ms=k3_plain_ms,
                    k3_bound=k3_bound, p1=p1, p1_launches=p1_launches,
                    retries=retries)

    lv = large_v_kernels()
    torch.cuda.empty_cache()

    # 5. the main path, through the CLI's own entry
    from come_tpu_torch.main import build_argparser, run

    reset_counts()
    t0 = time.perf_counter()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "blogcatalog", "--device", "cuda",
        "--pretrain-epochs", "1", "--outer-iters", "1", "--seed", str(SEED),
    ]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    rec = hist[-1]
    check_launches("main path", launches, ("walk_sgns", "star_sgns"),
                   ("fused_sgns", "fused_sgns_tied", "walk_sgns_bf16",
                    "star_sgns_bf16", "walk_sgns_gen", "walk_sgns_gen_bf16",
                    "walk_sgns_paired"))
    for k in ("gmm_ll", "o1_loss", "o2_loss", "o3_loss", "nmi"):
        if not math.isfinite(rec[k]):
            raise AssertionError(f"main path: {k} = {rec[k]}")
    emb = trainer.embeddings()
    if emb.shape != (V, d) or not np.isfinite(emb).all():
        raise AssertionError("main path: embeddings not finite [V, d]")
    if rec["o2_pairs"] != 2 * ds.graph.num_edges:
        raise AssertionError("main path: O2 did not train every edge twice")
    if rec["nmi"] < NMI_FLOOR:
        raise AssertionError(f"main path: NMI {rec['nmi']:.4f} < {NMI_FLOOR}")
    phase("main", f"blogcatalog pretrain 1 + outer 1 in {wall:.1f} s: "
                  f"gmm {rec['gmm_ms']:.1f} ms, o1 {rec['o1_ms']:.1f} ms, "
                  f"o2 {rec['o2_ms']:.1f} ms, o3 {rec['o3_ms']:.1f} ms | "
                  f"o1_pairs {rec['o1_pairs']:.0f} o2_pairs "
                  f"{rec['o2_pairs']:.0f} | NMI {rec['nmi']:.4f} | "
                  f"launches {launches}")
    del trainer
    torch.cuda.empty_cache()

    # 6. K6 at the BlogCatalog width: the first micro-step of one macro step
    V, d, TP = ds.graph.num_nodes, 128, 1024
    keep = torch.as_tensor(subsample_keep_probs(ds.graph.degrees, 1e-3),
                           device=dev)
    emb_in = torch.randn((V, d), generator=gen, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=gen, device=dev) * 0.1
    c, x, m = (a.reshape(-1)[:32768] for a in
               skipgram_pairs(walks, W, gen, keep))
    pool = sample_alias(accept, alias, gen, (KP,))

    def k6(fn):
        return fn(emb_in.clone(), emb_out.clone(), c, x, pool, m, lr, negw,
                  tile_pairs=TP)

    kern6 = k6(fused_sgns_step)
    plain6 = k6(fused_sgns_step_reference)
    torch.cuda.synchronize()
    k6_err = compare("K6", (emb_in, emb_out), kern6, plain6)
    k6_bound = pairs_bound(c, x, m, pool, d, False)
    k6_ms = cuda_ms(lambda: k6(fused_sgns_step))
    k6_plain_ms = cuda_ms(lambda: k6(fused_sgns_step_reference))
    phase("K6", f"fused_sgns V={V} d={d} P={c.numel()} TP={TP} KP={KP} "
                f"(32 tiles): max_abs {k6_err[0]:.3e} max_rel "
                f"{k6_err[1]:.3e} loss_rel {k6_err[2]:.3e} pairs "
                f"{float(kern6[3]):.0f} | kernel {k6_ms:.3f} ms, plain "
                f"{k6_plain_ms:.3f} ms (tol {ATOL} + {RTOL}*|plain update|) "
                f"| device us per tile: " + split_text(pass_split(
                    lambda: k6(fused_sgns_step), 32, FUSED_PASSES)[0]))

    # 7. K7 on the tied table: 32768 shuffled arcs
    src, dst = (torch.as_tensor(a, device=dev) for a in ds.graph.arcs())
    arcs = torch.randperm(src.numel(), generator=gen, device=dev)[:32768]
    ones = torch.ones(arcs.numel(), device=dev)

    def k7(fn):
        return fn(emb_in.clone(), src[arcs], dst[arcs], pool, ones, lr, negw,
                  tile_pairs=TP)

    kern7 = k7(fused_sgns_step_tied)
    plain7 = k7(fused_sgns_step_tied_reference)
    torch.cuda.synchronize()
    k7_err = compare("K7", (emb_in,), kern7, plain7)
    k7_bound = pairs_bound(src[arcs], dst[arcs], ones, pool, d, True)
    k7_ms = cuda_ms(lambda: k7(fused_sgns_step_tied))
    k7_plain_ms = cuda_ms(lambda: k7(fused_sgns_step_tied_reference))
    phase("K7", f"fused_sgns_tied V={V} d={d} P={arcs.numel()} TP={TP} "
                f"KP={KP} (32 tiles): max_abs {k7_err[0]:.3e} max_rel "
                f"{k7_err[1]:.3e} loss_rel {k7_err[2]:.3e} pairs "
                f"{float(kern7[2]):.0f} | kernel {k7_ms:.3f} ms, plain "
                f"{k7_plain_ms:.3f} ms (tol {ATOL} + {RTOL}*|plain update|)")
    del emb_in, emb_out, kern6, plain6, kern7, plain7
    torch.cuda.empty_cache()

    def check_run(where, hist, nmi_floor):
        for rec in hist:
            for k in ("gmm_ll", "o1_loss", "o2_loss", "o3_loss", "nmi"):
                if not math.isfinite(rec[k]):
                    raise AssertionError(f"{where}: {k} = {rec[k]}")
        if hist[-1]["nmi"] < nmi_floor:
            raise AssertionError(f"{where}: NMI {hist[-1]['nmi']:.4f} < "
                                 f"{nmi_floor}")

    # 8. karate, the CLI's default preset: per-pair negatives, no kernel
    karate = get_dataset("karate")
    reset_counts()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "karate", "--device", "cuda", "--seed", str(SEED),
    ]))
    torch.cuda.synchronize()
    launches8 = counts()
    check_launches("karate per-pair", launches8, (), tuple(kernels))
    check_run("karate per-pair", hist, KARATE_NMI_FLOOR)
    phase("karate", f"per-pair preset: NMI {hist[-1]['nmi']:.4f}, o1 "
                    f"{hist[-1]['o1_ms']:.1f} ms, o2 {hist[-1]['o2_ms']:.1f} "
                    f"ms | launches {launches8}")

    # 9. karate with shared negatives (tests/test_pallas_trainer.py:14-22)
    cfg = get_config("karate").replace(
        negative_mode="shared", shared_negatives=32, pallas_tile_pairs=64,
        outer_iters=1, pretrain_epochs=2, walks_per_node=4, seed=SEED,
    )
    reset_counts()
    hist = ComETrainer(karate.graph, cfg, dev).train(karate.labels)
    torch.cuda.synchronize()
    launches9 = counts()
    check_launches("karate shared", launches9,
                   ("fused_sgns", "fused_sgns_tied"),
                   tuple(k for k in kernels if not k.startswith("fused")))
    check_run("karate shared", hist, KARATE_SHARED_NMI_FLOOR)
    phase("shared", f"karate shared negatives: NMI {hist[-1]['nmi']:.4f} | "
                    f"launches {launches9}")

    # 10. the micro-batched main path through the CLI
    reset_counts()
    t0 = time.perf_counter()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "blogcatalog", "--device", "cuda", "--down-sample",
        "1e-3", "--o2-mode", "xla", "--pretrain-epochs", "0",
        "--outer-iters", "1", "--walks-per-node", "2", "--seed", str(SEED),
    ]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    micro_launches = counts()
    check_launches("micro-batched path", micro_launches,
                   ("fused_sgns", "fused_sgns_tied"),
                   tuple(k for k in kernels if not k.startswith("fused")))
    check_run("micro-batched path", hist, 0.0)
    rec = hist[-1]
    emb = trainer.embeddings()
    if emb.shape != (V, d) or not np.isfinite(emb).all():
        raise AssertionError("micro-batched path: embeddings not finite")
    B, S = trainer.o2_arc_plan()
    if S != math.ceil(ds.graph.num_arcs / trainer.cfg.batch_edges) or (
            rec["o2_pairs"] != S * B):
        raise AssertionError(f"micro-batched path: o2_pairs "
                             f"{rec['o2_pairs']} != S*B = {S}*{B}")
    phase("micro", f"blogcatalog --down-sample 1e-3 --o2-mode xla, walks "
                   f"per node 2, outer 1 in {wall:.1f} s: gmm "
                   f"{rec['gmm_ms']:.1f} ms, o1 {rec['o1_ms']:.1f} ms, o2 "
                   f"{rec['o2_ms']:.1f} ms, o3 {rec['o3_ms']:.1f} ms | "
                   f"o1_pairs {rec['o1_pairs']:.0f} o2_pairs "
                   f"{rec['o2_pairs']:.0f} (S={S}, B={B}) | NMI "
                   f"{rec['nmi']:.4f} | launches {micro_launches}")
    del trainer
    torch.cuda.empty_cache()

    # 11. the paired O2 entry point through the CLI
    reset_counts()
    t0 = time.perf_counter()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "blogcatalog", "--device", "cuda", "--o2-mode",
        "paired", "--pretrain-epochs", "1", "--outer-iters", "1", "--seed",
        str(SEED),
    ]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paired_launches = counts()
    check_launches("paired path", paired_launches,
                   ("walk_sgns", "walk_sgns_paired"),
                   tuple(k for k in kernels
                         if k not in ("walk_sgns", "walk_sgns_paired")))
    check_run("paired path", hist, NMI_FLOOR)
    rec = hist[-1]
    B_r, S = trainer.o2_paired_plan()
    if rec["o2_pairs"] != 2 * S * B_r * 64:
        raise AssertionError(f"paired path: o2_pairs {rec['o2_pairs']} != "
                             f"2*S*B_r*64 = 2*{S}*{B_r}*64")
    phase("paired", f"blogcatalog --o2-mode paired, pretrain 1 + outer 1 in "
                    f"{wall:.1f} s: gmm {rec['gmm_ms']:.1f} ms, o1 "
                    f"{rec['o1_ms']:.1f} ms, o2 {rec['o2_ms']:.1f} ms, o3 "
                    f"{rec['o3_ms']:.1f} ms | o1_pairs {rec['o1_pairs']:.0f} "
                    f"o2_pairs {rec['o2_pairs']:.0f} (S={S}, B_r={B_r}) | "
                    f"NMI {rec['nmi']:.4f} | launches {paired_launches}")
    del trainer
    torch.cuda.empty_cache()

    # 12-13. the reference bench's kernel configuration through
    # ComETrainer, with the walker and with walk_gen="kernel"
    def bench_run(where, walk_gen, ran):
        cfg = get_config("blogcatalog").replace(
            num_communities=ds.num_communities, walk_kernel_bf16=True,
            walk_pool_refresh=8, batch_walks=2048, batch_edges=524288,
            walk_gen=walk_gen, pretrain_epochs=1, outer_iters=1, seed=SEED,
        )
        reset_counts()
        t0 = time.perf_counter()
        hist = ComETrainer(ds.graph, cfg, dev).train(ds.single_labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        check_launches(where, launched, ran,
                       tuple(k for k in kernels if k not in ran))
        check_run(where, hist, NMI_FLOOR)
        rec = hist[-1]
        phase(where, f"blogcatalog + bf16, R 8, batch_walks 2048, "
                     f"batch_edges 524288, walk_gen {walk_gen}, pretrain 1 + "
                     f"outer 1 in {wall:.1f} s: gmm {rec['gmm_ms']:.1f} ms, "
                     f"o1 {rec['o1_ms']:.1f} ms, o2 {rec['o2_ms']:.1f} ms, o3 "
                     f"{rec['o3_ms']:.1f} ms | o1_pairs {rec['o1_pairs']:.0f} "
                     f"o2_pairs {rec['o2_pairs']:.0f} | NMI "
                     f"{rec['nmi']:.4f} | launches {launched}")
        return launched

    bench_launches = bench_run("bench", "scan",
                               ("walk_sgns_bf16", "star_sgns_bf16"))
    gen_launches = bench_run("bench gen", "kernel",
                             ("walk_sgns_gen_bf16", "star_sgns_bf16"))

    # 14. the large-V path through the CLI: synthetic-10m at full width,
    # walks per node 5, pretrain 1, outer 1 (see the module docstring)
    reset_counts()
    retries = lv["retries"].zero_()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "synthetic-10m", "--device", "cuda", "--walks-per-node",
        "5", "--pretrain-epochs", "1", "--outer-iters", "1", "--seed",
        str(SEED),
    ]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    large_launches = counts()
    ran = ("walk_sgns_bf16_tables", "star_sgns")
    check_launches("large-v path", large_launches, ran,
                   tuple(k for k in kernels if k not in ran))
    check_run("large-v path", hist, NMI_FLOOR)
    rec = hist[-1]
    cfg10 = trainer.cfg
    n_starts = len(trainer.walk_starts) * cfg10.walks_per_node
    S10 = math.ceil(n_starts / min(cfg10.batch_walks, n_starts))
    epochs = cfg10.pretrain_epochs + cfg10.outer_iters
    # a walk trains at most sum_t min(W, t) + min(W, L-1-t) pairs (the full
    # window); each step wraps its B walks up to 8 * ceil(B / 8)
    L10 = cfg10.walk_length
    per_walk = sum(min(cfg10.window, t) + min(cfg10.window, L10 - 1 - t)
                   for t in range(L10))
    most = S10 * 8 * -(-cfg10.batch_walks // 8) * per_walk
    if large_launches["walk_sgns_bf16_tables"] != epochs * S10 or not (
            0 < rec["o1_pairs"] <= most):
        raise AssertionError(
            f"large-v path: {large_launches['walk_sgns_bf16_tables']} K3 "
            f"launches for {epochs} epochs of {S10} steps, o1_pairs "
            f"{rec['o1_pairs']} outside (0, {most}]")
    if trainer.params.node_emb.dtype != torch.float32:
        raise AssertionError("large-v path: params not f32 after O1")
    emb = trainer.embeddings()
    g10 = trainer.graph
    if emb.shape != (g10.num_nodes, cfg10.dim) or not np.isfinite(emb).all():
        raise AssertionError("large-v path: embeddings not finite [V, d]")
    phase("large-v", f"synthetic-10m V={g10.num_nodes} E={g10.num_edges} K="
                     f"{cfg10.num_communities} KP={cfg10.shared_negatives}, "
                     f"walks per node 5, pretrain 1 + outer 1 in {wall:.1f} "
                     f"s: gmm {rec['gmm_ms']:.1f} ms, o1 {rec['o1_ms']:.1f} "
                     f"ms ({S10} steps), o2 {rec['o2_ms']:.1f} ms, o3 "
                     f"{rec['o3_ms']:.1f} ms | o1_pairs {rec['o1_pairs']:.0f} "
                     f"({rec['o1_pairs'] / rec['o1_ms'] / 1e3:.2f} M/s) "
                     f"o2_pairs {rec['o2_pairs']:.0f} | NMI {rec['nmi']:.4f} "
                     f"| peak device memory {peak_gb:.2f} GiB | K3 CAS "
                     f"retries {float(retries):.0f} | launches "
                     f"{large_launches}")
    del trainer
    torch.cuda.empty_cache()

    # 15. the probes P2-P4, each through its tools/ entry point
    from come_tpu_torch.tools import probe_smem, probe_star, probe_star_floor

    reset_counts()
    p2 = probe_smem.capacity_search(dev, log=lambda m: phase("P2", m))
    x8 = torch.ones((8, 128), device=dev)
    optin = smem_optin_bytes()
    p2_sum = smem_probe(x8, optin)
    p2_err = abs(float(p2_sum) - float(smem_probe_reference(x8, optin)))
    p2_ms = cuda_ms(lambda: smem_probe(x8, optin))
    p2_plain_ms = cuda_ms(lambda: smem_probe_reference(x8, optin))
    p2_lib_ms = cuda_ms(lambda: torch.sum(x8[0]))
    p3 = probe_star.run(dev, log=lambda m: phase("P3", m))
    p4 = probe_star_floor.run(dev, log=lambda m: phase("P4", m))
    probe_launches = counts()
    check_launches("probes", probe_launches,
                   ("smem_probe", "star_probe", "floor_probe"),
                   tuple(k for k in kernels if k not in (
                       "smem_probe", "star_probe", "floor_probe",
                       "star_sgns_bf16")))
    s3, m3, sneg3 = p3.pop("inputs")
    p3_bound = star_bound(s3, m3, sneg3, p3["pairs"], 128, True, PAD_META)
    G4, V4, d4 = p4["G"], p4["V"], p4["d"]
    # slots read once, the table read once and copied once, the gathered
    # [1024, d] buffer and the value written once
    p4_bound = bound(0.0, 4.0 * (G4 * 1024 + 2 * V4 * d4 + 1024 * d4 + 1),
                     False)
    phase("probes", f"P2 {p2['largest']} B of shared memory per block "
                    f"({p2['refused'][0]} B refused: {p2['refused'][1]}), "
                    f"{p2_ms:.4f} ms a launch | P3 full {p3['ms']:.3f} ms a "
                    f"step ({p3['rows']['full']:.2f} us/group; K2b "
                    f"{p3['k2b_us']:.2f}), max_abs {p3['max_abs_err']:.3e} "
                    f"vs K2b's plain version, bound {p3_bound[0]:.4f} ms | "
                    f"P4 floors (us/group) " + ", ".join(
                        f"{k} {v[0]:.2f}" for k, v in p4["variants"].items())
          + f" | launches {probe_launches}")

    # 16. the parity harness's CLI on the card
    from come_tpu_torch.evaluation import parity

    reset_counts()
    if parity.main(["--dataset", "karate", "--iters", "3", "--device",
                    "cuda"]) != 0:
        raise AssertionError("parity: the CLI returned non-zero")
    parity_launches = counts()
    ran = ("walk_sgns", "walk_sgns_paired", "star_sgns", "fused_sgns_tied")
    check_launches("parity", parity_launches, ran,
                   tuple(k for k in kernels if k not in ran))
    phase("parity", f"karate, 3 iterations on cuda: PASS | launches "
                    f"{parity_launches}")

    # 17. --profile-dir: the karate CLI with shared negatives under the
    # profiler (the CLI has no flag for the negative mode, as the JAX CLI
    # has none; run() takes config fields from the parsed namespace)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        args = build_argparser().parse_args([
            "--dataset", "karate", "--device", "cuda", "--seed", str(SEED),
            "--outer-iters", "1", "--pretrain-epochs", "1",
            "--profile-dir", tmp,
        ])
        args.negative_mode, args.shared_negatives = "shared", 32
        args.pallas_tile_pairs = 64
        reset_counts()
        trainer, hist = run(args)
        torch.cuda.synchronize()
        prof_launches = counts()
        traces = list(Path(tmp).glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"profile: {len(traces)} trace files")
        text = traces[0].read_text()
        if "fused_pos_kernel" not in text:
            raise AssertionError("profile: the trace names no K6 kernel")
        size = traces[0].stat().st_size
    ran = ("fused_sgns", "fused_sgns_tied")
    check_launches("profile", prof_launches, ran,
                   tuple(k for k in kernels if k not in ran))
    check_run("profile", hist, KARATE_SHARED_NMI_FLOOR)
    phase("profile", f"karate shared negatives under --profile-dir: "
                     f"{traces[0].name} {size} bytes, names fused_pos_kernel "
                     f"(K6) | NMI {hist[-1]['nmi']:.4f} | launches "
                     f"{prof_launches}")
    del trainer

    def entry(name, src, replaces, launches, err, ms, plain_ms, bnd,
              library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"come_tpu_torch/csrc/{src}", "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    p1, p1_launches = lv["p1"], lv["p1_launches"]
    pg = p1[(2, 262144)]  # the path's bf16 rows, one macro step's worth
    print(json.dumps({"kernels": [
        entry("walk_sgns", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:91", launches["walk_sgns"],
              k1_err[0], k1_ms, k1_plain_ms, k1_bound),
        entry("star_sgns", "star_sgns.cu",
              "come_tpu/ops/pallas_star_sgns.py:56", launches["star_sgns"],
              k2_err[0], k2_ms, k2_plain_ms, k2_bound),
        entry("fused_sgns", "sgns_fused.cu", "come_tpu/ops/pallas_sgns.py:100",
              micro_launches["fused_sgns"], k6_err[0], k6_ms, k6_plain_ms,
              k6_bound),
        entry("fused_sgns_tied", "sgns_fused.cu",
              "come_tpu/ops/pallas_sgns.py:185",
              micro_launches["fused_sgns_tied"], k7_err[0], k7_ms,
              k7_plain_ms, k7_bound),
        entry("walk_sgns_bf16", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:129",
              bench_launches["walk_sgns_bf16"], k1bb_err[0], k1bb_ms,
              k1bb_plain_ms, k1bb_bound),
        entry("star_sgns_bf16", "star_sgns.cu",
              "come_tpu/ops/pallas_star_sgns.py:78",
              bench_launches["star_sgns_bf16"], k2bb_err[0], k2bb_ms,
              k2bb_plain_ms, k2bb_bound),
        entry("walk_sgns_gen_bf16", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:695",
              gen_launches["walk_sgns_gen_bf16"], k4b_err[0], k4b_ms,
              k4b_plain_ms, k4b_bound),
        entry("walk_sgns_paired", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:290",
              paired_launches["walk_sgns_paired"], k5_err[0], k5_ms,
              k5_plain_ms, k5_bound),
        entry("walk_sgns_bf16_tables", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:377",
              large_launches["walk_sgns_bf16_tables"], lv["k3_err"][0],
              lv["k3_ms"], lv["k3_plain_ms"], lv["k3_bound"]),
        entry("row_gather_probe", "row_probe.cu", "scripts/probe_dma.py:47",
              p1_launches["row_gather_probe"], pg["cs_err"], pg["g_ms"],
              pg["g_plain"], pg["g_bound"], pg["g_lib"]),
        entry("row_scatter_probe", "row_probe.cu", "scripts/probe_dma.py:47",
              p1_launches["row_scatter_probe"], 0.0, pg["s_ms"],
              pg["s_lib"], pg["s_bound"], pg["s_lib"]),
        entry("smem_probe", "smem_probe.cu", "scripts/probe_vmem.py:12",
              probe_launches["smem_probe"], p2_err, p2_ms, p2_plain_ms,
              bound(0.0, 4.0 * 128 + 4.0, False), p2_lib_ms),
        entry("star_probe", "star_probe.cu", "scripts/probe_star.py:33",
              probe_launches["star_probe"], p3["max_abs_err"], p3["ms"],
              p3["plain_ms"], p3_bound),
        entry("floor_probe", "floor_probe.cu",
              "scripts/probe_star_floor.py:207",
              probe_launches["floor_probe"], 0.0, p4["ms"], p4["plain_ms"],
              p4_bound),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
