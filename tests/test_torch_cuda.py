"""The CUDA kernels against their plain PyTorch versions on the card, at
small and ragged shapes (partial pool chunks, d below 128, wrapped walk
batches, R=2, tiles of 64 and ragged tails, pools that repeat rows), plus
short trainer runs through the kernels.

Needs a CUDA card: every test is marked ``cuda`` and skips without one.
Imports nothing of JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance, on each table element's update (after the step minus before):
|upd_kernel - upd_plain| <= 1e-6 + 1e-4 |upd_plain| (f32; atomicAdd order
varies), loss rtol 1e-4, pair counts exact.  The bf16 modes (K1b, K2b, K4
and K5 with mxu_bf16) are held to ``ops/tolerance.py``'s check (relative
L2 error of the updates <= 4e-4, every element within 2^-8 of the largest
update, and the f32 plain step at least 5x farther away than the kernel
and 2x past the bound).  K4's walks must equal the plain version's bit for
bit.  K3 (bf16 tables) is held to ``ops/tolerance.py``'s K3 check (99% of
touched elements bit-identical, relative L2 error of the updates within
``K3_L2``, the f32-table step 5x farther away); P1's gather must give the
plain version's rows bit for bit and its checksum to 1e-12, its
scatter-add the plain version's table bit for bit.  P3's variants take
the bf16 check's error rules against their plain versions (the table bit
for bit where the plain step leaves it alone), and with every section on
the full bf16 check against K2b and the f32 tolerance against K2; P4's
values and P2's sum must equal their plain versions exactly, and the
parity harness must pass on the card; the pool stage, the bf16 stage past d
192 and K3's pool write alone (``chip_smoke.pool_check``, phase 4m's cases
on a unigram and a hub-heavy pool), K3's slot chains and slot scatter
alone (``chip_smoke.slot_check``, on random walks and hub-heavy groups; the
scatter run twice), and the f32 slot writes alone, with and without the
block end's pool (``chip_smoke.f32_scatter_check``, run twice, against the
plain version on a CPU copy; its fold chains ``chip_smoke.fold_check``),
and the star writes alone, with and without the block end's pool, the star
chains and the fold chains of a star step at R 1 and 3
(``chip_smoke.star_scatter_check``, ``star_chains_check``,
``star_fold_check``, on a blogcatalog star group and a layout of split
hubs with pools that draw the hub over and over)
their plain versions bit for bit; a step's
pool passes are counted as its C loop launched them (every walk and star
step's chains, the f32 and star block end's scatter in place of a pool
write).  Six
consecutive K1, K3 and K2
steps through one launch plan's graph each (``chip_smoke.graph_steps``)
must each pass their mode's check, with at most one instantiation; six K6
and six K7 micro-steps through one plan (``chip_smoke.fused_steps``) the
f32 check, with one instantiation and five updates; forty of each
enqueued back to back with new pairs and pools (``chip_smoke.fused_stress``)
the same check, step by step; and the plan's
packed pairs, masks and pool must equal ``FusedPlan.pack``'s bit for bit.
G1
(``ops/gmm_factor.py``) is held to its plain version under
``chip_smoke.G1_RTOL``'s rule (relative Frobenius error of L and of the
inverse within 1e-4, or no farther from the float64 plain version than the
f32 plain version is) with equal info flags, at the presets' shapes and at
widths whose panels of 16 are whole or ragged (``chip_smoke.G1_WIDTHS``, on
``tests/test_torch_g1.py``'s matrices); a non-positive pivot at the first,
middle or last column of a panel, or in a ragged last one, must get
``cholesky_ex``'s info flag; the EM replayed as a graph
must give the eager EM's bits and iterations, and the EM with G1 the
torch.linalg EM's log-likelihood within 1e-4 relative.  Past d = 128 G1
holds its matrices in device memory, and past 192 every walk and star
pass stages its rows in column slabs and the negative passes run their
wide kernels (whole to 256, slabs of 256 past it; every mode also at 255
and 1024): K1, K5 and K2 at
``chip_smoke.WIDE_WIDTHS`` (W 10 and a whole-walk window), and at 193 and
256 on the main path's blogcatalog shapes (``chip_smoke.blog_wide_checks``),
K1b, K3, K4 (bf16 and f32), K2b, K6 and K7 at
``chip_smoke.WIDE_MODE_WIDTHS``, each under its mode's check
(``chip_smoke.step_check``), every walk and star mode enqueued back to
back (``chip_smoke.graph_stress``, at d 128 and 256) its mode's check step
by step, forty K6/K7 micro-steps back to back at d 256, and a trainer at
dim 256 must run through K1, K2 and G1, and through each other tier
(bf16 products, in-kernel walks, bf16 tables, the micro-batched tier)
launching its kernels.
"""

import numpy as np
import pytest
import torch

from come_tpu_torch.config import PRESETS, get_config
from come_tpu_torch.graphs import CSRGraph, get_dataset, sbm_graph
from come_tpu_torch.ops.sgns import (
    fused_sgns_step,
    fused_sgns_step_reference,
    fused_sgns_step_tied,
    fused_sgns_step_tied_reference,
)
from come_tpu_torch.ops.star_sgns import star_sgns_step, star_sgns_step_reference
from come_tpu_torch.ops.row_probe import (
    row_gather_probe,
    row_gather_probe_reference,
    row_scatter_probe,
    row_scatter_probe_reference,
)
from come_tpu_torch.ops.tolerance import check_bf16, check_k3
from come_tpu_torch.ops.walk_sgns import (
    POOL_LAUNCHES,
    NWL,
    pad_walks,
    walk_sgns_gen_step,
    walk_sgns_gen_step_reference,
    walk_sgns_step,
    walk_sgns_step_reference,
)
from come_tpu_torch.sampling import build_star_layout
from come_tpu_torch.sampling.stars import PAD_META
from come_tpu_torch.tools.probe_star import VARIANTS as PROBE_VARIANTS
from come_tpu_torch.trainer import ComETrainer

from chip_smoke import (
    B2B_MODES,
    B2B_WIDE,
    BF16_SLAB,
    F32_SCATTER_WIDTHS,
    FUSED_EDGES,
    STAR_WRITE_KINDS,
    STAR_WRITE_WIDTHS,
    G1_WIDTHS,
    POOL_APPLIES,
    POOL_CHAINS,
    POOL_KINDS,
    POOL_SEEDS,
    POOL_STAGES,
    SCATTER_WIDTHS,
    STAR_EDGES,
    WIDE_CASES,
    WIDE_MODE_WIDTHS,
    WIDE_MODES,
    WIDE_STAGES,
    WIDE_WIDTHS,
    em_graph_check,
    em_linalg_check,
    f32_scatter_check,
    fold_check,
    star_chains_check,
    star_fold_check,
    star_hub_pool,
    star_scatter_check,
    fused_scan_check,
    fused_steps,
    fused_stress,
    g1_check,
    g1_moments,
    g1_pivot_batch,
    graph_steps,
    SEED,
    bf16_slab_check,
    blog_wide_checks,
    graph_stress,
    hub_slots,
    mode_width,
    pool_check,
    pool_draws,
    route_boundary,
    slot_check,
    star_edge_layout,
    step_check,
    wide_inputs,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(init, kern, plain):
    *kt, kl, kn = kern
    *pt, pl, pn = plain
    torch.cuda.synchronize()
    assert float(kn) == float(pn)
    assert abs(float(kl) - float(pl)) <= 1e-4 * abs(float(pl))
    for t0, a, b in zip(init, kt, pt):  # a float64 plain step in float64
        t0, a = t0.to(b.dtype), a.to(b.dtype)
        torch.testing.assert_close(a - t0, b - t0, rtol=1e-4, atol=1e-6)


def _close_bf16(init, kern, plain, f32):
    *kt, kl, kn = kern
    *pt, pl, pn = plain
    torch.cuda.synchronize()
    assert float(kn) == float(pn)
    assert abs(float(kl) - float(pl)) <= 1e-4 * abs(float(pl))
    check_bf16("bf16 mode", init, kt, pt, f32[:len(init)])


@pytest.mark.parametrize("V,d,B,L,W,KP,R", [
    (300, 128, 16, 20, 3, 16, 1),
    (500, 64, 21, 37, 5, 100, 2),
    (400, 96, 24, 128, 10, 64, 1),
    (2000, 128, 40, 80, 10, 512, 3),
    (1000, 128, 16, 20, 19, 100, 3),
])
def test_walk_kernel_matches_plain(dev, V, d, B, L, W, KP, R):
    g = torch.Generator(device=dev).manual_seed(V)
    emb_in = torch.randn((V, d), generator=g, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=g, device=dev) * 0.1
    walks = torch.randint(0, V, (B, L), generator=g, device=dev,
                          dtype=torch.int32)
    G = -(-B // 8)
    wrow = torch.randint(1, W + 1, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    pools = torch.randint(0, V, (-(-G // R), KP), generator=g, device=dev,
                          dtype=torch.int32)

    def run(fn):
        return fn(emb_in.clone(), emb_out.clone(), walks, wrow, pools, 0.05,
                  5.0 / KP, window=W, pool_refresh=R)

    before = walk_sgns_step.launches
    _close((emb_in, emb_out), run(walk_sgns_step),
           run(walk_sgns_step_reference))
    assert walk_sgns_step.launches == before + 1


# Shapes that stress the band pass's strips of 8 centres and the bf16
# negative pass's 64-slot x 32-row tiles: the whole walk in the band (W >=
# L - 1), one slot per walk, an odd L with W wider than a strip, d at its
# bound 192 and at 2, walks that repeat one row heavily, ragged and large
# pools (KP 100 and 2048, R 3); the last four again at 256 and 300, where
# every pass stages column slabs, and three at 254 and 258, beside the
# negative passes' route edge (256), where their copies are 4 bytes.
EDGE_SHAPES = [  # V, d, B, L, W, KP, R, hot
    (3000, 128, 16, 128, 127, 64, 1, False),
    (500, 64, 16, 1, 3, 16, 1, False),
    (2000, 128, 24, 37, 13, 100, 3, False),
    (2000, 192, 16, 80, 10, 128, 1, False),
    (2000, 2, 16, 20, 3, 64, 1, False),
    (2000, 128, 16, 80, 10, 512, 1, True),
    (20000, 128, 24, 80, 10, 2048, 3, False),
    (500, 256, 16, 1, 3, 16, 1, False),
    (2000, 300, 24, 37, 13, 100, 3, False),
    (2000, 300, 16, 80, 10, 512, 1, True),
    (20000, 256, 24, 80, 10, 2048, 3, False),
    (2000, 254, 24, 37, 13, 100, 3, False),
    (2000, 258, 16, 80, 10, 512, 1, True),
    (20000, 258, 24, 80, 10, 2048, 3, False),
]


def _edge_inputs(dev, V, d, B, L, W, KP, R, hot, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    emb_in = torch.randn((V, d), generator=g, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=g, device=dev) * 0.1
    walks = torch.randint(0, V, (B, L), generator=g, device=dev,
                          dtype=torch.int32)
    if hot:  # every other position of every walk is node 7
        walks[:, ::2] = 7
    G = -(-B // 8)
    wrow = torch.randint(1, W + 1, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    pools = torch.randint(0, V, (-(-G // R), KP), generator=g, device=dev,
                          dtype=torch.int32)
    return emb_in, emb_out, walks, wrow, pools


# K3 takes the edge shapes on V >= 20000 rows, where its check was set
# (ops/tolerance.py): K3's former CAS loops wrote a row's repeats within a
# group in any order, and the float64 emulation of that order failed the
# check where rows repeat often (0.9567 of touched elements identical at V
# 3000 with W 127, 0.9887 at V 2000 with d 192, 0.5231 with the hot row),
# so the hot row is held in f32 and bf16 products only.  K3's slot scatter
# now writes a row's repeats in slot order, as the plain version does (held
# bit for bit on hub-heavy groups by the slot-scatter tests below).
EDGE_CASES = [(*shape, mode) for shape in EDGE_SHAPES
              for mode in ("f32", "bf16", "bf16_tables")
              if not (shape[-1] and mode == "bf16_tables")]


@pytest.mark.parametrize("V,d,B,L,W,KP,R,hot,mode", EDGE_CASES)
def test_walk_kernel_edge_shapes(dev, V, d, B, L, W, KP, R, hot, mode):
    """The band pass and the negative pass at their edge shapes, in f32, in
    bf16 products and on bf16 tables (K3, stochastic rounding), each held
    to its mode's check; with L = 1 no slot has a pair, and the tables must
    come back unchanged."""
    if mode == "bf16_tables":
        V = max(V, 20000)
    emb_in, emb_out, walks, wrow, pools = _edge_inputs(
        dev, V, d, B, L, W, KP, R, hot, V + d + L)
    init = (emb_in, emb_out)
    if mode == "bf16_tables":
        init = tuple(t.to(torch.bfloat16) for t in init)

    def run(fn, tables, **kw):
        return fn(*[t.clone() for t in tables], walks, wrow, pools, 0.025,
                  5.0 / KP, window=W, pool_refresh=R, **kw)

    if mode == "f32" or L == 1:
        kern = run(walk_sgns_step, init, mxu_bf16=mode == "bf16",
                   sr_seed=77 if mode == "bf16_tables" else None)
        if hot and mode == "f32":  # float64, as chip_smoke.EDGE_SHAPES says
            plain = run(walk_sgns_step_reference,
                        [t.double() for t in init], acc=torch.float64)
        else:
            plain = run(walk_sgns_step_reference, init,
                        mxu_bf16=mode == "bf16",
                        sr_seed=77 if mode == "bf16_tables" else None)
        if L == 1:
            torch.cuda.synchronize()
            assert float(kern[3]) == float(plain[3]) == 0.0
            assert float(kern[2]) == 0.0
            assert all(torch.equal(a, b) for a, b in zip(kern[:2], init))
            return
        _close(init, kern, plain)
    elif mode == "bf16":
        _close_bf16(init, run(walk_sgns_step, init, mxu_bf16=True),
                    run(walk_sgns_step_reference, init, mxu_bf16=True),
                    run(walk_sgns_step_reference, init))
    else:
        kern = run(walk_sgns_step, init, sr_seed=77)
        plain = run(walk_sgns_step_reference, init, sr_seed=77)
        f32 = run(walk_sgns_step_reference, [t.float() for t in init],
                  mxu_bf16=True)
        torch.cuda.synchronize()
        assert float(kern[3]) == float(plain[3])
        assert abs(float(kern[2]) - float(plain[2])) <= 1e-4 * abs(
            float(plain[2]))
        check_k3("K3", init, kern[:2], plain[:2], f32[:2])


@pytest.mark.parametrize("V,d,E,KP,R,layout", [
    (200, 128, 3000, 16, 1, "random"),
    (600, 64, 9000, 100, 2, "random"),
    (3000, 128, 40000, 512, 1, "random"),
] + STAR_EDGES)
def test_star_kernel_matches_plain(dev, V, d, E, KP, R, layout):
    slots, meta = star_edge_layout(V, E, layout, V)
    slots, meta = (torch.as_tensor(a, device=dev) for a in (slots, meta))
    G = -(-slots.shape[0] // NWL)
    g = torch.Generator(device=dev).manual_seed(V)
    emb = torch.randn((V, d), generator=g, device=dev) * 0.1
    pools = torch.randint(0, V, (-(-G // R), KP), generator=g, device=dev,
                          dtype=torch.int32)

    def run(fn):
        return fn(emb.clone(), slots, meta, pools, 0.05, 5.0 / KP,
                  pool_refresh=R)

    _close((emb,), run(star_sgns_step), run(star_sgns_step_reference))


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("V,d,P,TP,KP,masked_tile", [
    (34, 16, 1000, 64, 100, False),  # karate-sized: pool and pairs repeat
    (500, 64, 3000, 1024, 512, False),
    (10312, 128, 32768, 1024, 512, False),
    (2000, 128, 777, 64, 100, False),
] + [e + (True,) for e in FUSED_EDGES])  # phase 4i's: a tile all masked
def test_fused_kernels_match_plain(dev, V, d, P, TP, KP, masked_tile, tied):
    g = torch.Generator(device=dev).manual_seed(V + P)
    emb_in = torch.randn((V, d), generator=g, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=g, device=dev) * 0.1
    c, x, pool = (torch.randint(0, V, (n,), generator=g, device=dev,
                                dtype=torch.int32) for n in (P, P, KP))
    m = (torch.rand(P, generator=g, device=dev) < 0.6).float()
    if masked_tile:
        m[TP:2 * TP] = 0.0
    lr, negw = 0.05, 5.0 / KP
    if tied:
        def run(fn):
            return fn(emb_in.clone(), c, x, pool, m, lr, negw, tile_pairs=TP)

        before = fused_sgns_step_tied.launches
        _close((emb_in,), run(fused_sgns_step_tied),
               run(fused_sgns_step_tied_reference))
        assert fused_sgns_step_tied.launches == before + 1
    else:
        def run(fn):
            return fn(emb_in.clone(), emb_out.clone(), c, x, pool, m, lr,
                      negw, tile_pairs=TP)

        before = fused_sgns_step.launches
        _close((emb_in, emb_out), run(fused_sgns_step),
               run(fused_sgns_step_reference))
        assert fused_sgns_step.launches == before + 1


def test_fused_kernels_all_masked_leave_tables(dev):
    emb = torch.randn((50, 32), device=dev)
    c = torch.arange(300, device=dev, dtype=torch.int32) % 50
    m = torch.zeros(300, device=dev)
    pool = c[:64]
    e, loss, n = fused_sgns_step_tied(emb.clone(), c, c, pool, m, 0.1, 0.1,
                                      tile_pairs=128)
    torch.cuda.synchronize()
    assert torch.equal(e, emb) and float(loss) == 0.0 and float(n) == 0.0


def test_karate_shared_runs_through_k6_k7(dev):
    ds = get_dataset("karate")
    cfg = get_config("karate").replace(
        negative_mode="shared", shared_negatives=32, pallas_tile_pairs=64,
        outer_iters=1, pretrain_epochs=2, walks_per_node=4,
    )
    counts = (walk_sgns_step.launches, star_sgns_step.launches,
              fused_sgns_step.launches, fused_sgns_step_tied.launches)
    t = ComETrainer(ds.graph, cfg, dev)
    hist = t.train(ds.labels)
    after = (walk_sgns_step.launches, star_sgns_step.launches,
             fused_sgns_step.launches, fused_sgns_step_tied.launches)
    assert after[:2] == counts[:2]
    assert after[2] > counts[2] and after[3] > counts[3]
    # one device: every macro batch one scan
    from come_tpu_torch.ops.sgns import fused_sgns_scan
    assert fused_sgns_scan.replays > 0
    assert np.isfinite(hist[-1]["o1_loss"]) and np.isfinite(hist[-1]["o2_loss"])
    assert hist[-1]["nmi"] > 0.3


def test_trainer_runs_through_both_kernels(dev):
    g, labels = sbm_graph(2000, 8, p_in=0.1, p_out=0.002, seed=0,
                          avg_degree=20)
    cfg = PRESETS["blogcatalog"].replace(
        num_communities=8, walks_per_node=4, pretrain_epochs=1, outer_iters=2,
    )
    t = ComETrainer(g, cfg, dev)
    w0, s0 = walk_sgns_step.launches, star_sgns_step.launches
    hist = t.train(labels)
    assert walk_sgns_step.launches > w0 and star_sgns_step.launches > s0
    assert all(np.isfinite(r["o1_loss"]) and np.isfinite(r["o2_loss"])
               for r in hist)
    assert hist[-1]["nmi"] > 0.8


# ---------------------------------------------- K1b, K2b, K4 and K5


@pytest.mark.parametrize("V,d,B,L,W,KP,R", [
    (34, 16, 16, 20, 5, 100, 2),
    (500, 64, 21, 37, 5, 100, 1),
    (2000, 128, 40, 80, 10, 512, 2),
    (1000, 128, 16, 20, 19, 100, 3),
    (20000, 128, 16, 80, 10, 2048, 3),
])
def test_walk_bf16_kernel_matches_plain(dev, V, d, B, L, W, KP, R):
    g = torch.Generator(device=dev).manual_seed(V + 1)
    emb_in = torch.randn((V, d), generator=g, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=g, device=dev) * 0.1
    walks = torch.randint(0, V, (B, L), generator=g, device=dev,
                          dtype=torch.int32)
    G = -(-B // 8)
    wrow = torch.randint(1, W + 1, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    pools = torch.randint(0, V, (-(-G // R), KP), generator=g, device=dev,
                          dtype=torch.int32)

    def run(fn, bf16):
        return fn(emb_in.clone(), emb_out.clone(), walks, wrow, pools, 0.05,
                  5.0 / KP, window=W, pool_refresh=R, mxu_bf16=bf16)

    before = (walk_sgns_step.launches, walk_sgns_step.launches_bf16)
    _close_bf16((emb_in, emb_out), run(walk_sgns_step, True),
                run(walk_sgns_step_reference, True),
                run(walk_sgns_step_reference, False))
    assert (walk_sgns_step.launches,
            walk_sgns_step.launches_bf16) == (before[0], before[1] + 1)


@pytest.mark.parametrize("V,d,E,KP,R,layout", [
    (34, 16, 78, 100, 1, "random"),
    (600, 64, 9000, 100, 2, "random"),
    (3000, 128, 40000, 512, 1, "random"),
    (3000, 128, 40000, 2048, 3, "random"),
] + STAR_EDGES)
def test_star_bf16_kernel_matches_plain(dev, V, d, E, KP, R, layout):
    slots, meta = star_edge_layout(V, E, layout, V + 2)
    slots, meta = (torch.as_tensor(a, device=dev) for a in (slots, meta))
    G = -(-slots.shape[0] // NWL)
    g = torch.Generator(device=dev).manual_seed(V)
    emb = torch.randn((V, d), generator=g, device=dev) * 0.1
    pools = torch.randint(0, V, (-(-G // R), KP), generator=g, device=dev,
                          dtype=torch.int32)

    def run(fn, bf16):
        return fn(emb.clone(), slots, meta, pools, 0.05, 5.0 / KP,
                  pool_refresh=R, mxu_bf16=bf16)

    before = star_sgns_step.launches_bf16
    _close_bf16((emb,), run(star_sgns_step, True),
                run(star_sgns_step_reference, True),
                run(star_sgns_step_reference, False))
    assert star_sgns_step.launches_bf16 == before + 1


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("V,d,n_rows,KP,R", [
    (34, 16, 24, 100, 2),
    (600, 64, 40, 100, 1),
    (10312, 128, 512, 512, 2),
    (3000, 192, 24, 2048, 3),
])
def test_paired_kernel_matches_plain(dev, V, d, n_rows, KP, R, bf16):
    rng = np.random.default_rng(V + n_rows)
    u = rng.integers(0, V, n_rows * 64)
    v = (u + 1 + rng.integers(0, V - 1, u.shape[0])) % V
    rows = torch.as_tensor(np.stack([u, v], 1).reshape(n_rows, 128),
                           device=dev)
    G = -(-n_rows // 8)
    g = torch.Generator(device=dev).manual_seed(V)
    emb = torch.randn((V, d), generator=g, device=dev) * 0.1
    pools = torch.randint(0, V, (-(-G // R), KP), generator=g, device=dev,
                          dtype=torch.int32)

    def run(fn, b16, negw=5.0 / KP):
        return fn(emb.clone(), emb.clone(), rows, None, pools, 0.05, negw,
                  window=1, pool_refresh=R, mxu_bf16=b16, paired=True)

    before = walk_sgns_step.launches_paired
    kern, plain = run(walk_sgns_step, bf16), run(walk_sgns_step_reference,
                                                 bf16)
    if bf16:
        # the paired positive pass is f32 and only the negative pass
        # rounds: hold the updates past the step without it (negw = 0)
        base = run(walk_sgns_step_reference, False, 0.0)[:2]
        _close_bf16(base, kern, plain, run(walk_sgns_step_reference, False))
    else:
        _close((emb, emb), kern, plain)
    assert float(kern[3]) == rows.numel() + (8 * G - n_rows) * 128
    assert walk_sgns_step.launches_paired == before + 1


def _graph_with_isolated(V, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, V - 1, 4 * V)
    v = rng.integers(0, V - 1, 4 * V)
    return CSRGraph.from_arcs(u, v, num_nodes=V)  # node V-1 isolated


# A bf16 flip early in a step moves later groups' reads, so the bound holds
# where a step is stable: 256 walks over V=2000 at lr 0.05 grow the table
# from 0.1 to 3.6 in one step, and a float64 emulation of the plain version
# then lies 6.4e-4 (L2) from it; at V=5000 5.3e-5.
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("V,d,B,L,W,KP,R", [
    (34, 16, 13, 20, 5, 100, 2),
    (500, 64, 24, 80, 10, 100, 1),
    (5000, 128, 256, 80, 10, 512, 2),
    (20000, 128, 16, 128, 127, 64, 1),
    (20000, 128, 24, 37, 13, 2048, 3),
])
def test_gen_kernel_matches_plain(dev, V, d, B, L, W, KP, R, bf16):
    graph = _graph_with_isolated(V, V)
    csr = graph.to_device(dev)
    g = torch.Generator(device=dev).manual_seed(V + 3)
    emb_in = torch.randn((V, d), generator=g, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=g, device=dev) * 0.1
    starts = torch.randint(0, V, (B,), generator=g, device=dev,
                           dtype=torch.int32)
    starts[0] = V - 1  # an isolated start
    G = -(-B // 8)
    bits = torch.randint(-2**31, 2**31, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    wrow = torch.randint(1, W + 1, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    pools = torch.randint(0, V, (-(-G // R), KP), generator=g, device=dev,
                          dtype=torch.int32)

    def run(fn, b16):
        return fn(emb_in.clone(), emb_out.clone(), starts, bits, csr.indptr,
                  csr.indices, wrow, pools, 0.05, 5.0 / KP, walk_length=L,
                  window=W, pool_refresh=R, mxu_bf16=b16, return_walks=True)

    def counts():
        return (walk_sgns_gen_step.launches, walk_sgns_gen_step.launches_bf16,
                walk_sgns_step.launches, walk_sgns_step.launches_bf16)

    before = counts()
    *kern, kw = run(walk_sgns_gen_step, bf16)
    *plain, pw = run(walk_sgns_gen_step_reference, bf16)
    torch.cuda.synchronize()
    assert torch.equal(kw, pw)
    assert (kw[0] == V - 1).all()
    if bf16:
        _close_bf16((emb_in, emb_out), kern, plain,
                    run(walk_sgns_gen_step_reference, False))
    else:
        _close((emb_in, emb_out), kern, plain)
    # the gen wrapper counts its own launches, in its mode's counter only
    assert counts() == (before[0] + (not bf16), before[1] + bf16) + before[2:]


def _bench_counts():
    return {"K1": walk_sgns_step.launches, "K2": star_sgns_step.launches,
            "K4": walk_sgns_gen_step.launches,
            "K4+K1b": walk_sgns_gen_step.launches_bf16,
            "K1b": walk_sgns_step.launches_bf16,
            "K2b": star_sgns_step.launches_bf16}


@pytest.mark.parametrize("walk_gen,ran", [("kernel", ("K4+K1b", "K2b")),
                                          ("scan", ("K1b", "K2b"))])
def test_bench_config_runs_through_its_kernels(dev, walk_gen, ran):
    """The reference bench's knobs (bench.py:174-216) on the graph they
    were chosen for: R = 8 pools over 2048-walk steps need V >> 8 * 1024.
    Only the configuration's own kernels (by mode) launch."""
    ds = get_dataset("blogcatalog")
    cfg = PRESETS["blogcatalog"].replace(
        num_communities=ds.num_communities, pretrain_epochs=1,
        outer_iters=1, walk_kernel_bf16=True, walk_pool_refresh=8,
        batch_walks=2048, batch_edges=524288, walk_gen=walk_gen,
    )
    t = ComETrainer(ds.graph, cfg, dev)
    before = _bench_counts()
    hist = t.train(ds.single_labels)
    launched = {k: v - before[k] for k, v in _bench_counts().items()}
    assert all((launched[k] > 0) == (k in ran) for k in launched), launched
    assert hist[-1]["nmi"] > 0.8


# ------------------------------------------------------------- K3 and P1


@pytest.mark.parametrize("gen", [False, True])
@pytest.mark.parametrize("sr_seed", [None, 1234])
@pytest.mark.parametrize("V,d,B,L,W,KP,R", [
    (20000, 128, 40, 80, 10, 512, 2),
    (50000, 64, 64, 37, 5, 256, 1),
    (20000, 128, 16, 128, 127, 2048, 3),
    (20000, 2, 16, 20, 3, 64, 1),
])
def test_k3_kernel_matches_plain(dev, V, d, B, L, W, KP, R, sr_seed, gen):
    # the degree of the large-V path's graph: walks revisit few rows, whose
    # repeated writes the kernel takes in another order than the plain one
    graph, _ = sbm_graph(V, 16, p_in=0.1, p_out=0.002, seed=V, avg_degree=40)
    csr = graph.to_device(dev)
    g = torch.Generator(device=dev).manual_seed(V + 4)
    init = [(torch.randn((V, d), generator=g, device=dev) * 0.1).to(
        torch.bfloat16) for _ in range(2)]
    starts = torch.randint(0, V, (B,), generator=g, device=dev,
                           dtype=torch.int32)
    G = -(-B // 8)
    bits = torch.randint(-2**31, 2**31, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    wrow = torch.randint(1, W + 1, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    pools = torch.randint(0, V, (-(-G // R), KP), generator=g, device=dev,
                          dtype=torch.int32)
    walks = walk_sgns_gen_step_reference(
        *[t.float() for t in init], starts, bits, csr.indptr, csr.indices,
        wrow, pools, 0.0, 0.0, walk_length=L, window=W, pool_refresh=R,
        return_walks=True)[-1]

    def run(fn, tables, **kw):
        tables = [t.clone() for t in tables]
        if gen:
            return fn(*tables, starts, bits, csr.indptr, csr.indices, wrow,
                      pools, 0.025, 5.0 / KP, walk_length=L, window=W,
                      pool_refresh=R, **kw)
        return fn(*tables, walks, wrow, pools, 0.025, 5.0 / KP, window=W,
                  pool_refresh=R, **kw)

    kern_fn = walk_sgns_gen_step if gen else walk_sgns_step
    plain_fn = walk_sgns_gen_step_reference if gen else walk_sgns_step_reference
    before = kern_fn.launches_bf16_tables
    kern = run(kern_fn, init, sr_seed=sr_seed)
    plain = run(plain_fn, init, sr_seed=sr_seed)
    f32 = run(plain_fn, [t.float() for t in init], mxu_bf16=True)
    torch.cuda.synchronize()
    assert kern[0].dtype == torch.bfloat16
    assert float(kern[3]) == float(plain[3])
    assert abs(float(kern[2]) - float(plain[2])) <= 1e-4 * abs(float(plain[2]))
    check_k3("K3", init, kern[:2], plain[:2], f32[:2])
    assert kern_fn.launches_bf16_tables == before + 1


def test_k3_kernel_without_updates_leaves_tables(dev):
    """lr = 0: every write adds an exact zero and rounds back to the row,
    in both rounding modes."""
    V, d = 3000, 128
    g = torch.Generator(device=dev).manual_seed(5)
    emb = (torch.randn((V, d), generator=g, device=dev)).to(torch.bfloat16)
    walks = torch.randint(0, V, (16, 80), generator=g, device=dev,
                          dtype=torch.int32)
    wrow = torch.full((2 * NWL,), 5, device=dev, dtype=torch.int32)
    pools = torch.randint(0, V, (2, 64), generator=g, device=dev,
                          dtype=torch.int32)
    for sr in (None, 9):
        a, b, _, n = walk_sgns_step(emb.clone(), emb.clone(), walks, wrow,
                                    pools, 0.0, 0.1, window=5, sr_seed=sr)
        torch.cuda.synchronize()
        assert torch.equal(a, emb) and torch.equal(b, emb) and float(n) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,d,N", [(500_000, 128, 2048), (5000, 64, 777)])
def test_row_probe_matches_plain(dev, V, d, N, dtype):
    g = torch.Generator(device=dev).manual_seed(N)
    table = torch.randn((V, d), generator=g, device=dev).to(dtype)
    idx = torch.randperm(V, generator=g, device=dev)[:N].to(torch.int32)
    before = (row_gather_probe.launches, row_scatter_probe.launches)
    rows, cs = row_gather_probe(table, idx)
    prow, pcs = row_gather_probe_reference(table, idx)
    upd = torch.randn((N, d), generator=g, device=dev).to(dtype)
    kt = row_scatter_probe(table.clone(), idx, upd)
    pt = row_scatter_probe_reference(table.clone(), idx, upd)
    torch.cuda.synchronize()
    assert torch.equal(rows, prow) and torch.equal(kt, pt)
    assert abs(float(cs) - float(pcs)) <= 1e-12 * max(1.0, abs(float(pcs)))
    assert (row_gather_probe.launches, row_scatter_probe.launches) == (
        before[0] + 1, before[1] + 1)


# ------------------------------------- P2, P3, P4 and the parity harness


def test_smem_probe_kernel_and_capacity(dev):
    from come_tpu_torch.ops.build import CudaError
    from come_tpu_torch.ops.smem_probe import smem_optin_bytes, smem_probe
    from come_tpu_torch.tools.probe_smem import capacity_search

    x = torch.ones((8, 128), device=dev)
    optin = smem_optin_bytes()
    before = smem_probe.launches
    assert float(smem_probe(x, optin)) == 128.0
    with pytest.raises(CudaError) as refused:
        smem_probe(x, optin + 1024)
    assert refused.value.name == "cudaErrorInvalidValue"
    assert smem_probe.launches == before + 1  # the refused size never ran
    res = capacity_search(dev, log=lambda s: None)
    assert res["largest"] == optin == 232448  # the H100's opt-in limit


def _probe_stream(dev, V, E, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, V, E)
    v = (u + 1 + rng.integers(0, V - 1, E)) % V
    slots, meta = build_star_layout(u, v, V)
    return tuple(torch.as_tensor(a, device=dev) for a in (slots, meta))


@pytest.mark.parametrize("label,off", PROBE_VARIANTS)
@pytest.mark.parametrize("V,d,E,KP,R,unroll", [
    (3000, 128, 40000, 512, 8, 32),
    (600, 64, 9000, 100, 2, 8),
    (200, 16, 3000, 16, 1, 128),
    (3000, 128, 40000, 2048, 3, 32),
])
def test_star_probe_matches_plain(dev, label, off, V, d, E, KP, R, unroll):
    from come_tpu_torch.ops.star_probe import (
        star_probe_step,
        star_probe_step_reference,
    )
    from come_tpu_torch.tools.probe_star import check_step

    slots, meta = _probe_stream(dev, V, E, V + d)
    G = -(-slots.shape[0] // NWL)
    g = torch.Generator(device=dev).manual_seed(V)
    emb = torch.randn((V, d), generator=g, device=dev) * 0.1
    pools = torch.randint(0, V, (-(-G // R), KP), generator=g, device=dev,
                          dtype=torch.int32)

    def run(fn, **kw):
        return fn(emb.clone(), slots, meta, pools, 0.05, 5.0 / KP,
                  pool_refresh=R, unroll=unroll, **off, **kw)

    before = star_probe_step.launches
    kern = run(star_probe_step)
    torch.cuda.synchronize()
    check_step(label, emb, kern, run(star_probe_step_reference))
    assert star_probe_step.launches == before + 1
    if not off:  # every section on: K2b's step, and K2's without bf16
        k2b = star_sgns_step(emb.clone(), slots, meta, pools, 0.05,
                             5.0 / KP, pool_refresh=R, mxu_bf16=True)
        f32 = run(star_probe_step_reference, mxu_bf16=False)
        _close_bf16((emb,), kern, k2b, f32)
        _close((emb,), run(star_probe_step, mxu_bf16=False),
               star_sgns_step(emb.clone(), slots, meta, pools, 0.05,
                              5.0 / KP, pool_refresh=R))


@pytest.mark.parametrize("mode", ["K1", "K3", "K2"])
def test_graph_steps_follow_every_step(dev, mode):
    """Six consecutive steps through one plan's graph, with lr, the SR seed,
    the walks (star rows), window draws and pools new at every step and
    the tables moved to new addresses at every other step
    (``chip_smoke.graph_steps``, which holds each step against its plain
    version from the same tables under its mode's check): every step
    replayed through one plan, recorded again only when the tables moved:
    one instantiation and three updates."""
    from come_tpu_torch.ops import build, launch_plan

    entry = "star_sgns" if mode == "K2" else "walk_sgns"
    launch_plan.release_plans(build.library(), entry)
    launch_plan.reset_counts()
    errs = graph_steps(mode, dev)
    counts = launch_plan.graph_counts()
    launch_plan.check_counts(f"graph {mode}", counts)
    c = counts[entry]
    assert len(errs) == 6
    assert (c["recordings"], c["replays"], c["instantiations"],
            c["updates"], c["shapes"]) == (4, 6, 1, 3, 1)


@pytest.mark.parametrize("tied", [False, True])
def test_fused_plan_steps_follow_every_step(dev, tied):
    """Six K6 (K7) micro-steps through one fresh plan, with lr, the pairs,
    the mask and the pool new at every step, the tables moved once and a
    tile all masked in each (``chip_smoke.fused_steps``, which holds each
    step against its plain version under phase 6's check): one plan,
    recorded twice: its instantiation and one update (the tables moved)."""
    from come_tpu_torch.ops import build, launch_plan

    entry = "fused_sgns_tied" if tied else "fused_sgns"
    launch_plan.release_plans(build.library(), entry)
    launch_plan.reset_counts()
    errs = fused_steps(tied, dev, 2000, 128, 3000, 777, 512)
    c = launch_plan.graph_counts()[entry]
    assert len(errs) == 6
    assert (c["recordings"], c["replays"], c["instantiations"], c["updates"],
            c["shapes"]) == (2, 6, 1, 1, 1)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("V,d,P,TP,KP", [
    (2000, 128, 3000, 777, 512), (34, 16, 128, 64, 32),
])
def test_fused_plan_steps_back_to_back_follow_every_step(dev, tied, V, d, P,
                                                         TP, KP):
    """Forty K6 (K7) micro-steps enqueued back to back through one plan,
    with the pairs, the mask and the pool new at every call
    (``chip_smoke.fused_stress``): each step equals its plain version from
    the tables the step before it left, under phase 6's check, so no step
    read a packed id or pool row of the call before it."""
    from come_tpu_torch.ops import build, launch_plan

    entry = "fused_sgns_tied" if tied else "fused_sgns"
    launch_plan.release_plans(build.library(), entry)
    launch_plan.reset_counts()
    errs = fused_stress(tied, dev, V, d, P, TP, KP)
    c = launch_plan.graph_counts()[entry]
    assert len(errs) == 40
    assert (c["replays"], c["recordings"], c["instantiations"],
            c["shapes"]) == (40, 1, 1, 1)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("V,d,mb,TP,KP", [
    (2000, 128, 3000, 777, 512), (34, 16, 128, 64, 32),
    (2000, 256, 4096, 1024, 512),
])
def test_fused_scan_matches_the_plain_loop(dev, tied, V, d, mb, TP, KP):
    """A macro batch of forty K6 (K7) micro-steps as one scan (one launch
    of a WHILE graph whose body is one recorded micro-step), pairs, mask
    and pool new at every micro-step (``chip_smoke.fused_scan_check``):
    the final tables under phase 6's check and the summed (loss, n_pairs)
    against the loop of plain micro-steps; two scans through one plan, the
    second recorded again only if its tables lie elsewhere."""
    from come_tpu_torch.ops import build, launch_plan

    entry = "fused_scan_tied" if tied else "fused_scan"
    launch_plan.release_plans(build.library(), entry)
    launch_plan.reset_counts()
    fused_scan_check(tied, dev, V, d, mb, TP, KP)
    fused_scan_check(tied, dev, V, d, mb, TP, KP, n=7)
    c = launch_plan.graph_counts()[entry]
    assert (c["replays"], c["instantiations"], c["shapes"]) == (2, 1, 1)
    assert c["recordings"] == 1 + c["updates"] <= 2


@pytest.mark.parametrize("tied,P,TP,wide", [
    (False, 2500, 777, True), (True, 128, 64, False), (False, 201, 100, False),
])
def test_fused_plan_packs_on_the_card_as_its_plain_version(dev, tied, P, TP,
                                                          wide):
    """The step's first kernel fills the plan's ids, nt and pool from the
    call's int32 or int64 inputs bit for bit as ``FusedPlan.pack`` does
    with torch ops, also after a call with more pairs left a longer
    tail."""
    from come_tpu_torch.ops import launch_plan
    from come_tpu_torch.ops.sgns import fused_plan

    V, d, KP = 500, 32, 48
    n = -(-P // TP)
    g = torch.Generator(device=dev).manual_seed(P)
    dt = torch.int64 if wide else torch.int32
    tabs = [torch.randn((V, d), generator=g, device=dev) * 0.1
            for _ in range(1 if tied else 2)]
    fn = fused_sgns_step_tied if tied else fused_sgns_step
    for k in (n * TP, P):
        c, x, pool = (torch.randint(0, V, (m,), generator=g, device=dev,
                                    dtype=dt) for m in (k, k, KP))
        mask = (torch.rand(k, generator=g, device=dev) < 0.6).float() * 2
        fn(*tabs, c, x, pool, mask, 0.05, 0.1, tile_pairs=TP)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = fused_plan(dev, stream, int(tied), d, TP, KP, n)
    want = launch_plan.FusedPlan(("check",), dev, KP, d, TP, n)
    want.pack(c, x, mask, pool)
    assert torch.equal(plan.ids, want.ids)
    assert torch.equal(plan.nt, want.nt)
    assert torch.equal(plan.pool, want.pool)


@pytest.mark.parametrize("G,V,d", [(338, 10312, 128), (9, 500, 16)])
def test_floor_probe_matches_plain(dev, G, V, d):
    from come_tpu_torch.ops.floor_probe import (
        VARIANTS,
        floor_probe,
        floor_probe_reference,
    )

    rng = np.random.default_rng(G)
    sneg = rng.integers(0, V, 1024).astype(np.int32)
    args = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (
        rng.integers(0, V, G * 1024).astype(np.int32),
        np.broadcast_to(sneg, (-(-G // 8), 1024)).reshape(-1),
        np.ones(2, np.float32),
        rng.integers(0, 128, (G * 8, 128)).astype(np.int32),
        rng.normal(size=(V, d)).astype(np.float32)))
    for name in VARIANTS:
        before = floor_probe.launches
        value, table = floor_probe(name, *args)
        want, want_table = floor_probe_reference(name, *args)
        torch.cuda.synchronize()
        assert float(value) == float(want), name
        assert floor_probe.launches == before + 1
        if want_table is not None:
            assert torch.equal(table, args[-1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_passes_on_the_card(dev, seed):
    import math

    from come_tpu_torch.evaluation.parity import check_gradient_parity

    rep = check_gradient_parity(get_dataset("karate").graph, dim=16,
                                pairs=256, seed=seed, device=dev)
    assert rep.passed, str(rep)
    assert max(rep.o1_max_err, rep.o2_max_err, rep.o3_max_err) < 1e-4
    assert max(rep.o1_fast_max_err, rep.o2_fast_max_err,
               rep.o1_fast_multi_max_err, rep.o2_fanout_max_err,
               rep.o2_star_max_err) < 1e-3
    assert math.isnan(rep.o1_fast_rowsharded_max_err)


def test_parity_cli_on_the_card(dev):
    from come_tpu_torch.evaluation.parity import main

    assert main(["--dataset", "karate", "--iters", "3"]) == 0


def test_dp_world_1_nccl_step_matches_single_device(dev, tmp_path):
    """One data-parallel O1 step at world 1 over NCCL (``before +
    all_reduce(after - before)``) against the single-device trainer's step
    on the same tables and inputs, under the f32 check (the two sum in
    another order: not bit for bit)."""
    import torch.distributed as dist

    from come_tpu_torch.parallel import ShardedComETrainer, make_mesh

    g, _ = sbm_graph(2000, 4, seed=0, avg_degree=20)
    cfg = PRESETS["blogcatalog"].replace(num_communities=4)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        dp = ShardedComETrainer(g, cfg, make_mesh(), dev)
        one = ComETrainer(g, cfg, dev)
        torch.testing.assert_close(dp.params.node_emb, one.params.node_emb,
                                   rtol=0, atol=0)
        gen = torch.Generator(device=dev).manual_seed(1)
        walks = torch.randint(0, 2000, (64, cfg.walk_length), generator=gen,
                              device=dev, dtype=torch.int32)
        wrow = torch.randint(1, cfg.window + 1, (8 * NWL,), generator=gen,
                             device=dev, dtype=torch.int32)
        pools = torch.randint(0, 2000, (8, cfg.shared_negatives),
                              generator=gen, device=dev, dtype=torch.int32)
        init = (one.params.node_emb.clone(), one.params.ctx_emb.clone())
        launched = walk_sgns_step.launches
        kern = (*(t for t in (dp.params.node_emb, dp.params.ctx_emb)),
                *dp.o1_step(walks, wrow, pools))
        plain = (*(t for t in (one.params.node_emb, one.params.ctx_emb)),
                 *one.o1_step(walks, wrow, pools))
        assert walk_sgns_step.launches == launched + 2
        _close(init, kern, plain)
        assert dp.words_seen == one.words_seen == 64 * cfg.walk_length
    finally:
        dist.destroy_process_group()


def _spd_moments(dev, n, K, d, pts, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, K, pts, d), generator=g, device=dev) * 0.1
    x = x + torch.randn((n, K, 1, d), generator=g, device=dev)
    return x.transpose(-1, -2) @ x, torch.full((n, K), float(pts), device=dev)


@pytest.mark.parametrize("n,K,d,pts", [(2, 39, 128, 260), (2, 39, 128, 64),
                                       (4, 2, 16, 30), (1, 3, 1, 5),
                                       (1, 5, 100, 333), (1, 64, 128, 260),
                                       (1, 195, 128, 260)])
def test_g1_matches_plain(dev, n, K, d, pts):
    cov, nk = _spd_moments(dev, n, K, d, pts, seed=d + pts)
    g1_check(f"{n}x{K}x{d}", cov, nk, 1e-5)


@pytest.mark.parametrize("d", G1_WIDTHS)
def test_g1_ragged_widths_match_plain(dev, d):
    cov, nk = (torch.from_numpy(v).to(dev) for v in g1_moments(2, 3, d, d))
    g1_check(f"d {d}", cov, nk, 1e-5)


@pytest.mark.parametrize("d", G1_WIDTHS)
def test_g1_pivot_positions_match_cholesky_ex(dev, d):
    from come_tpu_torch.ops.gmm_factor import gmm_factor, gmm_factor_reference

    cov, nk, want = g1_pivot_batch(d, 100 + d)
    cov, nk = torch.from_numpy(cov).to(dev), torch.from_numpy(nk).to(dev)
    _, info = gmm_factor(cov, nk, 1e-5)
    _, ref = gmm_factor_reference(cov, nk, 1e-5)
    assert info.tolist() == ref.tolist() == want.tolist()


def test_g1_flags_a_non_positive_pivot(dev):
    from come_tpu_torch.ops.gmm_factor import gmm_factor, gmm_factor_reference

    cov, nk = _spd_moments(dev, 1, 4, 32, 100, seed=1)
    cov[0, 2, 5, 5] = -1.0  # the leading minor of order 6 of matrix 2
    _, info = gmm_factor(cov, nk, 1e-5)
    _, ref = gmm_factor_reference(cov, nk, 1e-5)
    assert info.tolist() == ref.tolist() == [[0, 0, 6, 0]]
    with pytest.raises(ValueError):  # not square
        gmm_factor(torch.zeros((1, 129, 128), device=dev),
                   torch.ones((1,), device=dev), 1e-5)
    # past 128 the kernel keeps its matrices in device memory: reg I
    # factors to sqrt(reg) I
    L, info = gmm_factor(torch.zeros((1, 129, 129), device=dev),
                         torch.ones((1,), device=dev), 1e-4)
    assert info.tolist() == [0]
    torch.testing.assert_close(L, 1e-2 * torch.eye(129, device=dev)[None])


@pytest.mark.parametrize("N,d,K,n_init,tol", [(600, 16, 4, 2, 1e-3),
                                              (2000, 128, 8, 2, 1e-3),
                                              (500, 8, 3, 3, 0.0)])
def test_graph_em_equals_eager_em(dev, N, d, K, n_init, tol):
    from come_tpu_torch.losses.gmm import _kmeans_init

    g = torch.Generator(device=dev).manual_seed(N)
    centers = torch.randn((K, d), generator=g, device=dev) * 2.0
    lab = torch.randint(0, K, (N,), generator=g, device=dev)
    X = centers[lab] + torch.randn((N, d), generator=g, device=dev)
    hg = torch.Generator().manual_seed(0)
    resp0 = torch.stack([_kmeans_init(X, K, hg) for _ in range(n_init)])
    em_graph_check(X, resp0, 1e-5, 25, tol)
    em_linalg_check(X, resp0, 1e-5, 25, tol)


# ------------------------------------------------ widths past 128 and 192


@pytest.mark.parametrize("d", WIDE_WIDTHS)
@pytest.mark.parametrize("mode,whole", WIDE_CASES)
def test_wide_steps_match_plain(dev, mode, whole, d):
    """K1 (W 10 and a whole-walk window), K5 and K2 at widths past 128:
    past 192 their band and star passes stage column slabs of 128, ragged
    at 193 and 300, and their negative pass is the wide kernel, whole up to
    256 and in slabs of 256 from 257 (``chip_smoke.step_check``, the f32
    check)."""
    step_check(mode, f"{mode} d {d}" + (" whole walk" if whole else ""),
               *wide_inputs(mode, dev, d, 3 * d + 2 * whole, whole),
               timed=False)


@pytest.mark.parametrize("d", WIDE_MODE_WIDTHS)
@pytest.mark.parametrize("mode", WIDE_MODES)
def test_wide_modes_match_plain(dev, mode, d):
    """K1b, K3 (SR), K4 (bf16 products and f32), K2b, K6 and K7 past 192,
    where their band and star passes stage column slabs of 128 (ragged at
    193/194 and 300) and their negative passes are the wide kernels (whole
    to 256, slabs of 256 from 257/258), each under its mode's check
    (``chip_smoke.step_check``); K4's walks bit for bit."""
    d = mode_width(mode, d)
    csr = get_dataset("blogcatalog").graph.to_device(dev)
    step_check(mode, f"{mode} d {d}",
               *wide_inputs(mode, dev, d, 3 * d + len(mode), csr=csr),
               timed=False)


@pytest.mark.parametrize("d", [255, 1024])
@pytest.mark.parametrize("mode", [m for m, whole in WIDE_CASES if not whole]
                         + list(WIDE_MODES))
def test_wide_negative_passes_at_their_edges_match_plain(dev, mode, d):
    """Every mode at the widths where the negative passes' wide kernels
    change route, beside WIDE_WIDTHS' 256 and 257: 255 (held whole, a
    ragged width that takes 4-byte copies) and 1024 (four slabs of 256, in
    two sweeps), each under its mode's check (``chip_smoke.step_check``;
    K3 at the even width)."""
    d = mode_width(mode, d)
    csr = get_dataset("blogcatalog").graph.to_device(dev)
    step_check(mode, f"{mode} d {d}",
               *wide_inputs(mode, dev, d, 5 * d + len(mode), csr=csr),
               timed=False)


@pytest.mark.parametrize("d", [193, 256])
def test_wide_steps_at_the_main_paths_shapes_match_plain(dev, d):
    """K1 (W 10 and the whole walk, W 79), K2 and K5 at d past 192 on the
    blogcatalog shapes the CLI's steps take (256 walks of 80 in 32 groups,
    512 star rows in 64 groups, 512 edge rows in 64 groups, KP 512): phase
    4k's checks (``chip_smoke.blog_wide_checks``)."""
    ds = get_dataset("blogcatalog")
    V, L, KP = ds.graph.num_nodes, 80, 512
    g = torch.Generator(device=dev).manual_seed(SEED)
    walks = torch.randint(0, V, (256, L), generator=g, device=dev,
                          dtype=torch.int32)

    def draws(W, n):
        return torch.randint(1, W + 1, (n * NWL,), generator=g, device=dev,
                             dtype=torch.int32)

    def pools(n):
        return torch.randint(0, V, (n, KP), generator=g, device=dev,
                             dtype=torch.int32)

    u, v = ds.graph.edges_undirected()
    slots, meta = build_star_layout(u, v, V)
    sl, mt = (torch.as_tensor(a.reshape(-1, 128)[:512], device=dev)
              .reshape(-1) for a in (slots, meta))
    rows = torch.stack([torch.as_tensor(u[:512 * 64]),
                        torch.as_tensor(v[:512 * 64])], 1).reshape(512, 128)
    res = blog_wide_checks(dev, {
        "K1": ("K1", (walks, draws(10, 32), pools(32)),
               dict(window=10, pool_refresh=1)),
        "K1 whole walk": ("K1", (walks, draws(L - 1, 32), pools(32)),
                          dict(window=L - 1, pool_refresh=1)),
        "K2": ("K2", (sl, mt, pools(64)), dict(pool_refresh=1)),
        "K5": ("K5", (rows.to(dev), None, pools(64)),
               dict(window=1, pool_refresh=1, paired=True)),
    }, V, d)
    assert all(r["pairs"] > 0 for r in res.values())


def _boundary_window(which):
    fit = route_boundary(256)
    return {"fit": fit, "next": fit + 1, "whole walk": 127}[which]


@pytest.mark.parametrize("which,route", [("fit", "whole"), ("next", "slab"),
                                         ("whole walk", "slab")])
def test_band_route_boundary_at_256_matches_plain(dev, which, route):
    """K1 at d 256 on walks of 128: the last window whose f32 rows fit in
    shared memory holds them whole (walk_pos_wide_kernel), the next window
    and the whole walk (W 127) take column slabs (walk_pos_slab_kernel);
    each step must take that route and match its plain version under the
    f32 check (``chip_smoke.step_check``)."""
    W = _boundary_window(which)
    r = step_check("K1", f"K1 d 256 W {W} of 128", *wide_inputs(
        "K1", dev, 256, 7 * W, whole=True, window=W), timed=False,
                   route=route)
    assert r["route"] == route


@pytest.mark.parametrize("mode", ["K1b", "K3"])
def test_bf16_band_holds_the_whole_walk_at_256_and_258(dev, mode):
    """The bf16 modes' rows (half the bytes) fit whole with the whole walk
    of 128 in the window: K1b at d 256, K3 at 258 (rows of 516 bytes, which
    take 4-byte copies), each under its mode's check."""
    d = 258 if mode == "K3" else 256
    csr = get_dataset("blogcatalog").graph.to_device(dev)
    tabs, x, kw = wide_inputs("K3" if mode == "K3" else "K1", dev, d, 11 * d,
                              whole=True, csr=csr)
    if mode == "K1b":  # random walks of the blogcatalog graph, as K1b's
        from come_tpu_torch.sampling import random_walks

        g = torch.Generator(device=dev).manual_seed(d)
        V = int(csr.indptr.numel()) - 1
        tabs = [torch.randn((V, d), generator=g, device=dev) * 0.1
                for _ in range(2)]
        walks = random_walks(csr, torch.randint(0, V, (64,), generator=g,
                                                device=dev), 128, g)
        wrow = torch.randint(1, 128, (8 * 1024,), generator=g, device=dev,
                             dtype=torch.int32)
        x = (walks, wrow, torch.randint(0, V, (8, 512), generator=g,
                                        device=dev, dtype=torch.int32))
        kw = dict(kw, mxu_bf16=True)
    assert step_check(mode, f"{mode} d {d} whole walk", tabs, x, kw,
                      timed=False, route="whole")["pairs"] > 0


@pytest.mark.parametrize("mode,d", BF16_SLAB)
def test_bf16_rows_in_column_slabs_match_plain(dev, mode, d):
    """The bf16 rows that do not fit whole (K1b, K4 and K3 with the whole
    walk of 128 at d 512 and 514, K2b at 884) take the slab kernels
    (walk_pos_slab_kernel<true, ...>, star_pos_slab_kernel<true>), each
    under its mode's check (``chip_smoke.bf16_slab_check``)."""
    csr = get_dataset("blogcatalog").graph.to_device(dev)
    assert bf16_slab_check(mode, d, dev, csr)["route"] == "slab"


@pytest.mark.parametrize("d", [256, 300])
@pytest.mark.parametrize("mode", ["K2", "K2b"])
def test_star_owned_range_of_a_whole_row_matches_plain(dev, mode, d):
    """K2 and K2b past 192 on a fat hub whose segment fills a row (strip 0
    owns all 128 rows, the star pass's widest CTA): the wide star pass,
    under each mode's check."""
    slots, meta = star_edge_layout(400, 150, "fat", d)
    g = torch.Generator(device=dev).manual_seed(d)
    tab = torch.randn((400, d), generator=g, device=dev) * 0.1
    sl, mt = (torch.as_tensor(a, device=dev) for a in (slots, meta))
    pools = torch.randint(0, 400, (-(-sl.numel() // 1024), 64), generator=g,
                          device=dev, dtype=torch.int32)
    step_check(mode, f"{mode} d {d} fat hub", [tab], (sl, mt, pools),
               dict(pool_refresh=1, mxu_bf16=mode == "K2b"), timed=False,
               route="whole")


# (config fields, the tiers' kernels by tier_kernels, their launch counters)
TIERS_256 = [
    ({"walk_kernel_bf16": True}, ("K1b", "K2b"),
     ((walk_sgns_step, "launches_bf16"), (star_sgns_step, "launches_bf16"))),
    ({"walk_kernel_bf16": True, "walk_gen": "kernel"}, ("K4", "K2b"),
     ((walk_sgns_gen_step, "launches_bf16"),
      (star_sgns_step, "launches_bf16"))),
    ({"bf16_tables": True}, ("K3", "K2"),
     ((walk_sgns_step, "launches_bf16_tables"), (star_sgns_step, "launches"))),
    ({"down_sample": 1e-3, "o2_mode": "xla"}, ("K6", "K7"),
     ((fused_sgns_step, "launches"), (fused_sgns_step_tied, "launches"))),
]


@pytest.mark.parametrize("fields,named,counters", TIERS_256)
def test_trainer_at_dim_256_runs_every_tier(dev, fields, named, counters,
                                            monkeypatch):
    """Each tier whose kernel stopped at 192 before its slab passes (bf16
    products, in-kernel walks, bf16 tables with the 48 MiB line at 0, the
    micro-batched tier) trains at dim 256 on the card through its
    kernels: finite losses and embeddings [V, 256], every named kernel
    launched."""
    from come_tpu_torch.trainer import come

    fields = dict(fields)
    if fields.pop("bf16_tables", False):  # any f32 table passes the line
        monkeypatch.setattr(come, "WALK_F32_TABLE_BYTES", 0)
    g, labels = sbm_graph(2000, 8, p_in=0.1, p_out=0.002, seed=0,
                          avg_degree=20)
    cfg = PRESETS["blogcatalog"].replace(
        num_communities=8, dim=256, walks_per_node=4, pretrain_epochs=1,
        outer_iters=1, **fields)
    t = ComETrainer(g, cfg, dev)
    assert t.tier_kernels() == named
    before = [getattr(fn, attr) for fn, attr in counters]
    hist = t.train(labels)
    assert all(getattr(fn, attr) > b
               for (fn, attr), b in zip(counters, before))
    assert all(np.isfinite(hist[-1][k]) for k in ("o1_loss", "o2_loss"))
    emb = t.embeddings()
    assert emb.shape == (2000, 256) and np.isfinite(emb).all()


@pytest.mark.parametrize("mode,d", [(m, 128) for m in B2B_MODES]
                         + [(m, 256) for m in B2B_WIDE])
def test_graph_steps_back_to_back_follow_every_step(dev, mode, d):
    """Eight steps of each walk and star mode enqueued back to back through
    one plan, inputs new at every step (``chip_smoke.graph_stress``): each
    equals its plain version from the tables the step before it left, under
    its mode's check."""
    from come_tpu_torch.ops import launch_plan

    launch_plan.reset_counts()
    errs = graph_stress(mode, dev, d)
    entry = {"K2": "star_sgns", "K2b": "star_sgns",
             "K4": "walk_sgns_gen"}.get(mode, "walk_sgns")
    c = launch_plan.graph_counts()[entry]
    assert len(errs) == 8
    assert (c["replays"], c["instantiations"], c["shapes"]) == (8, 1, 1)


@pytest.mark.parametrize("tied", [False, True])
def test_fused_plan_steps_back_to_back_at_dim_256(dev, tied):
    """Forty K6 (K7) micro-steps at phase 6's shape with tables 256 wide
    (the slab negative pass), enqueued back to back through one plan
    (``chip_smoke.fused_stress``), each under the f32 check."""
    errs = fused_stress(tied, dev, 10312, 256, 32768, 1024, 512)
    assert len(errs) == 40


def test_trainer_at_dim_256_runs_through_k1_k2_and_g1(dev):
    from come_tpu_torch.ops.gmm_factor import gmm_factor

    g, labels = sbm_graph(2000, 8, p_in=0.1, p_out=0.002, seed=0,
                          avg_degree=20)
    cfg = PRESETS["blogcatalog"].replace(
        num_communities=8, dim=256, walks_per_node=4, pretrain_epochs=1,
        outer_iters=1,
    )
    t = ComETrainer(g, cfg, dev)
    w0, s0 = walk_sgns_step.launches, star_sgns_step.launches
    f0 = gmm_factor.launches
    hist = t.train(labels)
    assert walk_sgns_step.launches > w0 and star_sgns_step.launches > s0
    assert gmm_factor.launches > f0
    assert t.embeddings().shape == (2000, 256)
    assert all(np.isfinite(r["o1_loss"]) and np.isfinite(r["o2_loss"])
               for r in hist)
    assert hist[-1]["nmi"] > 0.8


def _pool(dev, kind, KP, seed):
    """Phase 4m's pools, the unigram ones over blogcatalog's degrees (V
    10312; the phase draws them over synthetic-10m's)."""
    from come_tpu_torch.sampling import build_alias_table, unigram_weights

    g = get_dataset("blogcatalog").graph
    alias = tuple(torch.as_tensor(a, device=dev) for a in
                  build_alias_table(unigram_weights(g.degrees)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return pool_draws(kind, KP, g.num_nodes, alias, gen, dev), \
        g.num_nodes, gen


@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("dtype,KP,d", POOL_STAGES)
def test_pool_stage_equals_its_plain_version_bit_for_bit(dev, kind, dtype,
                                                        KP, d):
    pool, V, gen = _pool(dev, kind, KP, d)
    r = pool_check(dev, "stage", dtype, KP, d, pool, V, gen, timed=False)
    assert r["identical"] == 1.0


@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("sr_seed", POOL_SEEDS)
@pytest.mark.parametrize("KP,d", POOL_APPLIES)
def test_pool_write_equals_rmw_rows_bit_for_bit(dev, kind, sr_seed, KP, d):
    pool, V, gen = _pool(dev, kind, KP, d + 1)
    r = pool_check(dev, "apply", torch.bfloat16, KP, d, pool, V, gen,
                   sr_seed, timed=False)
    assert r["identical"] == 1.0
    if kind == "hub":
        assert r["chain"] >= 64 and r["rows"] <= 16


@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("dtype,KP,d", WIDE_STAGES)
def test_wide_bf16_stage_equals_its_plain_version_bit_for_bit(dev, kind,
                                                              dtype, KP, d):
    pool, V, gen = _pool(dev, kind, KP, d + 2)
    r = pool_check(dev, "wide", dtype, KP, d, pool, V, gen, timed=False)
    assert r["identical"] == 1.0


def _slots(dev, kind, seed, G=4, L=80):
    """Phase 4m's slots at blogcatalog's size: G groups of random walks of
    L (a walk revisits nodes), or hub-heavy groups."""
    from come_tpu_torch.sampling import random_walks

    g = get_dataset("blogcatalog").graph
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "hub":
        return hub_slots(G, g.num_nodes, gen, dev), g.num_nodes, gen
    csr = g.to_device(dev)
    walks = random_walks(csr, torch.randint(0, g.num_nodes, (8 * G,),
                                            generator=gen, device=dev), L, gen)
    return pad_walks(walks), g.num_nodes, gen


@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("L", [80, 1, 128, 37])
def test_slot_chains_equal_their_plain_version(dev, kind, L):
    slots, V, gen = _slots(dev, kind, L, L=L)
    r = slot_check(dev, "chains", 0, slots, L, V, gen, timed=False)
    assert r["identical"] == 1.0


@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("sr_seed", POOL_SEEDS)
@pytest.mark.parametrize("d", SCATTER_WIDTHS)
def test_slot_scatter_twice_equals_its_plain_version_bit_for_bit(dev, kind,
                                                                 sr_seed, d):
    # slot_check runs the kernel twice, on fresh copies of the tables, and
    # holds both runs and the plain version to the same bits
    slots, V, gen = _slots(dev, kind, d, G=1)
    r = slot_check(dev, "scatter", d, slots, 80, V, gen, sr_seed,
                   timed=False)
    assert r["identical"] == 1.0
    if kind == "hub":
        assert r["chain"] >= 20 and r["rows"] <= 16


@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("d", F32_SCATTER_WIDTHS)
def test_f32_scatter_twice_equals_its_plain_version_bit_for_bit(dev, kind,
                                                                fold, d):
    # f32_scatter_check runs the kernel twice, on fresh copies of the
    # tables, and holds both runs to the plain version's bits on a CPU
    # copy; the block end's pool (KP 100) draws eight of the group's rows
    # and eight others over and over
    slots, V, gen = _slots(dev, kind, d + fold, G=1)
    pool = None
    if fold:
        rows = torch.cat([torch.unique(slots[(torch.arange(
            NWL, device=dev) % 128) < 80])[:8], torch.randint(
                0, V, (8,), generator=gen, device=dev)])
        pool = rows[torch.randint(0, 16, (100,), generator=gen,
                                  device=dev)].to(torch.int32)
    r = f32_scatter_check(dev, d, slots, 80, V, gen, pool, timed=False)
    assert r["identical"] == 1.0
    if kind == "hub":
        assert r["chain"] >= 20
    if fold:  # the fold chains the block end looks its owners up in
        assert fold_check(dev, slots, 80, pool, timed=False)[
            "identical"] == 1.0


@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("n,KP", POOL_CHAINS)
def test_pool_chains_equal_their_plain_version(dev, kind, n, KP):
    pool, V, gen = _pool(dev, kind, KP, n)
    pools = torch.stack([pool] + [_pool(dev, kind, KP, n + i)[0]
                                  for i in range(1, n)])
    r = pool_check(dev, "chains", None, KP, 0, pools, V, gen, timed=False)
    assert r["identical"] == 1.0


def _star_layout(dev, kind, seed):
    """Phase 4m's star layouts: a blogcatalog star step's first 64 rows of
    128 in a seeded order ("blog", V 10312), or chip_smoke's hub layout
    (node 0 of degree 300 split over several rows of a group, V 3000),
    padded to whole groups; (slots, meta, V)."""
    if kind == "blog":
        g = get_dataset("blogcatalog").graph
        u, v = g.edges_undirected()
        slots, meta = build_star_layout(u, v, g.num_nodes)
        rows = np.random.default_rng(seed).permutation(
            slots.size // 128)[:64]
        slots = slots.reshape(-1, 128)[rows].reshape(-1)
        meta = meta.reshape(-1, 128)[rows].reshape(-1)
        V = g.num_nodes
    else:
        V = 3000
        slots, meta = star_edge_layout(V, 20000, "hub", V + seed)
        G = -(-slots.size // NWL)
        slots = np.pad(slots, (0, G * NWL - slots.size))
        meta = np.pad(meta, (0, G * NWL - meta.size),
                      constant_values=PAD_META)
    return (torch.as_tensor(slots, device=dev),
            torch.as_tensor(meta, device=dev), V)


@pytest.mark.parametrize("kind", ["blog", "hub"])
def test_star_chains_equal_their_plain_version(dev, kind):
    slots, meta, _ = _star_layout(dev, kind, 1)
    r = star_chains_check(dev, slots, meta, timed=False)
    assert r["identical"] == 1.0
    if kind == "hub":
        assert r["chain"] >= 8


@pytest.mark.parametrize("kind,KP", STAR_WRITE_KINDS)
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("d", STAR_WRITE_WIDTHS)
def test_star_scatter_twice_equals_its_plain_version_bit_for_bit(dev, kind,
                                                                 KP, fold, d):
    # star_scatter_check runs the kernel twice, on fresh copies of the
    # table, and holds both against the plain version on a CPU copy; the
    # block end's pool (KP 512 uniform, or KP 100 and 2048 drawing the hub
    # and the group's rows over and over)
    slots, meta, V = _star_layout(dev, kind, KP)
    gen = torch.Generator(device=dev).manual_seed(KP + d)
    sl, mt = slots[:NWL], meta[:NWL]
    pool = None
    if fold:
        pool = star_hub_pool(KP, sl, mt, V, gen, dev) if kind == "hub" \
            else torch.randint(0, V, (KP,), generator=gen, device=dev,
                               dtype=torch.int32)
    r = star_scatter_check(dev, d, sl, mt, V, gen, pool, timed=False)
    assert r["identical"] == 1.0


@pytest.mark.parametrize("kind,KP", STAR_WRITE_KINDS)
@pytest.mark.parametrize("R", [1, 3])
def test_star_fold_chains_of_a_step_equal_their_plain_version(dev, kind, KP,
                                                              R):
    slots, meta, V = _star_layout(dev, kind, 2)
    gen = torch.Generator(device=dev).manual_seed(KP + R)
    G = slots.numel() // NWL
    pools = torch.stack([star_hub_pool(KP, slots[:NWL], meta[:NWL], V, gen,
                                       dev) for _ in range(-(-G // R))])
    r = star_fold_check(dev, slots, meta, pools, R, timed=False)
    assert r["identical"] == 1.0 and r["chain"] > 0


# The pool passes a step launches, counted by the C group loop as it records
# the step (ops/walk_sgns.py::count_pool_passes): each R-block of R 2 groups
# (B 24 walks: 3 groups, 2 blocks) has a stage ("stage_pool": f32 rows, or
# "stage_pool_bf16": bf16 ones past d 192 in the bf16 passes) and a pool
# write: K3's own pass, the f32 walk steps' in the block end's scatter
# ("block_end_scatter", the other groups' "walk_scatter"), the star
# steps' in theirs ("star_block_end_scatter", the other groups'
# "star_scatter"; no apply_pool_kernel); every walk and star step also
# sorts its pools and its groups' slots once a step (and, on f32 tables,
# the fold chains), and K3 runs its slot scatter once a group.
F32_WALK = ("stage_pool", "pool_chains", "slot_chains", "walk_scatter",
            "block_end_scatter", "fold_chains")
STAR_WRITES = ("stage_pool", "pool_chains", "star_chains", "star_scatter",
               "star_block_end_scatter", "fold_chains")


@pytest.mark.parametrize("mode,d,passes", [
    ("f32", 128, F32_WALK),
    ("f32", 256, F32_WALK),
    ("bf16", 128, F32_WALK),
    ("bf16", 256, ("stage_pool_bf16",) + F32_WALK[1:]),
    ("bf16_tables", 128, ("stage_pool_bf16_tables", "pool_chains",
                          "apply_pool_bf16", "slot_chains",
                          "walk_scatter_bf16")),
    ("bf16_tables", 256, ("stage_pool_bf16", "pool_chains",
                          "apply_pool_bf16", "slot_chains",
                          "walk_scatter_bf16")),
    ("star", 128, STAR_WRITES),
    ("star_bf16", 256, ("stage_pool_bf16",) + STAR_WRITES[1:]),
])
def test_steps_count_the_pool_passes_their_graph_launches(dev, mode, d,
                                                          passes):
    V, KP, R = 20000, 512, 2
    emb_in, emb_out, walks, wrow, pools = _edge_inputs(
        dev, V, d, 24, 40, 5, KP, R, False, d)
    pool = pools[0]  # one pool serves every block
    G = 3
    if mode.startswith("star"):
        slots, meta = (torch.as_tensor(a, device=dev) for a in
                       star_edge_layout(V, 6000, "random", V))
        G = -(-slots.shape[0] // NWL)

        def step():
            star_sgns_step(emb_in, slots, meta, pool, 0.01, 5.0 / KP,
                           pool_refresh=R, mxu_bf16=mode == "star_bf16")
    else:
        if mode == "bf16_tables":
            emb_in, emb_out = emb_in.bfloat16(), emb_out.bfloat16()

        def step():
            walk_sgns_step(emb_in, emb_out, walks, wrow, pool, 0.01,
                           5.0 / KP, window=5, pool_refresh=R,
                           mxu_bf16=mode == "bf16",
                           sr_seed=7 if mode == "bf16_tables" else None)
    blocks = -(-G // R)
    per_step = {"pool_chains": 1, "slot_chains": 1, "walk_scatter_bf16": G,
                "walk_scatter": G - -(-G // R), "fold_chains": 1,
                "star_chains": 1, "star_scatter": G - -(-G // R)}
    want = {k: per_step.get(k, blocks) if k in passes else 0
            for k in POOL_LAUNCHES}
    for k in POOL_LAUNCHES:
        POOL_LAUNCHES[k] = 0
    for _ in range(3):  # a recording (or a replay of an earlier one), then
        step()  # replays
    torch.cuda.synchronize()
    assert POOL_LAUNCHES == {k: 3 * n for k, n in want.items()}
    assert blocks >= 2
