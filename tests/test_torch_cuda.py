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
parity harness must pass on the card.
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
    NWL,
    cas_retries,
    walk_sgns_gen_step,
    walk_sgns_gen_step_reference,
    walk_sgns_step,
    walk_sgns_step_reference,
)
from come_tpu_torch.sampling import build_star_layout
from come_tpu_torch.tools.probe_star import VARIANTS as PROBE_VARIANTS
from come_tpu_torch.trainer import ComETrainer

from chip_smoke import FUSED_EDGES, STAR_EDGES, star_edge_layout

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
# pools (KP 100 and 2048, R 3).
EDGE_SHAPES = [  # V, d, B, L, W, KP, R, hot
    (3000, 128, 16, 128, 127, 64, 1, False),
    (500, 64, 16, 1, 3, 16, 1, False),
    (2000, 128, 24, 37, 13, 100, 3, False),
    (2000, 192, 16, 80, 10, 128, 1, False),
    (2000, 2, 16, 20, 3, 64, 1, False),
    (2000, 128, 16, 80, 10, 512, 1, True),
    (20000, 128, 24, 80, 10, 2048, 3, False),
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


# K3 takes the edge shapes on V >= 20000 rows: its check holds a step whose
# walks repeat few rows (ops/tolerance.py: its CAS loops write a row's
# repeats within a group in any order, the plain version in slot order).
# Its float64 emulation of that order already fails the check where rows
# repeat often: 0.9567 of touched elements identical at V 3000 with W 127,
# 0.9887 at V 2000 with d 192, and 0.5231 (loss 1.2e-3 apart) with the hot
# row, so the hot row is held in f32 and bf16 products only.
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
    retries = cas_retries(dev).zero_()
    kern = run(kern_fn, init, sr_seed=sr_seed)
    plain = run(plain_fn, init, sr_seed=sr_seed)
    f32 = run(plain_fn, [t.float() for t in init], mxu_bf16=True)
    torch.cuda.synchronize()
    assert kern[0].dtype == torch.bfloat16
    assert float(kern[3]) == float(plain[3])
    assert abs(float(kern[2]) - float(plain[2])) <= 1e-4 * abs(float(plain[2]))
    check_k3("K3", init, kern[:2], plain[:2], f32[:2])
    assert kern_fn.launches_bf16_tables == before + 1
    assert float(retries) >= 0.0


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
