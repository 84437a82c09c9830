"""The CUDA kernels against their plain PyTorch versions on the card, at
small and ragged shapes (partial pool chunks, d below 128, wrapped walk
batches, R=2, tiles of 64 and ragged tails, pools that repeat rows), plus
short trainer runs through the kernels.

Needs a CUDA card: every test is marked ``cuda`` and skips without one.
Imports nothing of JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance, on each table element's update (after the step minus before):
|upd_kernel - upd_plain| <= 1e-6 + 1e-4 |upd_plain| (f32; atomicAdd order
varies), loss rtol 1e-4, pair counts exact.
"""

import numpy as np
import pytest
import torch

from come_tpu_torch.config import PRESETS, get_config
from come_tpu_torch.graphs import get_dataset, sbm_graph
from come_tpu_torch.ops.sgns import (
    fused_sgns_step,
    fused_sgns_step_reference,
    fused_sgns_step_tied,
    fused_sgns_step_tied_reference,
)
from come_tpu_torch.ops.star_sgns import star_sgns_step, star_sgns_step_reference
from come_tpu_torch.ops.walk_sgns import NWL, walk_sgns_step, walk_sgns_step_reference
from come_tpu_torch.sampling import build_star_layout
from come_tpu_torch.trainer import ComETrainer

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
    for t0, a, b in zip(init, kt, pt):
        torch.testing.assert_close(a - t0, b - t0, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("V,d,B,L,W,KP,R", [
    (300, 128, 16, 20, 3, 16, 1),
    (500, 64, 21, 37, 5, 100, 2),
    (400, 96, 24, 128, 10, 64, 1),
    (2000, 128, 40, 80, 10, 512, 3),
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


@pytest.mark.parametrize("V,d,E,KP,R", [
    (200, 128, 3000, 16, 1),
    (600, 64, 9000, 100, 2),
    (3000, 128, 40000, 512, 1),
])
def test_star_kernel_matches_plain(dev, V, d, E, KP, R):
    rng = np.random.default_rng(V)
    u = rng.integers(0, V, E)
    v = (u + 1 + rng.integers(0, V - 1, E)) % V
    slots, meta = build_star_layout(u, v, V)
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
@pytest.mark.parametrize("V,d,P,TP,KP", [
    (34, 16, 1000, 64, 100),  # karate-sized: pool and pairs repeat rows
    (500, 64, 3000, 1024, 512),
    (10312, 128, 32768, 1024, 512),
    (2000, 128, 777, 64, 100),
])
def test_fused_kernels_match_plain(dev, V, d, P, TP, KP, tied):
    g = torch.Generator(device=dev).manual_seed(V + P)
    emb_in = torch.randn((V, d), generator=g, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=g, device=dev) * 0.1
    c, x, pool = (torch.randint(0, V, (n,), generator=g, device=dev,
                                dtype=torch.int32) for n in (P, P, KP))
    m = (torch.rand(P, generator=g, device=dev) < 0.6).float()
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
