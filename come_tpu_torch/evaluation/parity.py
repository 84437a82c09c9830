"""Per-iteration gradient parity harness — port of
``come_tpu/evaluation/parity.py`` (the BASELINE.json:5 acceptance gate).

Checks, for a fixed batch and identical initial tables, that the port's
O1/O2/O3 gradients match the numpy oracle (``evaluation/oracle.py``, a copy
of the JAX package's) to float tolerance.  Every row draws the same inputs
from the same ``np.random.default_rng(seed)`` stream as the JAX harness and
goes through the port's counterpart of the JAX function it checks, on
``device`` (on ``cuda`` the kernel rows launch the CUDA kernels; on the CPU
the wrappers run their plain versions):

  o1, o2         losses/sgns.py::sgns_loss_and_grads (per-pair negatives)
  o3             losses/community.py::community_grad
  o1_fast        ops/walk_sgns.py::walk_sgns_step (K1), one group, full
                 window draws (wrow = W, the JAX row's reduced_window=False)
  o1_fast_multi  the same, four groups at pool_refresh 2
  o2_fast        ops/sgns.py::fused_sgns_step_tied (K7) with one tile
                 holding every pair, so the step is one synchronous update
                 as sgns_block_sgd_step(tie_tables=True) is
  o2_fanout      walk_sgns_step(paired=True) (K5), tied composition
  o2_star        ops/star_sgns.py::star_sgns_step (K2)

The two row-sharded rows stay nan (the JAX harness reports them on fewer
than 4 devices; the port has no multi-GPU path yet).  Runs as a library call
or a CLI, which exits 1 when an iteration fails:

    python -m come_tpu_torch.evaluation.parity --dataset karate --iters 3
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ParityReport:
    o1_max_err: float
    o2_max_err: float
    o3_max_err: float
    loss_rel_err: float
    passed: bool
    o1_fast_max_err: float = float("nan")
    o2_fast_max_err: float = float("nan")
    o1_fast_multi_max_err: float = float("nan")
    o1_fast_rowsharded_max_err: float = float("nan")
    o2_fanout_max_err: float = float("nan")
    o2_rowsharded_max_err: float = float("nan")
    o2_star_max_err: float = float("nan")

    def __str__(self):
        s = "PASS" if self.passed else "FAIL"
        return (
            f"parity {s}: o1={self.o1_max_err:.2e} o2={self.o2_max_err:.2e} "
            f"o3={self.o3_max_err:.2e} loss_rel={self.loss_rel_err:.2e} "
            f"o1_fast={self.o1_fast_max_err:.2e} "
            f"o2_fast={self.o2_fast_max_err:.2e} "
            f"o1_fast_multi={self.o1_fast_multi_max_err:.2e} "
            f"o1_fast_rowsharded={self.o1_fast_rowsharded_max_err:.2e} "
            f"o2_fanout={self.o2_fanout_max_err:.2e} "
            f"o2_rowsharded={self.o2_rowsharded_max_err:.2e} "
            f"o2_star={self.o2_star_max_err:.2e}"
        )


def check_gradient_parity(
    graph,
    dim: int = 32,
    num_communities: int = 2,
    pairs: int = 512,
    negatives: int = 5,
    seed: int = 0,
    atol: float = 5e-4,
    rtol: float = 1e-3,
    device="cuda",
) -> ParityReport:
    """One iteration of O1/O2/O3 gradient comparison vs the numpy oracle,
    every port function run on ``device``."""
    from come_tpu_torch.evaluation import oracle
    from come_tpu_torch.losses.community import community_grad
    from come_tpu_torch.losses.sgns import sgns_loss_and_grads
    from come_tpu_torch.ops.sgns import fused_sgns_step_tied
    from come_tpu_torch.ops.star_sgns import NWL as SNWL
    from come_tpu_torch.ops.star_sgns import star_sgns_step
    from come_tpu_torch.ops.walk_sgns import NWL, walk_sgns_step
    from come_tpu_torch.sampling.stars import PAD_META, build_star_layout

    dev = torch.device(device)

    def t(a):  # a copy: the kernel rows update their tables in place
        return torch.tensor(np.asarray(a), device=dev)

    def host(a):
        return a.detach().cpu().numpy()

    rng = np.random.default_rng(seed)
    V = graph.num_nodes
    emb_in = (rng.normal(size=(V, dim)) * 0.3).astype(np.float32)
    emb_out = (rng.normal(size=(V, dim)) * 0.3).astype(np.float32)

    # O1 batch: random walk-window style pairs
    c = rng.integers(0, V, pairs).astype(np.int32)
    x = rng.integers(0, V, pairs).astype(np.int32)
    negs = rng.integers(0, V, (pairs, negatives)).astype(np.int32)
    m = np.ones(pairs, bool)

    def dense(contrib, cc, xx, nn, shape_out):
        """Per-row contributions scattered into [V, d] tables (the JAX
        harness's np.add.at)."""
        d_phi, d_cpos, d_cneg = (host(a) for a in contrib)
        din = np.zeros_like(emb_in)
        dout = np.zeros(shape_out, np.float32)
        np.add.at(din, cc, d_phi)
        np.add.at(dout, xx, d_cpos)
        np.add.at(dout, nn.reshape(-1), d_cneg.reshape(-1, dim))
        return din, dout

    loss, _, contrib = sgns_loss_and_grads(
        t(emb_in), t(emb_out), t(c).long(), t(x).long(), t(negs).long(),
        t(m),
    )
    din, dout = dense(contrib, c, x, negs, emb_out.shape)
    oloss, odin, odout = oracle.sgns_batch_grads(emb_in, emb_out, c, x, negs, m)
    o1_err = max(
        float(np.abs(din - odin).max()), float(np.abs(dout - odout).max())
    )
    loss_rel = abs(float(loss) - oloss) / max(abs(oloss), 1e-9)

    # O2: tied tables on real edges
    src, dst = graph.arcs()
    take = rng.choice(len(src), size=min(pairs, len(src)), replace=False)
    s2, d2 = src[take].astype(np.int32), dst[take].astype(np.int32)
    n2 = rng.integers(0, V, (len(take), negatives)).astype(np.int32)
    m2 = np.ones(len(take), bool)
    _, _, contrib2 = sgns_loss_and_grads(
        t(emb_in), t(emb_in), t(s2).long(), t(d2).long(), t(n2).long(),
        t(m2),
    )
    dg_in, dg_out = dense(contrib2, s2, d2, n2, emb_in.shape)
    dg = dg_in + dg_out
    _, odg = oracle.sgns_batch_grads_tied(emb_in, s2, d2, n2, m2)
    o2_err = float(np.abs(dg - odg).max())

    # O3: community gradient on a random GMM state
    K = num_communities
    pi = rng.random((V, K)).astype(np.float32)
    pi /= pi.sum(1, keepdims=True)
    centroid = rng.normal(size=(K, dim)).astype(np.float32)
    A = rng.normal(size=(K, dim, dim)).astype(np.float32) * 0.1
    cov = np.einsum("kde,kfe->kdf", A, A) + np.eye(dim, dtype=np.float32)
    inv_cov = np.linalg.inv(cov)
    beta = 0.1
    g3 = host(community_grad(t(emb_in), t(pi), t(centroid), t(inv_cov),
                             beta))
    og3 = oracle.community_grads(emb_in, pi, centroid, inv_cov, beta)
    o3_err = float(np.abs(g3 - og3).max())

    # ---- fast-path rows: the kernels as SGD steps ----
    # O1-fast: the walk kernel, one group, full window draws, one pool, vs
    # the banded shared-pool oracle: new = old - lr * grad(initial tables)
    KP = 16
    W, L = 3, 12
    nw = NWL // 128
    walks = rng.integers(0, V, (nw, L)).astype(np.int32)
    pool = rng.integers(0, V, KP).astype(np.int32)
    negw = negatives / KP
    lr = 0.025

    def full_window(G):
        return torch.full((G * NWL,), W, dtype=torch.int32, device=dev)

    ni, no, floss, _ = walk_sgns_step(
        t(emb_in), t(emb_out), t(walks), full_window(1), t(pool), lr, negw,
        window=W,
    )
    wrow = np.full((nw, L), W, np.int32)
    o_floss, _, o_din, o_dout = oracle.walk_banded_shared_pool_grads(
        emb_in, emb_out, walks, pool, wrow, negw
    )
    o1f_err = max(
        float(np.abs(host(ni) - (emb_in - lr * o_din)).max()),
        float(np.abs(host(no) - (emb_out - lr * o_dout)).max()),
    ) / lr
    o1f_scale = max(np.abs(o_din).max(), np.abs(o_dout).max())
    loss_rel = max(
        loss_rel, abs(float(floss) - o_floss) / max(abs(o_floss), 1e-9)
    )

    # O2-fast: the tied shared-pool step with one tile of every pair vs the
    # shared-pool oracle
    nt, bloss, _ = fused_sgns_step_tied(
        t(emb_in), t(s2), t(d2), t(pool), t(m2).float(), lr, negw,
        tile_pairs=len(s2),
    )
    o_bloss, o_bin, o_bout = oracle.sgns_shared_pool_grads(
        emb_in, emb_in, s2, d2, pool, m2, negw
    )
    o_btied = o_bin + o_bout
    o2f_err = float(np.abs(host(nt) - (emb_in - lr * o_btied)).max()) / lr
    o2f_scale = float(np.abs(o_btied).max())
    loss_rel = max(
        loss_rel, abs(float(bloss) - o_bloss) / max(abs(o_bloss), 1e-9)
    )

    # O1-fast-multi: four sequential groups at pool_refresh 2 vs the
    # composed sequential oracle
    G, R = 4, 2
    walks_m = rng.integers(0, V, (G * nw, L)).astype(np.int32)
    pools_m = rng.integers(0, V, (G // R, KP)).astype(np.int32)
    mi_, mo_, mloss, mnp = walk_sgns_step(
        t(emb_in), t(emb_out), t(walks_m), full_window(G), t(pools_m), lr,
        negw, window=W, pool_refresh=R,
    )
    wrow_m = np.full((G * nw, L), W, np.int32)
    o_mi, o_mo, o_mloss, o_mnp = oracle.walk_banded_kernel_sequential(
        emb_in, emb_out, walks_m, pools_m, wrow_m, negw, lr, nw,
        pool_refresh=R,
    )
    o1m_err = max(
        float(np.abs(host(mi_) - o_mi).max()),
        float(np.abs(host(mo_) - o_mo).max()),
    ) / lr
    o1m_scale = max(
        np.abs((o_mi - emb_in) / lr).max(),
        np.abs((o_mo - emb_out) / lr).max(),
    )
    assert float(mnp) == o_mnp, (float(mnp), o_mnp)
    loss_rel = max(
        loss_rel, abs(float(mloss) - o_mloss) / max(abs(o_mloss), 1e-9)
    )

    # O2-fanout: the paired (edge-mode) kernel with tied composition vs the
    # paired sequential oracle on two equal table copies composed alike
    EPR = 6  # edges per row (12 slots)
    rows2 = np.empty((2 * nw, 2 * EPR), np.int32)
    eu = rng.integers(0, V, (2 * nw, EPR))
    ev = rng.integers(0, V, (2 * nw, EPR))
    rows2[:, 0::2] = eu
    rows2[:, 1::2] = ev
    pool2 = rng.integers(0, V, (1, KP)).astype(np.int32)
    pi_, po_, ploss, pnp = walk_sgns_step(
        t(emb_in), t(emb_in), t(rows2), None, t(pool2), lr, negw, window=1,
        pool_refresh=2, paired=True,
    )
    tied = host(pi_) + host(po_) - emb_in
    o_pi, o_po, o_ploss, o_pnp = oracle.walk_banded_kernel_sequential(
        emb_in, emb_in, rows2, pool2, np.ones_like(rows2), negw, lr, nw,
        pool_refresh=2, paired=True,
    )
    o_tied = o_pi + o_po - emb_in
    o2p_err = float(np.abs(tied - o_tied).max()) / lr
    o2p_scale = float(np.abs((o_tied - emb_in) / lr).max())
    assert float(pnp) == o_pnp == rows2.size, (float(pnp), o_pnp)
    loss_rel = max(
        loss_rel, abs(float(ploss) - o_ploss) / max(abs(o_ploss), 1e-9)
    )

    # O2-star: the star layout from random edges, at least 2 groups with a
    # fresh pool per block (pool_refresh 2), vs the star group-sequential
    # oracle
    eu3 = rng.integers(0, V, 4 * nw).astype(np.int64)
    ev3 = (eu3 + 1 + rng.integers(0, V - 1, 4 * nw)) % V
    s3, m3 = build_star_layout(eu3, ev3, V)
    G3 = max(2, -(-s3.shape[0] // SNWL))
    s3 = np.pad(s3, (0, G3 * SNWL - s3.shape[0]))
    m3 = np.pad(m3, (0, G3 * SNWL - m3.shape[0]), constant_values=PAD_META)
    pool3 = rng.integers(0, V, (-(-G3 // 2), KP)).astype(np.int32)
    si, sloss, snp = star_sgns_step(
        t(emb_in), t(s3), t(m3), t(pool3), lr, negw, pool_refresh=2,
    )
    o_si, o_sloss, o_snp = oracle.star_kernel_sequential(
        emb_in, s3, m3, pool3, negw, lr, pool_refresh=2, group_slots=SNWL,
    )
    o2s_err = float(np.abs(host(si) - o_si).max()) / lr
    o2s_scale = max(float(np.abs((o_si - emb_in) / lr).max()), 1.0)
    assert float(snp) == o_snp, (float(snp), o_snp)
    loss_rel = max(
        loss_rel, abs(float(sloss) - o_sloss) / max(abs(o_sloss), 1e-9)
    )

    passed = (
        o1_err < atol + rtol * float(np.abs(odin).max() + np.abs(odout).max())
        and o2_err < atol + rtol * float(np.abs(odg).max())
        and o3_err < atol + rtol * float(np.abs(og3).max())
        and o1f_err < atol + rtol * o1f_scale
        and o2f_err < atol + rtol * o2f_scale
        and o1m_err < atol + rtol * o1m_scale
        and o2p_err < atol + rtol * o2p_scale
        and o2s_err < atol + rtol * o2s_scale
        and loss_rel < 1e-3
    )
    return ParityReport(
        o1_err, o2_err, o3_err, loss_rel, passed, o1f_err, o2f_err,
        o1m_err, float("nan"), o2p_err, float("nan"), o2s_err,
    )


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="gradient parity vs numpy oracle")
    p.add_argument("--dataset", default="karate")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--pairs", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="torch device of the port's functions (cuda or cpu)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False (pass --device cpu for the plain versions)")

    from come_tpu_torch.graphs import get_dataset

    ds = get_dataset(args.dataset)
    ok = True
    for i in range(args.iters):
        rep = check_gradient_parity(
            ds.graph, dim=args.dim, pairs=args.pairs, seed=i,
            num_communities=ds.num_communities, device=args.device,
        )
        print(f"iter {i}: {rep}")
        ok &= rep.passed
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
