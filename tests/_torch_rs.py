"""Ranks of the row-sharded (model axis) tests, started by
``tests/_torch_dp.py::spawn`` (gloo processes, a ``file://`` rendezvous in
the test's directory, one thread each).  Like ``_torch_dp.py`` this module
imports torch and come_tpu_torch, never jax: the JAX side of every
comparison runs in the pytest process.  Rank r of a (D, M) mesh is
(r // M, r % M)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from _torch_dp import _np, _params


def _mesh(D, M):
    from come_tpu_torch.parallel import make_mesh

    return make_mesh(D, M)


def mesh_groups(rank, world, D, M):
    """The mesh's indices, sub-groups and layout on this rank."""
    import torch.distributed as dist

    from come_tpu_torch.parallel import MeshLayout
    from come_tpu_torch.parallel.collectives import all_reduce_

    m = _mesh(D, M)
    lay = MeshLayout(m)
    ones = torch.ones(1)
    x = torch.arange(D * 4).view(1, D * 4)
    return {
        "shape": m.shape, "rank": m.rank,
        "index": (m.data_index, m.model_index),
        "data_size": dist.get_world_size(m.data_group),
        "model_size": dist.get_world_size(m.model_group),
        "data_rank": dist.get_rank(m.data_group),
        "model_rank": dist.get_rank(m.model_group),
        # the sum over each group counts its ranks
        "data_sum": float(all_reduce_(ones.clone(), m.data_group)),
        "model_sum": float(all_reduce_(torch.tensor([float(rank)]),
                                       m.model_group)),
        "row_block": lay.row_block(12 * M),
        "local": _np(lay.local(x)),
    }


# ------------------------------------------------------------ exchange


def exchange(rank, world, D, M, cases):
    """Each case (idx [D, M, B], table [V, d], upd [D, M, B, d], C): this
    worker's plan, gathered rows and scattered delta; batched plans of
    ``idx`` [D, M, G, B]; and ``plan_walk_macro_steps`` of walks/pools."""
    from come_tpu_torch.parallel.exchange import (
        make_exchange_plan,
        make_exchange_plans_batched,
    )
    from come_tpu_torch.parallel.walk_exchange import plan_walk_macro_steps

    m = _mesh(D, M)
    di, mi, g = m.data_index, m.model_index, m.model_group
    out = []
    for c in cases:
        V = c["table"].shape[0]
        rp = V // M
        if "walks" in c:
            plans, rw, rn, served = plan_walk_macro_steps(
                torch.as_tensor(c["walks"][di, mi]),
                torch.as_tensor(c["sneg"][di, mi]), rp, c["slack"], mi, M, g)
            out.append({"plan": {k: _np(getattr(plans, k)) for k in (
                "order", "sowner", "pos", "ok", "served", "got")},
                "rwalks": _np(rw), "rneg": _np(rn), "served": _np(served)})
            continue
        idx = torch.as_tensor(c["idx"][di, mi])
        if idx.dim() == 2:
            plan = make_exchange_plans_batched(idx, rp, c["C"], mi, M, g)
            out.append({"plan": {k: _np(getattr(plan, k)) for k in (
                "order", "sowner", "pos", "ok", "served", "got")}})
            continue
        table = torch.as_tensor(c["table"][mi * rp:(mi + 1) * rp])
        plan = make_exchange_plan(idx, rp, c["C"], mi, M, g)
        rows = plan.gather(table)
        delta = plan.scatter_add(torch.zeros_like(table),
                                 torch.as_tensor(c["upd"][di, mi]))
        out.append({"plan": {k: _np(getattr(plan, k)) for k in (
            "order", "sowner", "pos", "ok", "served", "got")},
            "rows": _np(rows), "delta": _np(delta)})
    return out


def steps(rank, world, D, M, data):
    """One ``fused_walk_step_rowsharded`` step of K1, K1b and K5 from the
    same shards, and three O1 steps through ``prefetch_loop`` with the row
    prefetch on, each from ``data``'s tables on this worker's inputs."""
    from come_tpu_torch.parallel.walk_exchange import (
        apply_deltas_,
        fused_walk_step_prepped,
        fused_walk_step_rowsharded,
        plan_walk_macro_steps,
        prefetch_loop,
    )

    m = _mesh(D, M)
    di, mi = m.data_index, m.model_index
    rp = data["ne"].shape[0] // M
    W, lr, negw = data["W"], data["lr"], data["negw"]

    def shard(name):
        return torch.as_tensor(data[name][mi * rp:(mi + 1) * rp]).clone()

    def mine(name):
        return torch.as_tensor(data[name][di, mi])

    kw = dict(index=mi, size=M, model_group=m.model_group,
              data_group=m.data_group, group=None)
    out = {}
    for name, bf16 in (("k1", False), ("k1b", True)):
        ne, ce = shard("ne"), shard("ce")
        walks = mine("walks")
        G = -(-walks.shape[0] // 8)
        wrow = torch.full((G * 1024,), W, dtype=torch.int32)
        loss, n, srv = fused_walk_step_rowsharded(
            ne, ce, walks, wrow, mine("pools"), lr, negw, window=W,
            mxu_bf16=bf16, **kw)
        out[name] = (_np(ne), _np(ce), float(loss), float(n), srv)
    ne = shard("ne")
    loss, n, srv = fused_walk_step_rowsharded(
        ne, None, mine("rows"), None, mine("paired_pools"), lr, negw,
        window=1, paired=True, **kw)
    out["k5"] = (_np(ne), float(loss), float(n), srv)

    # three steps with the one-step row prefetch
    ne, ce = shard("ne"), shard("ce")
    walks, pools = mine("walks3"), mine("pools3")
    S, B = walks.shape[:2]
    wrow = torch.full((-(-B // 8) * 1024,), W, dtype=torch.int32)
    plans, rw, rn, _ = plan_walk_macro_steps(walks, pools, rp, 2.0, mi, M,
                                             m.model_group)
    losses = []

    def gather(plan):
        return plan.gather(ne), plan.gather(ce)

    def step(k, rows, plan):
        dn, dc, loss, n = fused_walk_step_prepped(
            ne, ce, rows[0], rows[1], plan, rw[k], wrow, rn[k], lr, negw,
            window=W)
        apply_deltas_([ne, ce], [dn, dc], m.data_group)
        losses.append(float(loss))

    prefetch_loop(plans.step, S, gather, step, overlap=True)
    out["prefetch"] = (_np(ne), _np(ce), losses)
    return out


# ------------------------------------------------------------- trainers


def _karate(D, M, kw):
    from come_tpu_torch.config import get_config
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.parallel import ShardedComETrainer

    ds = get_dataset("karate")
    cfg = get_config("karate").replace(**dict(
        dict(outer_iters=1, pretrain_epochs=2, walks_per_node=4), **kw))
    return ShardedComETrainer(ds.graph, cfg, _mesh(D, M), "cpu"), ds


def _views(t) -> dict:
    return {"emb": t.embeddings(), "com": t.communities(),
            "words": t.words_seen}


def karate(rank, world, D, M, ckpt_dir, jax_ckpt, restore_from,
           train=True):
    """Karate at ``tests/test_parallel.py:77-104``'s configs on a (D, M)
    mesh: with ``train``, per-pair and shared negatives (two O1 epochs
    and ``train``); with ``ckpt_dir`` a checkpoint after one O1 epoch and
    a GMM fit, restored into a fresh trainer and resumed beside the saving
    one, and the JAX package's checkpoint ``jax_ckpt`` restored; with
    ``restore_from`` that checkpoint restored on this mesh."""
    out = {}
    for name, kw in (("per_pair", {}),
                     ("shared", dict(negative_mode="shared",
                                     shared_negatives=32)))[:2 * train]:
        t, ds = _karate(D, M, kw)
        r = {"tiers": (t.o1_tier(), t.o2_tier()), "v_pad": t.v_pad,
             "first": t.o1_epoch()}
        r["words_1"] = t.words_seen
        r["second"] = t.o1_epoch()
        r["hist"] = t.train(labels=ds.labels)
        r["served"] = (t.last_o1_served, t.last_o2_served)
        r["shard"] = _np(t.params.node_emb)
        r["views"] = _views(t)
        out[name] = r
    if restore_from:
        t, _ = _karate(D, M, {})
        out["restored"] = t.load_checkpoint(restore_from)
        out["restored_views"] = _views(t)
        out["after"] = t.o1_epoch()
    if ckpt_dir:
        t, _ = _karate(D, M, {})
        t.o1_epoch()
        t.fit_gmm()
        path = Path(ckpt_dir) / "state"
        t.save_checkpoint(path)
        out["saved"] = _params(t)
        out["saved_views"] = _views(t)
        r, _ = _karate(D, M, {})
        out["restored_same"] = r.load_checkpoint(path)
        out["restored_params"] = _params(r)
        out["resume"] = (t.o1_epoch(), r.o1_epoch())
        out["resume_params"] = (_params(t), _params(r))
    if jax_ckpt:
        j, _ = _karate(D, M, {})
        j.load_checkpoint(jax_ckpt)
        out["from_jax"] = _views(j)
    return out


def sbm(rank, world, D, M, cfg_kw):
    """SBM-512 at ``tests/test_walk_kernel_trainer.py:11-34``'s config:
    six O1 epochs through the row-sharded walk tier (K1's plain version),
    the GMM fit and NMI; then paired O2 epochs (K5's plain version); then
    two O1 epochs with the row prefetch on."""
    from come_tpu_torch.config import ComEConfig
    from come_tpu_torch.evaluation import nmi_score
    from come_tpu_torch.graphs import sbm_graph
    from come_tpu_torch.parallel import ShardedComETrainer

    g, labels = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    t = ShardedComETrainer(g, ComEConfig(**cfg_kw), _mesh(D, M), "cpu")
    out = {"tiers": (t.o1_tier(), t.o2_tier())}
    out["losses"] = [t.o1_epoch() for _ in range(6)]
    out["o1_served"] = t.last_o1_served
    out["words"] = t.words_seen
    t.fit_gmm()
    out["nmi"] = nmi_score(labels, t.communities())
    out["o2"] = [t.o2_epoch() for _ in range(3)]
    out["o2_served"] = t.last_o2_served
    out["o2_pairs"] = t.last_o2_pairs
    out["emb"] = t.embeddings()
    out["shard"] = _params(t)
    p = ShardedComETrainer(g, ComEConfig(**cfg_kw, overlap_exchange=True),
                           _mesh(D, M), "cpu")
    out["overlap"] = [p.o1_epoch() for _ in range(2)]
    out["ab"] = t.exchange_overlap_ab()
    return out


def host_corpus(rank, world, D, M, cfg_kw):
    """Karate with ``corpus="host"`` on a (D, M) mesh: the batches this
    rank trains in one O1 epoch, and its feeder's settings."""
    t, _ = _karate(D, M, cfg_kw)
    seen = []
    step = t.o1_pairs_step

    def spy(walks):
        seen.append(_np(walks))
        return step(walks)

    t.o1_pairs_step = spy
    try:
        t.o1_epoch()
        f = t.host_feeder()
        feeder = {"batch": f.batch, "nodes": np.array(f._nodes)}
    finally:
        t.close()
    return {"seen": seen, "feeder": feeder, "walk_starts": t.walk_starts,
            "shard": _np(t.params.node_emb)}


def gmm(rank, world, D, M, X, K, resp0):
    """The two-axis EM on this rank's model shard of ``X`` [V, d] (V a
    multiple of M), from ``resp0`` and from the k-means init."""
    from come_tpu_torch.losses.gmm import gmm_em_fit_sharded

    m = _mesh(D, M)
    rp = X.shape[0] // M
    sl = slice(m.model_index * rp, (m.model_index + 1) * rp)
    Xs = torch.as_tensor(X[sl])
    kw = dict(max_iter=30, reg_covar=1e-4, model=M)
    a = gmm_em_fit_sharded(Xs, None, K, torch.Generator().manual_seed(0),
                           None, resp0=torch.as_tensor(resp0[sl]), **kw)
    b = gmm_em_fit_sharded(Xs, None, K, torch.Generator().manual_seed(0),
                           None, n_init=2, **kw)
    return [{k: _np(v) for k, v in o.items()} for o in (a, b)]


def prefetch_curve(rank, world, D, M, data):
    """One O1 pass of the port's ``ShardedComETrainer`` at the blogcatalog
    preset (cut by ``data["cfg"]``) from the JAX trainer's initial tables,
    on its walks and pools, every window full (the JAX interpret path's
    window), with the row prefetch as ``data["cfg"]`` says.  Returns this
    worker's (loss, pairs) per step."""
    from come_tpu_torch.config import get_config
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.parallel import ShardedComETrainer
    from come_tpu_torch.parallel import sharded

    class FullWindow(ShardedComETrainer):
        def _rowsharded_epoch(self, rows_all, n_pools, kernel_step, tables,
                              n_wrow=0):
            full = torch.full((n_wrow,), self.cfg.window, dtype=torch.int32)

            def step(k, rows, plan, rw, wrow, rn):
                kernel_step(k, rows, plan, rw, full, rn)

            super()._rowsharded_epoch(rows_all, n_pools, step, tables, 0)

    ds = get_dataset("blogcatalog")
    cfg = get_config("blogcatalog").replace(**data["cfg"])
    t = FullWindow(ds.graph, cfg, _mesh(D, M), "cpu")
    di, mi = t.layout.data_index, t.layout.model_index
    a, b = t.layout.row_block(t.v_pad)
    t.params.node_emb.copy_(torch.as_tensor(data["ne"][a:b]))
    t.params.ctx_emb.copy_(torch.as_tensor(data["ce"][a:b]))
    pools = torch.as_tensor(data["pools"][di][mi])
    sharded.sample_alias = lambda accept, alias, gen, shape: pools[:shape[0]]
    losses = []
    kernel = sharded.fused_walk_step_prepped

    def spy(*args, **kw):
        out = kernel(*args, **kw)
        losses.append((float(out[2]), float(out[3])))
        return out

    sharded.fused_walk_step_prepped = spy
    walks = torch.as_tensor(np.concatenate(data["walks"][di], axis=1))
    t._o1_rowsharded_scan(walks)
    return {"losses": losses, "overlap": t._overlap_on()}


def heavy_tail(rank, world, D, M, cfg_kw, graph_kw):
    """``tests/test_heavy_tail.py::test_rowsharded_a2a_heavy_tail_capacity``
    on this rank: the dc-SBM of ``graph_kw`` through the row-sharded walk
    tier, six O1 epochs, the GMM fit and NMI."""
    from come_tpu_torch.config import ComEConfig
    from come_tpu_torch.evaluation import nmi_score
    from come_tpu_torch.graphs import dc_sbm_graph
    from come_tpu_torch.parallel import ShardedComETrainer

    g, labels = dc_sbm_graph(**graph_kw)
    t = ShardedComETrainer(g, ComEConfig(**cfg_kw), _mesh(D, M), "cpu")
    out = {"tier": t.o1_tier(), "slack": t.cfg.a2a_capacity_slack}
    out["first"] = t.o1_epoch()
    out["served_first"] = t.last_o1_served
    out["losses"] = [t.o1_epoch() for _ in range(5)]
    out["served"] = t.last_o1_served
    t.fit_gmm()
    out["nmi"] = nmi_score(labels, t.communities())
    return out
