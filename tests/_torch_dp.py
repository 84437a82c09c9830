"""Ranks of the data-parallel tests: :func:`spawn` runs a function of this
module on D processes (``torch.multiprocessing.spawn``), each a gloo rank
of a process group that meets through a ``file://`` rendezvous in the
test's own directory, so concurrent test workers never race for a port.
This module imports torch and come_tpu_torch, never jax: the JAX side of
every comparison runs in the pytest process.  Each rank returns a dict,
saved with ``torch.save`` and handed back in rank order.
"""

from __future__ import annotations

import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def spawn(fn, world: int, tmp_path: Path, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; their results in
    rank order."""
    tag = uuid.uuid4().hex[:8]
    init = Path(tmp_path) / f"rdzv_{tag}"
    out = Path(tmp_path) / f"out_{tag}"
    out.mkdir()
    torch.multiprocessing.spawn(
        _entry, args=(world, str(init), str(out), fn, args), nprocs=world,
        join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _entry(rank, world, init, out, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=world, rank=rank)
    try:
        res = fn(rank, world, *args)
        dist.barrier()
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy().copy()


def _params(t) -> dict:
    return {k: v.copy() for k, v in t.params.to_numpy().items()}


# ------------------------------------------------------- collectives


def collectives(rank, world, data):
    """The three update rules on rank-specific tables."""
    from come_tpu_torch.parallel.collectives import (
        METER,
        reduce_deltas_,
        reduce_tied_,
    )

    before = torch.tensor(data["before"])
    after = torch.tensor(data["after"][rank])
    b16 = before.to(torch.bfloat16)
    a16 = after.to(torch.bfloat16)
    ctx, ctx0 = after * 0.5, before * 0.5
    METER.reset()
    reduce_deltas_((after, ctx), (before, ctx0))
    calls = METER.calls
    reduce_deltas_((a16,), (b16,))
    tied = before.clone()
    new_in = torch.tensor(data["after"][rank])
    new_out = torch.tensor(data["out"][rank])
    reduce_tied_(tied, new_in, new_out)
    return {"f32": _np(after), "ctx": _np(ctx), "bf16": _np(a16.float()),
            "tied": _np(tied), "calls": calls}


# ---------------------------------------------------- one dp step each


def kernel_steps(rank, world, data):
    """One dp step of K1, K2, K5 and K6 (two micro-steps) through the
    trainer's step methods, each from ``data``'s tables on this rank's
    inputs."""
    from come_tpu_torch.config import PRESETS
    from come_tpu_torch.graphs import sbm_graph
    from come_tpu_torch.parallel import ShardedComETrainer, make_mesh

    g, _ = sbm_graph(data["V"], 4, seed=0, avg_degree=8)
    cfg = PRESETS["blogcatalog"].replace(**data["cfg"])
    t = ShardedComETrainer(g, cfg, make_mesh(), "cpu")
    mine = {k: torch.as_tensor(v[rank]) for k, v in data["inputs"].items()}
    ne0, ce0 = (torch.as_tensor(data[k]) for k in ("ne", "ce"))
    out = {}

    def reset():
        t.params.node_emb.copy_(ne0)
        t.params.ctx_emb.copy_(ce0)

    reset()
    loss, n = t.o1_step(mine["walks"], mine["wrow"], mine["pools"])
    out["k1"] = (_np(t.params.node_emb), _np(t.params.ctx_emb), float(loss),
                 float(n))
    reset()
    loss, n = t.o2_step(mine["slots"], mine["meta"], mine["star_pools"], 1.0)
    out["k2"] = (_np(t.params.node_emb), float(loss), float(n))
    reset()
    loss, n = t.o2_paired_step(mine["rows"], mine["paired_pools"])
    out["k5"] = (_np(t.params.node_emb), float(loss), float(n))
    reset()
    p = t.params
    loss, n = t._sgns_microbatched(
        p.node_emb, p.ctx_emb, mine["c"], mine["x"], None, mine["m"],
        t.lr(), tie_tables=False, pools=mine["k6_pools"])
    out["k6"] = (_np(p.node_emb), _np(p.ctx_emb), float(loss), float(n))
    out["lr"] = t.lr()
    out["negw"] = t.negw
    return out


# -------------------------------------------------------------- GMM EM


def gmm(rank, world, cases):
    """``gmm_em_fit_sharded`` on each case (X, mask, K, seed, kw)."""
    from come_tpu_torch.losses.gmm import gmm_em_fit_sharded

    res = []
    for X, mask, K, seed, kw in cases:
        gen = torch.Generator().manual_seed(seed)
        m = None if mask is None else torch.as_tensor(mask)
        r0 = kw.pop("resp0", None)
        out = gmm_em_fit_sharded(
            torch.as_tensor(X), m, K, gen,
            resp0=None if r0 is None else torch.as_tensor(r0), **kw)
        res.append({k: _np(v) for k, v in out.items()})
    return res


def _per_iteration_loop(st, e_step, m_step, max_iter, tol, plan=None):
    """The EM loop the port ran before its device program, on the state of
    ``losses.gmm._em_state``: a host check at the top of every
    iteration."""
    means, chol, log_w = st["means"], st["chol"], st["log_w"]
    batch = means.shape[:-2]
    prev_ll = torch.full(batch, -float("inf"))
    ll = torch.full(batch, -float("inf"))
    active = torch.ones(batch, dtype=torch.bool)
    n_iter = torch.zeros(batch, dtype=torch.int32)
    for it in range(max_iter):
        if tol > 0 and it >= 2:
            active = active & (ll - prev_ll > tol)
            if not bool(active.any()):
                break
        resp, new_ll = e_step(means, chol, log_w)
        n_means, n_chol, n_log_w, info = m_step(resp)
        assert not bool((info[active] != 0).any())
        means = torch.where(active[..., None, None], n_means, means)
        chol = torch.where(active[..., None, None, None], n_chol, chol)
        log_w = torch.where(active[..., None], n_log_w, log_w)
        prev_ll = torch.where(active, ll, prev_ll)
        ll = torch.where(active, new_ll, ll)
        n_iter += active.to(torch.int32)
    return {"means": means, "chol": chol, "log_w": log_w, "n_iter": n_iter}


def gmm_loops(rank, world, X, K, seed, cases):
    """For each keyword set in ``cases``: ``gmm_em_fit_sharded`` (with
    ``ran``, the EM iterations its loop ran), then the same fit through
    the per-iteration loop, each from a host generator seeded ``seed``."""
    from come_tpu_torch.losses import gmm

    res = []
    for kw in cases:
        ran = [0]
        one, loop = gmm._em_iteration, gmm._em_while_loop

        def counted(*a):
            ran[0] += 1
            return one(*a)

        def fit():
            out = gmm.gmm_em_fit_sharded(
                torch.as_tensor(X), None, K,
                torch.Generator().manual_seed(seed), **kw)
            return {k: _np(v) for k, v in out.items()}

        try:
            gmm._em_iteration = counted
            out = fit() | {"ran": ran[0]}
            gmm._em_while_loop = _per_iteration_loop
            ref = fit()
        finally:
            gmm._em_iteration, gmm._em_while_loop = one, loop
        res.append((out, ref))
    return res


# ------------------------------------------------------------- trainers


def karate(rank, world, cfg_kw, ckpt_dir, jax_ckpt):
    """Karate at the JAX test's config: two O1 epochs, ``train``, the same
    run again from the same seed; a checkpoint after one O1 epoch and a
    GMM fit, restored into a fresh trainer and resumed beside the saving
    one; the JAX package's checkpoint restored."""
    from come_tpu_torch.config import get_config
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.parallel import ShardedComETrainer, make_mesh

    ds = get_dataset("karate")
    cfg = get_config("karate").replace(**cfg_kw)

    def trainer():
        return ShardedComETrainer(ds.graph, cfg, make_mesh(), "cpu")

    out = {}
    t = trainer()
    out["tiers"] = (t.o1_tier(), t.o2_tier())
    out["first"] = t.o1_epoch()
    out["words_1"] = t.words_seen
    out["second"] = t.o1_epoch()
    out["hist"] = t.train(labels=ds.labels)
    out["params"] = _params(t)
    t2 = trainer()
    t2.o1_epoch()
    t2.o1_epoch()
    t2.train(labels=ds.labels)
    out["params_again"] = _params(t2)

    # shared negatives: the micro-batched tier, K6 and K7's plain versions
    shared = ShardedComETrainer(ds.graph, cfg.replace(
        negative_mode="shared", shared_negatives=32), make_mesh(), "cpu")
    out["shared"] = {"tiers": (shared.o1_tier(), shared.o2_tier()),
                     "o1": shared.o1_epoch(), "o2": shared.o2_epoch(),
                     "o2_pairs": shared.last_o2_pairs,
                     "params": _params(shared)}

    # checkpoint round trip at this world size
    t = trainer()
    t.o1_epoch()
    t.fit_gmm()
    path = Path(ckpt_dir) / "state"
    t.save_checkpoint(path)
    out["saved"] = _params(t)
    out["saved_words"] = t.words_seen
    r = trainer()
    out["restored"] = r.load_checkpoint(path)
    out["restored_params"] = _params(r)
    out["restored_words"] = r.words_seen
    out["resume"] = (t.o1_epoch(), r.o1_epoch())
    out["resume_params"] = (_params(t), _params(r))

    j = trainer()
    j.load_checkpoint(jax_ckpt)
    out["from_jax"] = _params(j)
    out["from_jax_words"] = j.words_seen
    return out


def sbm(rank, world, cfg_kw):
    """SBM-512 at the JAX dp test's config: six O1 epochs through K1's
    plain version, the GMM fit, NMI."""
    from come_tpu_torch.config import ComEConfig
    from come_tpu_torch.evaluation import nmi_score
    from come_tpu_torch.graphs import sbm_graph
    from come_tpu_torch.parallel import ShardedComETrainer, make_mesh

    g, labels = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    t = ShardedComETrainer(g, ComEConfig(**cfg_kw), make_mesh(), "cpu")
    losses = [t.o1_epoch() for _ in range(6)]
    words = t.words_seen
    t.fit_gmm()
    out = {"tiers": (t.o1_tier(), t.o2_tier()), "losses": losses,
           "words": words, "nmi": nmi_score(labels, t.communities()),
           "params": _params(t), "o2": t.o2_epoch(),
           "o2_pairs": t.last_o2_pairs}
    # the paired O2 tier (K5's plain version) on the trained table
    p = ShardedComETrainer(g, ComEConfig(**cfg_kw, o2_mode="paired"),
                           make_mesh(), "cpu")
    p.params.node_emb.copy_(t.params.node_emb)
    out["paired"] = {"tier": p.o2_tier(), "plan": p.o2_paired_plan(),
                     "o2": p.o2_epoch(), "o2_pairs": p.last_o2_pairs,
                     "words": p.words_seen, "params": _params(p)}
    return out


def host_corpus(rank, world, cfg_kw):
    """Karate with ``corpus="host"``: every batch this rank trains in two
    O1 epochs, and its feeder's settings."""
    from come_tpu_torch.config import get_config
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.parallel import ShardedComETrainer, make_mesh

    ds = get_dataset("karate")
    cfg = get_config("karate").replace(**cfg_kw)
    t = ShardedComETrainer(ds.graph, cfg, make_mesh(), "cpu")
    seen = []
    step = t.o1_pairs_step

    def spy(walks):
        seen.append(_np(walks))
        return step(walks)

    t.o1_pairs_step = spy
    try:
        t.o1_epoch()
        t.o1_epoch()
        f = t.host_feeder()
        feeder = {"batch": f.batch, "nodes": np.array(f._nodes)}
    finally:
        t.close()
    return {"seen": seen, "feeder": feeder, "seed": t.seed,
            "walk_starts": t.walk_starts, "params": _params(t)}
