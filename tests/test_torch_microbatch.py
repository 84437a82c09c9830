"""The port's micro-batched SGNS tier against the JAX package: the plain
versions of K6/K7 against the Pallas kernels in interpret mode, the
per-pair step and the shared-pool tile math against the JAX functions and
the numpy oracles, window pairs and keep probabilities bit for bit, the
loaders and Karate, ``_sgns_microbatched`` against the JAX trainer's method
on one macro batch, and the Karate preset end to end.

Both sides get the same inputs, made with numpy from a seed (or, for the
window and keep draws and the micro-step pools, drawn by JAX from its key
and handed to the port).

Tolerances: K6/K7 tables rtol 1e-4 / atol 1e-5 and loss rtol 1e-4 (the JAX
kernel tests' own limits); the per-pair step and the tile math rtol 1e-5 /
atol 1e-6 against JAX and rtol 1e-4 / atol 1e-5 against the float64 numpy
oracles (f32 sums taken in another order); ``_sgns_microbatched`` tables
rtol 1e-4 / atol 1e-5, loss rtol 1e-4; pair counts, window pairs, keep
probabilities, CSR arrays and labels exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.config import get_config as j_get_config
from come_tpu.evaluation import oracle
from come_tpu.graphs import get_dataset as j_get_dataset
from come_tpu.graphs import loaders as jload
from come_tpu.losses.sgns import sgns_sgd_step as j_sgd_step
from come_tpu.losses.sgns_block import (
    sgns_block_grads_from_rows as j_block_grads,
)
from come_tpu.ops.pallas_sgns import fused_sgns_step as j_fused
from come_tpu.ops.pallas_sgns import fused_sgns_step_tied as j_fused_tied
from come_tpu.sampling import sample_alias as j_sample_alias
from come_tpu.sampling import skipgram_pairs as j_skipgram_pairs
from come_tpu.sampling import subsample_keep_probs as j_keep_probs
from come_tpu.trainer import ComETrainer as JTrainer
from come_tpu_torch.config import get_config
from come_tpu_torch.graphs import get_dataset
from come_tpu_torch.graphs import loaders
from come_tpu_torch.losses.sgns import sgns_sgd_step
from come_tpu_torch.losses.sgns_block import sgns_block_grads_from_rows
from come_tpu_torch.ops.sgns import fused_sgns_step, fused_sgns_step_tied
from come_tpu_torch.sampling.windows import (
    skipgram_pairs,
    subsample_keep_probs,
)
from come_tpu_torch.trainer import ComETrainer
from come_tpu_torch.trainer import come as come_mod

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _pairs(rng, V, P, masked=0.1):
    c = rng.integers(0, V, P).astype(np.int32)
    x = rng.integers(0, V, P).astype(np.int32)
    m = (rng.random(P) >= masked).astype(np.float32)
    return c, x, m


# ------------------------------------------------------------- K6 / K7 plain

@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("d", [16, 128, 256, 300])
@pytest.mark.parametrize("P,TP", [(300, 128), (256, 128), (64, 64)])
def test_fused_plain_matches_pallas_kernel(P, TP, d, tied):
    rng = np.random.default_rng(P + TP + d)
    V, KP = 48, 16
    emb_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    emb_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    c, x, m = _pairs(rng, V, P)
    pool = rng.integers(0, V, KP).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    if tied:
        je, jl = j_fused_tied(jnp.asarray(emb_in), c, x, pool, m, lr, negw,
                              tile_pairs=TP, interpret=True)
        e, loss, n = fused_sgns_step_tied(_t(emb_in), _t(c), _t(x), _t(pool),
                                          _t(m), lr, negw, tile_pairs=TP)
        got, want = [e], [je]
    else:
        ji, jo, jl = j_fused(jnp.asarray(emb_in), jnp.asarray(emb_out), c, x,
                             pool, m, lr, negw, tile_pairs=TP, interpret=True)
        ei, eo, loss, n = fused_sgns_step(_t(emb_in), _t(emb_out), _t(c),
                                          _t(x), _t(pool), _t(m), lr, negw,
                                          tile_pairs=TP)
        got, want = [ei, eo], [ji, jo]
    assert float(n) == m.sum()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("tied", [False, True])
def test_fused_plain_all_masked_is_a_no_op(tied):
    rng = np.random.default_rng(7)
    V, d, KP, P, TP = 40, 16, 16, 200, 64
    emb = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    c, x, _ = _pairs(rng, V, P)
    m = np.zeros(P, np.float32)
    pool = rng.integers(0, V, KP).astype(np.int32)
    if tied:
        je, jl = j_fused_tied(jnp.asarray(emb), c, x, pool, m, 0.05, 0.3,
                              tile_pairs=TP, interpret=True)
        e, loss, n = fused_sgns_step_tied(_t(emb), _t(c), _t(x), _t(pool),
                                          _t(m), 0.05, 0.3, tile_pairs=TP)
        tabs = [e]
    else:
        ji, jo, jl = j_fused(jnp.asarray(emb), jnp.asarray(emb * 2), c, x,
                             pool, m, 0.05, 0.3, tile_pairs=TP,
                             interpret=True)
        ei, eo, loss, n = fused_sgns_step(_t(emb), _t(emb * 2), _t(c), _t(x),
                                          _t(pool), _t(m), 0.05, 0.3,
                                          tile_pairs=TP)
        tabs = [ei, eo / 2]
        np.testing.assert_array_equal(np.asarray(jo), emb * 2)
    # the JAX kernel's loss is its raw f32 sum minus the masked pairs'
    # constant, 256 * ln2 * (1 + 0.3 * 16) ~ 1029: 0 up to its rounding
    assert float(loss) == 0.0 and float(n) == 0.0
    assert abs(float(jl)) <= 1e-5 * 256 * np.log(2) * (1 + 0.3 * KP)
    for e in tabs:
        np.testing.assert_array_equal(e.numpy(), emb)


# ------------------------------------------------- per-pair step, tile math

@pytest.mark.parametrize("max_exp", [None, 6.0])
@pytest.mark.parametrize("tied", [False, True])
def test_sgns_sgd_step_matches_jax_and_oracle(tied, max_exp):
    rng = np.random.default_rng(3)
    V, d, P, K, lr = 30, 16, 64, 5, 0.05
    # rows of norm ~4: scores of spread ~4, so about an eighth of them
    # reach max_exp=6 and exercise the clamp
    emb_in = rng.normal(size=(V, d)).astype(np.float32)
    emb_out = emb_in if tied else rng.normal(size=(V, d)).astype(np.float32)
    c, x, m = _pairs(rng, V, P)
    negs = rng.integers(0, V, (P, K)).astype(np.int32)
    s = np.einsum("pd,pkd->pk", emb_in[c], emb_out[negs])
    assert (np.abs(s) >= 6.0).mean() > 0.05
    ji, jo, jl, jn = j_sgd_step(jnp.asarray(emb_in), jnp.asarray(emb_out), c,
                                x, negs, m, lr, tie_tables=tied,
                                max_exp=max_exp)
    ti = _t(emb_in)
    to = ti if tied else _t(emb_out)
    ei, eo, loss, n = sgns_sgd_step(ti, to, _t(c), _t(x), _t(negs), _t(m), lr,
                                    tie_tables=tied, max_exp=max_exp)
    assert float(n) == float(jn) == m.sum()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ei.numpy(), np.asarray(ji), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(eo.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)
    args = (c, x, negs, m.astype(bool), max_exp)
    if tied:
        ol, g = oracle.sgns_batch_grads_tied(emb_in.astype(np.float64), *args)
        want = [emb_in - lr * g]
    else:
        ol, gi, go = oracle.sgns_batch_grads(emb_in.astype(np.float64),
                                             emb_out.astype(np.float64), *args)
        want = [emb_in - lr * gi, emb_out - lr * go]
    np.testing.assert_allclose(float(loss), ol, rtol=1e-4)
    for a, b in zip([ei, eo], want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)


def test_block_grads_match_jax_and_oracle():
    rng = np.random.default_rng(4)
    V, d, B, KP = 40, 32, 96, 24
    emb_in = (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    emb_out = (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    c, x, m = _pairs(rng, V, B)
    pool = rng.integers(0, V, KP).astype(np.int32)
    negw = 5.0 / KP
    rows = (emb_in[c], emb_out[x], emb_out[pool])
    loss, n, grads = sgns_block_grads_from_rows(*map(_t, rows), _t(m), negw)
    jl, jn, jgrads = j_block_grads(*map(jnp.asarray, rows), m, negw)
    assert float(n) == float(jn) == m.sum()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    ol, oi, oo = oracle.sgns_shared_pool_grads(
        emb_in.astype(np.float64), emb_out.astype(np.float64), c, x, pool,
        m.astype(bool), negw)
    d_phi, d_cpos, d_cneg = (g.double() for g in grads)
    gi = torch.zeros((V, d), dtype=torch.float64).index_add_(
        0, _t(c).long(), d_phi)
    go = torch.zeros((V, d), dtype=torch.float64).index_add_(
        0, torch.cat([_t(x), _t(pool)]).long(), torch.cat([d_cpos, d_cneg]))
    np.testing.assert_allclose(float(loss), ol, rtol=1e-4)
    np.testing.assert_allclose(gi.numpy(), oi, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(go.numpy(), oo, rtol=1e-4, atol=1e-5)


# --------------------------------------------------- window pairs, keep probs

@pytest.mark.parametrize("W,sample", [(3, 0.0), (5, 1e-2), (10, 1e-3)])
def test_skipgram_pairs_bit_equal_with_jax_draws(W, sample):
    rng = np.random.default_rng(W)
    V, B, L = 50, 12, 23
    deg = rng.integers(0, 30, V)
    keep = subsample_keep_probs(deg, sample)
    np.testing.assert_array_equal(keep, j_keep_probs(deg, sample))
    walks = rng.integers(0, V, (B, L)).astype(np.int32)
    key = jax.random.key(W)
    jk = jnp.asarray(keep) if sample > 0 else None
    jc, jx, jm = j_skipgram_pairs(jnp.asarray(walks), W, key, jk)
    # the JAX function's own draws from its key
    k_red, k_keep = jax.random.split(key)
    b = jax.random.randint(k_red, (B, L, 1), 0, W, dtype=jnp.int32)
    u = jax.random.uniform(k_keep, (B, L), dtype=jnp.float32)
    c, x, m = skipgram_pairs(_t(walks), W, None,
                             _t(keep) if sample > 0 else None, b=_t(b),
                             u=_t(u))
    for a, j in zip((c, x, m), (jc, jx, jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    assert 0 < int(m.sum()) < m.numel()


def test_skipgram_pairs_draws_from_a_generator():
    walks = torch.arange(40, dtype=torch.int32).reshape(2, 20)
    keep = torch.full((40,), 0.5)
    a = skipgram_pairs(walks, 4, torch.Generator().manual_seed(1), keep)
    b = skipgram_pairs(walks, 4, torch.Generator().manual_seed(1), keep)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    c, x, m = a
    assert c.shape == x.shape == m.shape == (2, 20, 8)
    off = (x - c)[m]  # ids are positions here: offsets of trained pairs
    assert off.abs().max() <= 4 and (off != 0).all()


# ------------------------------------------------------------ loaders, karate

def test_karate_identical_to_jax():
    ds, jds = get_dataset("karate"), j_get_dataset("karate")
    assert ds.name == jds.name and ds.num_communities == jds.num_communities
    np.testing.assert_array_equal(ds.graph.indptr, jds.graph.indptr)
    np.testing.assert_array_equal(ds.graph.indices, jds.graph.indices)
    np.testing.assert_array_equal(ds.graph.node_names, jds.graph.node_names)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    np.testing.assert_array_equal(ds.single_labels, jds.single_labels)
    assert ds.graph.num_nodes == 34 and ds.graph.num_edges == 78


def test_edgelist_and_mat_loaders_identical(tmp_path):
    from scipy.io import savemat
    from scipy.sparse import random as sparse_random

    p = tmp_path / "g.edges"
    p.write_text("# c\nb a 1.0\nc a\n\nd c\nb d\n")
    for undirected in (True, False):
        g = loaders.load_edgelist(p, undirected=undirected)
        jg = jload.load_edgelist(p, undirected=undirected)
        np.testing.assert_array_equal(g.indptr, jg.indptr)
        np.testing.assert_array_equal(g.indices, jg.indices)
        np.testing.assert_array_equal(g.node_names, jg.node_names)
    back = tmp_path / "back.edges"
    loaders.save_edgelist(g, back)
    np.testing.assert_array_equal(loaders.load_edgelist(back).indices,
                                  jload.load_edgelist(back).indices)
    bad = tmp_path / "bad.edges"
    bad.write_text("1 2\n3\n")
    with pytest.raises(ValueError, match="malformed"):
        loaders.load_edgelist(bad)
    net = sparse_random(60, 60, density=0.1, format="csc", random_state=0)
    grp = sparse_random(60, 4, density=0.3, format="csc", random_state=1)
    mat = tmp_path / "g.mat"
    savemat(mat, {"network": net, "group": grp})
    g, jg = loaders.load_matfile(mat), jload.load_matfile(mat)
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    np.testing.assert_array_equal(loaders.load_mat_labels(mat),
                                  jload.load_mat_labels(mat))


# --------------------------------------------------- the micro-batched tier

@pytest.mark.parametrize("mode,tied,budget", [
    ("shared", False, 0.0), ("shared", True, 0.0), ("per_pair", False, 0.0),
    ("per_pair", True, 0.0), ("shared", False, 0.6), ("per_pair", False, 0.6),
])
def test_microbatched_matches_jax_trainer(mode, tied, budget, monkeypatch):
    """One macro batch of 300 pairs in micro-steps of 128 (the last one
    padded): K6/K7 with TP=64 and the pools JAX draws from
    ``split(key, n_micro)``, or the per-pair step with the same negatives.
    ``budget`` > 0 first compacts valid pairs to the front and keeps that
    fraction of the batch (``trainer/come.py:287-296``).  With shared
    negatives the single-device trainer runs the batch as one scan
    (``fused_sgns_scan``, the port of the JAX trainer's ``lax.scan``); the
    per-pair step loops."""
    scans = []
    for name in ("fused_sgns_scan", "fused_sgns_scan_tied"):
        fn = getattr(come_mod, name)
        monkeypatch.setattr(come_mod, name, lambda *a, _fn=fn, _n=name, **k:
                            scans.append(_n) or _fn(*a, **k))
    g = get_dataset("karate").graph
    over = dict(negative_mode=mode, shared_negatives=16, pallas="always",
                pallas_tile_pairs=64, batch_pairs=128, compact_budget=budget)
    jt = JTrainer(j_get_dataset("karate").graph,
                  j_get_config("karate").replace(**over))
    t = ComETrainer(g, get_config("karate").replace(**over), "cpu")
    rng = np.random.default_rng(11)
    V, d, P, K = g.num_nodes, 16, 300, 5
    ne = (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    ce = ne if tied else (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    c, x, m = _pairs(rng, V, P, masked=0.3)
    key = jax.random.key(5)
    n_micro = -(-int(P * (budget or 1.0)) // 128)
    negs = pools = None
    if mode == "per_pair":
        negs = rng.integers(0, V, (P, K)).astype(np.int32)
    else:
        keys = jax.random.split(key, n_micro)
        pools = np.stack([np.asarray(j_sample_alias(jt.accept, jt.alias, k,
                                                    (16,))) for k in keys])
    lr = 0.03
    jne, jce, jl, jn = jt._sgns_microbatched(
        jnp.asarray(ne), jnp.asarray(ce), c, x,
        None if negs is None else jnp.asarray(negs), m, lr, key,
        tie_tables=tied, compact=budget > 0,
    )
    tne = _t(ne)
    tce = tne if tied else _t(ce)
    loss, n = t._sgns_microbatched(
        tne, tce, _t(c), _t(x), None if negs is None else _t(negs), _t(m), lr,
        tie_tables=tied, compact=budget > 0,
        pools=None if pools is None else _t(pools),
    )
    assert float(n) == float(jn)
    assert float(n) == (m.sum() if budget == 0 else min(m.sum(), 180))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    np.testing.assert_allclose(tne.numpy(), np.asarray(jne), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tce.numpy(), np.asarray(jce), rtol=1e-4,
                               atol=1e-5)
    assert scans == ([] if mode == "per_pair" else
                     ["fused_sgns_scan_tied" if tied else "fused_sgns_scan"])


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("P,mb", [(90, 128), (200, 128), (830, 128)])
def test_scan_is_the_micro_step_loop_bit_for_bit(P, mb, tied):
    """``_sgns_microbatched`` through the scan (n_micro 1, 2 and 7, the last
    batch ragged: padded with masked pairs) against the loop of plain K6/K7
    micro-steps it replaces, each summing (loss, n_pairs) in order: the
    tables, the loss and the pair count bit for bit."""
    g = get_dataset("karate").graph
    cfg = get_config("karate").replace(
        negative_mode="shared", shared_negatives=16, pallas_tile_pairs=64,
        batch_pairs=mb)
    t = ComETrainer(g, cfg, "cpu")
    rng = np.random.default_rng(P)
    V, d = g.num_nodes, 16
    mb = min(mb, P)  # the trainer's micro-batch
    n_micro = -(-P // mb)
    ne = torch.tensor((rng.normal(size=(V, d)) * 0.3).astype(np.float32))
    ce = ne if tied else torch.tensor(
        (rng.normal(size=(V, d)) * 0.3).astype(np.float32))
    c, x, m = (torch.tensor(a) for a in _pairs(rng, V, P, masked=0.3))
    pools = torch.tensor(rng.integers(0, V, (n_micro, 16)))
    want = [t.clone() for t in ((ne,) if tied else (ne, ce))]
    pad = n_micro * mb - P
    cp, xp, mp = (torch.nn.functional.pad(a, (0, pad)) for a in (c, x, m))
    tot_loss, tot_pairs = torch.zeros(()), torch.zeros(())
    for i in range(n_micro):
        s = slice(i * mb, (i + 1) * mb)
        if tied:
            _, loss, n = fused_sgns_step_tied(want[0], cp[s], xp[s], pools[i],
                                              mp[s], 0.03, t.negw,
                                              tile_pairs=64)
        else:
            *_, loss, n = fused_sgns_step(*want, cp[s], xp[s], pools[i],
                                          mp[s], 0.03, t.negw, tile_pairs=64)
        tot_loss += loss
        tot_pairs += n
    loss, n = t._sgns_microbatched(ne, ce, c, x, None, m, 0.03,
                                   tie_tables=tied, pools=pools)
    assert torch.equal(loss, tot_loss) and torch.equal(n, tot_pairs)
    assert float(n) == float(m.sum())
    for a, b in zip((ne,) if tied else (ne, ce), want):
        assert torch.equal(a, b)


def test_o2_arc_epoch_wraps_the_tail_batch():
    """Per-arc O2 trains S batches of B arcs, the last wrapped to the
    epoch's first arcs (``jnp.resize``), each arc once per pass."""
    g = get_dataset("karate").graph
    cfg = get_config("karate").replace(batch_edges=100)
    t = ComETrainer(g, cfg, "cpu")
    assert not t.o2_star and t.o2_arc_plan() == (100, 2)
    seen = []
    step = t.o2_arc_step
    t.o2_arc_step = lambda s, d: seen.append((s, d)) or step(s, d)
    assert np.isfinite(t.o2_epoch())
    assert t.last_o2_pairs == 200 and t.words_seen == 200
    src = torch.cat([s for s, _ in seen]).numpy()
    dst = torch.cat([d for _, d in seen]).numpy()
    arcs = list(zip(*g.arcs()))
    assert sorted(zip(src[:156], dst[:156])) == sorted(arcs)
    np.testing.assert_array_equal(src[156:], src[:44])
    np.testing.assert_array_equal(dst[156:], dst[:44])


def test_karate_preset_trains_on_cpu():
    ds = get_dataset("karate")
    t = ComETrainer(ds.graph, get_config("karate"), "cpu")
    assert not t.o1_walk_kernel and not t.o2_star
    hist = t.train(ds.labels)
    for rec in hist:
        for k in ("gmm_ll", "o1_loss", "o2_loss", "o3_loss"):
            assert np.isfinite(rec[k])
        assert rec["o2_pairs"] == 156
    assert hist[-1]["nmi"] > 0.5, hist
