"""The port's trainer: the O1 -> O2 -> GMM -> O3 chain against the JAX
package from identical carried-across state, a port-only end-to-end run,
and the configurations outside the slice.

Chain tolerance: tables rtol 1e-3 / atol 3e-5 (the kernel tests' bound:
f32 sums in another order, here compounded over four phases), losses rtol
1e-4 (O3 1e-3, after the EM), pair counts exact, GMM hard assignments
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.config import PRESETS as JPRESETS
from come_tpu.graphs.generators import sbm_graph as j_sbm
from come_tpu.losses import community as jcom
from come_tpu.losses import gmm as jgmm
from come_tpu.models import init_params as j_init
from come_tpu.ops.pallas_star_sgns import fused_star_sgns_step
from come_tpu.ops.pallas_walk_sgns import fused_walk_sgns_step
from come_tpu.trainer import ComETrainer as JTrainer
from come_tpu.trainer.come import _decayed_lr
from come_tpu_torch.config import PRESETS
from come_tpu_torch.graphs import sbm_graph
from come_tpu_torch.main import build_argparser, run
from come_tpu_torch.models.state import FIELDS, from_numpy
from come_tpu_torch.ops.walk_sgns import NWL
from come_tpu_torch.trainer import ComETrainer

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 3e-5

SMALL = dict(num_communities=4, dim=128, walk_length=20, window=3,
             shared_negatives=16, batch_walks=16, reg_covar=0.1,
             gmm_n_init=1, gmm_max_iter=20, pretrain_epochs=1, outer_iters=1)


def test_chain_matches_jax():
    _chain_matches_jax(128)


def test_chain_matches_jax_at_dim_256():
    """The chain at a width whose card path runs K1 and K2 in column slabs
    and G1 with its matrices in device memory."""
    _chain_matches_jax(256)


def _chain_matches_jax(dim):
    V, K = 256, 4
    g, labels = sbm_graph(V, K, p_in=0.1, p_out=0.005, seed=0, avg_degree=10)
    jg, _ = j_sbm(V, K, p_in=0.1, p_out=0.005, seed=0, avg_degree=10)
    small = dict(SMALL, dim=dim)
    cfg = PRESETS["blogcatalog"].replace(**small)
    jcfg = JPRESETS["blogcatalog"].replace(**small)
    t = ComETrainer(g, cfg, "cpu")
    jt = JTrainer(jg, jcfg)
    assert t.total_words == jt.total_words
    jp = j_init(V, cfg.dim, K, jax.random.key(3))
    t.params = from_numpy({k: np.asarray(getattr(jp, k)) for k in FIELDS},
                          "cpu")
    rng = np.random.default_rng(0)
    negw = cfg.negative / cfg.shared_negatives
    KP, W, L = cfg.shared_negatives, cfg.window, cfg.walk_length

    def lr(words):
        return float(_decayed_lr(jnp.float32(words), jt.total_words, cfg.lr,
                                 cfg.min_lr))

    # ---- one O1 macro step: 16 real walks (2 groups), full window
    starts = torch.as_tensor(rng.choice(t.walk_starts, 16).astype(np.int32))
    walks = t._gen_epoch_walks(starts.reshape(1, 16))[0]
    pools = rng.integers(0, V, (2, KP)).astype(np.int32)
    wrow = torch.full((2 * NWL,), W, dtype=torch.int32)
    l1, n1 = t.o1_step(walks, wrow, torch.as_tensor(pools))
    ne, ce, jl1, jn1 = fused_walk_sgns_step(
        jp.node_emb, jp.ctx_emb, jnp.asarray(walks.numpy()),
        jnp.asarray(pools), lr(0.0), negw, 0, window=W, interpret=True,
        reduced_window=False, pool_refresh=cfg.walk_pool_refresh,
    )
    words = 16.0 * L
    assert t.words_seen == words
    assert float(n1) == float(jn1)
    np.testing.assert_allclose(float(l1), float(jl1), rtol=1e-4)

    # ---- one O2 macro step: the whole shuffled star layout
    rps, steps = t.o2_plan()
    assert steps == 1
    js, jm = (np.asarray(a) for a in jt._star_layout())
    NR = js.shape[0]
    perm = rng.permutation(NR)
    ps, pm = t.o2_stream(torch.as_tensor(perm))
    jps = np.pad(js[perm], ((0, rps - NR), (0, 0)))
    jpm = np.pad(jm[perm], ((0, rps - NR), (0, 0)), constant_values=-2)
    np.testing.assert_array_equal(ps.numpy(), jps)
    np.testing.assert_array_equal(pm.numpy(), jpm)
    pools2 = rng.integers(0, V, (rps * 128 // NWL, KP)).astype(np.int32)
    l2, n2 = t.o2_step(ps.reshape(-1), pm.reshape(-1),
                       torch.as_tensor(pools2), float(jt._star_pairs))
    ne, jl2, jn2 = fused_star_sgns_step(
        ne, jnp.asarray(jps.reshape(-1)), jnp.asarray(jpm.reshape(-1)),
        jnp.asarray(pools2), lr(words) * cfg.alpha, negw, 0, interpret=True,
        pool_refresh=cfg.walk_pool_refresh,
    )
    words += float(jt._star_pairs)
    assert float(n2) == float(jn2) == 2.0 * jg.num_edges
    np.testing.assert_allclose(float(l2), float(jl2), rtol=1e-4)
    np.testing.assert_allclose(t.params.ctx_emb.numpy(), np.asarray(ce),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.params.node_emb.numpy(), np.asarray(ne),
                               rtol=RTOL, atol=ATOL)

    # ---- GMM fit from the same initial responsibilities
    noisy = np.where(rng.random(V) < 0.3, rng.integers(0, K, V), labels)
    resp0 = np.eye(K, dtype=np.float32)[noisy]
    ll = t.fit_gmm(resp0=torch.as_tensor(resp0))
    X = ne
    m, c, w = jgmm._m_step(X, jnp.asarray(resp0), cfg.reg_covar)
    m, c, w = jgmm._em_while_loop(
        m, c, w, lambda a, b, e: jgmm._e_step(X, a, b, e),
        lambda r: jgmm._m_step(X, r, cfg.reg_covar), cfg.gmm_max_iter,
        cfg.gmm_tol,
    )
    resp, jll = jgmm._e_step(X, m, c, w)
    eye = jnp.eye(cfg.dim)
    inv = jax.vmap(lambda Lc: jax.scipy.linalg.cho_solve((Lc, True), eye))(c)
    assert abs(ll - float(jll)) < 1e-3
    np.testing.assert_array_equal(t.communities(), np.asarray(resp).argmax(1))

    # ---- one O3 step
    l3 = t.o3_step()
    ne = jcom.community_sgd_step(ne, resp, m, inv, cfg.beta, lr(words),
                                 grad_clip=cfg.o3_grad_clip)
    jl3 = jcom.community_loss(ne, resp, m, c, inv, cfg.beta)
    np.testing.assert_allclose(float(l3), float(jl3), rtol=1e-3)
    np.testing.assert_allclose(t.params.node_emb.numpy(), np.asarray(ne),
                               rtol=RTOL, atol=ATOL)


def test_train_end_to_end_on_cpu():
    """The port alone on a clear 4-community SBM: finite losses, every
    phase timed, NMI at least 0.9 after three outer iterations."""
    g, labels = sbm_graph(512, 4, p_in=0.1, p_out=0.002, seed=0,
                          avg_degree=20)
    cfg = PRESETS["blogcatalog"].replace(
        num_communities=4, walk_length=20, window=3, walks_per_node=4,
        shared_negatives=64, pretrain_epochs=2, outer_iters=3, dim=32,
    )
    t = ComETrainer(g, cfg, "cpu")
    hist = t.train(labels)
    assert len(hist) == 3
    for rec in hist:
        for k in ("gmm_ll", "o1_loss", "o2_loss", "o3_loss"):
            assert np.isfinite(rec[k])
        for k in ("gmm_ms", "o1_ms", "o2_ms", "o3_ms"):
            assert rec[k] > 0
        assert rec["o2_pairs"] == 2 * g.num_edges
    assert hist[-1]["nmi"] >= 0.9
    assert t.embeddings().shape == (512, 32)
    assert np.isfinite(t.embeddings()).all()


@pytest.mark.parametrize("regen,fresh", [(0, [True, False, False]),
                                          (2, [True, False, True]),
                                          (1, [True, True, True])])
def test_walk_corpus_cache_cadence(regen, fresh):
    """walk_regen_epochs: 0 generates the corpus once, N every N epochs,
    1 every epoch (``trainer/come.py:712-729``)."""
    g, _ = sbm_graph(256, 4, seed=1, avg_degree=10)
    cfg = PRESETS["blogcatalog"].replace(
        num_communities=4, dim=16, walk_length=8, window=2, walks_per_node=1,
        shared_negatives=8, walk_regen_epochs=regen,
    )
    t = ComETrainer(g, cfg, "cpu")
    calls = []
    gen_walks = t._gen_epoch_walks
    t._gen_epoch_walks = lambda s: calls.append(1) or gen_walks(s)
    seen = []
    for _ in range(3):
        n = len(calls)
        assert np.isfinite(t.o1_epoch())
        seen.append(len(calls) > n)
    assert seen == fresh


@pytest.mark.parametrize("override", [
    dict(pallas="never"),
])
def test_outside_slice_raises(override):
    g, _ = sbm_graph(256, 4, seed=0, avg_degree=10)
    cfg = PRESETS["blogcatalog"].replace(num_communities=4, **override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ComETrainer(g, cfg, "cpu")


_STEPS = ("walk_sgns_step", "walk_sgns_gen_step", "star_sgns_step",
          "fused_sgns_step", "fused_sgns_step_tied", "fused_sgns_scan",
          "fused_sgns_scan_tied", "sgns_sgd_step")


def _step_name(name, kw):
    """A step's name with the kernel mode it was called in (+bf16, +paired)."""
    return (name + ("+paired" if kw.get("paired") else "")
            + ("+bf16" if kw.get("mxu_bf16") else ""))


@pytest.mark.parametrize("graph,override,o1,o2", [
    ("sbm256", {}, "walk_sgns_step", "star_sgns_step"),
    ("sbm256", dict(negative_mode="per_pair"), "sgns_sgd_step",
     "sgns_sgd_step"),
    ("sbm256", dict(down_sample=1e-3), "fused_sgns_scan", "star_sgns_step"),
    ("sbm256", dict(walk_length=160), "fused_sgns_scan", "star_sgns_step"),
    ("sbm256", dict(o2_mode="xla"), "walk_sgns_step", "fused_sgns_scan_tied"),
    ("sbm60", dict(walk_length=80, window=10), "fused_sgns_scan",
     "fused_sgns_scan_tied"),
    ("sbm60", dict(walk_length=80, window=10, o2_mode="star"),
     "fused_sgns_scan", "fused_sgns_scan_tied"),
    ("karate", dict(negative_mode="shared"), "fused_sgns_scan",
     "fused_sgns_scan_tied"),
    ("karate", dict(negative_mode="per_pair"), "sgns_sgd_step",
     "sgns_sgd_step"),
    ("sbm256", dict(o2_mode="paired"), "walk_sgns_step",
     "walk_sgns_step+paired"),
    ("sbm60", dict(o2_mode="paired", walk_length=80, window=10),
     "fused_sgns_scan", "fused_sgns_scan_tied"),
    ("sbm256", dict(walk_gen="kernel"), "walk_sgns_gen_step",
     "star_sgns_step"),
    ("sbm256", dict(walk_gen="kernel", restart_prob=0.1), "walk_sgns_step",
     "star_sgns_step"),
    ("sbm256", dict(walk_gen="kernel", walk_regen_epochs=0),
     "walk_sgns_step", "star_sgns_step"),
    ("sbm256", dict(walk_gen="kernel", down_sample=1e-3), "fused_sgns_scan",
     "star_sgns_step"),
    ("sbm256", dict(walk_kernel_bf16=True), "walk_sgns_step+bf16",
     "star_sgns_step+bf16"),
    ("sbm256", dict(walk_kernel_bf16=True, walk_gen="kernel",
                    o2_mode="paired"), "walk_sgns_gen_step+bf16",
     "walk_sgns_step+paired+bf16"),
    ("sbm256", dict(walk_kernel_bf16=True, o2_mode="xla"),
     "walk_sgns_step+bf16", "fused_sgns_scan_tied"),
])
def test_dispatch_follows_the_jax_trainer(monkeypatch, graph, override, o1,
                                          o2):
    """Each configuration trains one O1 and one O2 epoch through the step
    the JAX trainer picks on a TPU (``trainer/come.py:149-180``, ``:265-378``,
    ``:380-394``, ``:696-711``, ``:841-881``, ``:1090-1144``): the walk
    kernel K1 (K1b with bf16, K4 for in-kernel walks) or the micro-batched
    tier (K6, or the per-pair step), the star kernel K2 (K2b), the paired
    walk kernel K5, or per arc (K7, or the tied per-pair step).  On one
    device a macro batch of K6 (K7) micro-steps is one scan
    (``fused_sgns_scan``, ``_tied``: the JAX trainer's ``lax.scan``)."""
    import come_tpu_torch.trainer.come as tc
    from come_tpu_torch.graphs import get_dataset

    if graph == "karate":
        g = get_dataset("karate").graph
    else:
        g, _ = sbm_graph(int(graph[3:]), 4, seed=0, avg_degree=10)
    small = dict(num_communities=4, dim=16, walk_length=20, window=3,
                 walks_per_node=1, shared_negatives=16, batch_edges=512)
    cfg = PRESETS["blogcatalog"].replace(**{**small, **override})
    calls = []
    for name in _STEPS:
        fn = getattr(tc, name)
        monkeypatch.setattr(
            tc, name, lambda *a, _n=name, _f=fn, **k: calls.append(
                _step_name(_n, k)) or _f(*a, **k))
    if override.get("down_sample"):
        with pytest.warns(UserWarning, match="micro-batched tier"):
            t = ComETrainer(g, cfg, "cpu")
    else:
        t = ComETrainer(g, cfg, "cpu")
    assert np.isfinite(t.o1_epoch()) and t.last_o1_pairs > 0
    assert set(calls) == {o1}
    calls.clear()
    assert np.isfinite(t.o2_epoch()) and t.last_o2_pairs > 0
    assert set(calls) == {o2}
    assert np.isfinite(t.embeddings()).all()


@pytest.mark.parametrize("bf16", [False, True])
def test_paired_o2_step_matches_jax(bf16):
    """One paired O2 macro step (``_o2_epoch_kernel``'s body) from the same
    table, rows and pools: the port's ``o2_paired_step`` against
    ``fused_walk_sgns_step(paired=True)`` (interpret) composed as
    new_in + new_out - old."""
    V, K = 256, 4
    g, _ = sbm_graph(V, K, p_in=0.1, p_out=0.005, seed=0, avg_degree=10)
    cfg = PRESETS["blogcatalog"].replace(
        **SMALL, o2_mode="paired", batch_edges=1024, walk_pool_refresh=2,
        walk_kernel_bf16=bf16, alpha=0.5)
    t = ComETrainer(g, cfg, "cpu")
    assert t.o2_paired and not t.o2_star
    B_r, S = t.o2_paired_plan()
    e2 = g.num_edges
    assert (B_r, S) == (8, -(-e2 // 512))
    rng = np.random.default_rng(1)
    ne0 = (rng.normal(size=(V, cfg.dim)) * 0.1).astype(np.float32)
    t.params.node_emb.copy_(torch.as_tensor(ne0))
    u, v = g.edges_undirected()
    idx = rng.permutation(e2)[:B_r * 64]
    rows = np.stack([u[idx], v[idx]], 1).reshape(B_r, 128).astype(np.int32)
    pools = rng.integers(0, V, (1, cfg.shared_negatives)).astype(np.int32)
    lr = t.lr()
    loss, npairs = t.o2_paired_step(torch.as_tensor(rows),
                                    torch.as_tensor(pools))
    assert t.words_seen == B_r * 128
    new_in, new_out, jl, jn = fused_walk_sgns_step(
        jnp.asarray(ne0), jnp.asarray(ne0), jnp.asarray(rows),
        jnp.asarray(pools), lr * cfg.alpha, t.negw, 0, window=1,
        interpret=True, reduced_window=False, mxu_bf16=bf16,
        pool_refresh=cfg.walk_pool_refresh, paired=True,
    )
    assert float(npairs) == float(jn) == B_r * 128
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    np.testing.assert_allclose(t.params.node_emb.numpy(),
                               np.asarray(new_in + new_out - ne0),
                               rtol=RTOL, atol=ATOL)


def test_paired_epoch_trains_every_edge_in_both_directions():
    """S * B_r * 128 pairs per paired epoch: every undirected edge at
    least once each way, the tail wrapped to the epoch's first edges."""
    g, _ = sbm_graph(256, 4, seed=0, avg_degree=10)
    cfg = PRESETS["blogcatalog"].replace(
        **SMALL, o2_mode="paired", batch_edges=600)
    t = ComETrainer(g, cfg, "cpu")
    B_r, S = t.o2_paired_plan()
    assert B_r == 5 and S == -(-g.num_edges // 320) > 1
    w0 = t.words_seen
    assert np.isfinite(t.o2_epoch())
    # B_r = 5 rows wrap to one 8-row group per step, as jnp.resize does
    assert t.last_o2_pairs == S * 8 * 128
    assert t.words_seen - w0 == S * B_r * 128
    assert np.isfinite(t.embeddings()).all()


def test_gen_bits_draw_all_32_bits():
    """The in-kernel walks' bits cover the full 32-bit range: with only
    non-negative draws every hop would pick from the first half of its
    neighbour list."""
    g, _ = sbm_graph(256, 4, seed=0, avg_degree=10)
    t = ComETrainer(g, PRESETS["blogcatalog"].replace(
        **SMALL, walk_gen="kernel"), "cpu")
    assert t.o1_gen
    bits = t._gen_bits(1 << 16).numpy().view(np.uint32)
    for b in range(32):
        frac = ((bits >> b) & 1).mean()
        assert 0.47 < frac < 0.53, (b, frac)


def test_main_refuses_missing_cuda_and_unported_flags(tmp_path):
    """--device cuda without a card is refused.  Every flag of the JAX CLI
    is ported now, so a --resume of a missing file fails on the file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        run(build_argparser().parse_args(["--dataset", "wikipedia"]))
    with pytest.raises(FileNotFoundError):
        run(build_argparser().parse_args(
            ["--device", "cpu", "--resume", str(tmp_path / "a.npz")]))


def test_quality_runs_take_the_reference_configurations():
    """tools/quality.py's runs: the presets at full depth, and the
    reference bench's kernel configuration (bench.py:207-216) on the
    blogcatalog preset, which the trainer sends to K4 in its bf16 mode."""
    from come_tpu_torch.tools import quality

    class _DS:
        num_communities = 4

    bench = quality._config("bench-gen", _DS, 3)
    assert (bench.walk_kernel_bf16, bench.walk_pool_refresh,
            bench.batch_walks, bench.batch_edges, bench.walk_gen,
            bench.seed) == (True, 8, 2048, 524288, "kernel", 3)
    for name in ("blogcatalog", "synthetic-10m"):
        cfg = quality._config(name, _DS, 0)
        assert (cfg.pretrain_epochs, cfg.outer_iters) == (2, 5)
        assert cfg.num_communities == 4
    g, _ = sbm_graph(256, 4, seed=0, avg_degree=10)
    t = ComETrainer(g, bench.replace(**SMALL, walk_gen="kernel"), "cpu")
    assert t.o1_gen
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            quality.main(["--runs", "blogcatalog"])
