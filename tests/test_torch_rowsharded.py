"""The port's row-sharded tier (``ShardedComETrainer`` at model > 1,
``parallel/sharded.py``) against the JAX package's ``ShardedComETrainer``
on the 8-device CPU mesh; the port's ranks are gloo processes
(``tests/_torch_rs.py``):

* the tier names for the configs of ``tests/test_walk_kernel_trainer.py:
  11-34`` on SBM-512 and for karate, at (2, 2), (4, 2) and (1, 4), equal
  to JAX's, but for ``test_walk_kernel_rowsharded_vmem_gate``'s config
  (``:177-196``): the JAX 48 MiB compact-table gate is a VMEM budget that
  ROADMAP decision 1 does not port, so the port keeps
  ``walk-kernel-rowsharded`` there;
* SBM-512 at (2, 2) through the row-sharded walk tier and the paired O2
  tier (K1's and K5's plain versions): served 1.0, O1 and O2 losses
  falling, NMI > 0.5, model shards bit-identical across 'data', pad rows
  none (512 over 2), ``words_seen`` the global steps' words; two epochs
  with the row prefetch on stay finite;
* karate at (2, 2) and (1, 4), per-pair and shared negatives, at
  ``tests/test_parallel.py:77-104``'s floors (the second O1 epoch below
  the first, NMI > 0.3, pad rows untouched), and ``words_seen`` after one
  epoch equal to the JAX (2, 2) trainer's;
* ``corpus="host"`` at (2, 2): one feeder per data row, seeded from the
  data index, so both model ranks of a row train the JAX feeder's batches;
* the two-axis EM at (2, 2) from given responsibilities against the
  one-device EM (within 1e-5), and from the k-means init on every rank
  alike;
* checkpoints across a model axis: a round trip at (2, 2) whose next
  epoch is the saving trainer's bit for bit, the same files restored at
  (1, 4), (2, 1), (1, 1) and into ``ComETrainer`` with the same
  embeddings and communities, and cross-loads both ways with a JAX (2, 2)
  checkpoint (interleave 1) whose parameters come across exactly.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_dp import spawn
from _torch_rs import gmm, host_corpus, karate, sbm
from test_torch_gmm_sharded import _blobs
from come_tpu.config import ComEConfig as JConfig
from come_tpu.config import get_config as j_get_config
from come_tpu.graphs import get_dataset as j_get_dataset
from come_tpu.graphs import sbm_graph as j_sbm_graph
from come_tpu.native import HostWalkFeeder as JFeeder
from come_tpu.parallel import ShardedComETrainer as JSharded
from come_tpu.parallel import make_mesh as j_make_mesh
from come_tpu.parallel.exchange import interleave_permutation as j_interleave
from come_tpu_torch.config import ComEConfig, get_config
from come_tpu_torch.graphs import get_dataset, sbm_graph
from come_tpu_torch.losses.gmm import _kmeans_init, gmm_em_from_resp
from come_tpu_torch.parallel import Mesh, ShardedComETrainer
from come_tpu_torch.trainer import ComETrainer

# tests/test_walk_kernel_trainer.py:11-34
SBM_KW = dict(dim=128, num_communities=4, walk_length=16, walks_per_node=2,
              window=4, negative_mode="shared", shared_negatives=128,
              pallas="always", batch_walks=32, batch_edges=1024,
              batch_pairs=4096, lr=0.025, outer_iters=0, pretrain_epochs=8,
              gmm_max_iter=20, reg_covar=1e-2)
KARATE_KW = dict(outer_iters=1, pretrain_epochs=2, walks_per_node=4)
SHARED = dict(negative_mode="shared", shared_negatives=32)


def _jmesh(D, M):
    return j_make_mesh(data=D, model=M, devices=jax.devices()[:D * M])


def _tiers(D, M, graph, cfg, jgraph, jcfg):
    """(port's, JAX's) (o1, o2) tier names; the port's trainer is rank 0
    of a mesh with no process group (its collectives are the identity)."""
    t = ShardedComETrainer(graph, cfg, Mesh(data=D, model=M), "cpu")
    jt = JSharded(jgraph, jcfg, _jmesh(D, M))
    return (t.o1_tier(), t.o2_tier()), (jt.o1_tier(), jt.o2_tier())


@pytest.mark.parametrize("mesh,kw,want", [
    ((2, 2), {}, ("walk-kernel-rowsharded",
                  "walk-kernel-paired-rowsharded")),
    ((2, 2), dict(row_exchange="psum"), ("xla-psum", "xla-psum")),
    ((2, 2), dict(negative_mode="per_pair", negative=3),
     ("xla-per-pair", "xla-per-pair")),
    ((2, 2), dict(o2_mode="xla"), ("walk-kernel-rowsharded", "xla-a2a")),
    # 8 workers leave O2's envelope (2 * 1024 * 8 / 512 = 32 > 16)
    ((4, 2), {}, ("walk-kernel-rowsharded", "xla-a2a")),
], ids=["default", "psum", "per-pair", "o2-xla", "mesh-4x2"])
def test_sbm_tier_names_equal_jax(mesh, kw, want):
    g, _ = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    jg, _ = j_sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    got, jax_ = _tiers(*mesh, g, ComEConfig(**dict(SBM_KW, **kw)), jg,
                       JConfig(**dict(SBM_KW, **kw)))
    assert got == jax_ == want


@pytest.mark.parametrize("mesh,kw,want", [
    ((2, 2), {}, ("xla-per-pair", "xla-per-pair")),
    ((2, 2), SHARED, ("xla-a2a", "xla-a2a")),
    ((1, 4), SHARED, ("xla-a2a", "xla-a2a")),
    ((2, 2), dict(SHARED, row_exchange="psum"), ("xla-psum", "xla-psum")),
], ids=["per-pair", "shared", "shared-1x4", "shared-psum"])
def test_karate_tier_names_equal_jax(mesh, kw, want):
    got, jax_ = _tiers(*mesh, get_dataset("karate").graph,
                       get_config("karate").replace(**kw),
                       j_get_dataset("karate").graph,
                       j_get_config("karate").replace(**kw))
    assert got == jax_ == want


def test_jax_vmem_gate_is_not_a_port_gate():
    """``test_walk_kernel_rowsharded_vmem_gate``'s config: U = 32768 walks
    of 16 a worker, 256 MB a compact table, past JAX's 48 MiB VMEM budget,
    so JAX falls back to ``xla-a2a``.  The card's compact tables live in
    HBM, and decision 1 drops the gate: the port keeps the kernel tier."""
    kw = dict(row_exchange="a2a", batch_walks=131072, walks_per_node=512)
    g, _ = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    jg, _ = j_sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    got, jax_ = _tiers(2, 2, g, ComEConfig(**dict(SBM_KW, **kw)), jg,
                       JConfig(**dict(SBM_KW, **kw)))
    assert jax_[0] == "xla-a2a"
    assert got[0] == "walk-kernel-rowsharded"


# ------------------------------------------------------------ SBM-512


@pytest.fixture(scope="module")
def sbm_runs(tmp_path_factory):
    return spawn(sbm, 4, tmp_path_factory.mktemp("sbm"), 2, 2,
                 dict(SBM_KW, alpha=1.0))


def test_sbm_rowsharded_walk_tier_trains(sbm_runs):
    for r in sbm_runs:
        assert r["tiers"] == ("walk-kernel-rowsharded",
                              "walk-kernel-paired-rowsharded")
        assert r["o1_served"] == 1.0 and r["o2_served"] == 1.0
        assert np.isfinite(r["losses"][0]) and r["losses"][0] < 10.0
        assert r["losses"][-1] < r["losses"][0]
        assert r["nmi"] > 0.5, r["nmi"]
        assert r["o2"][-1] < r["o2"][0] and np.isfinite(r["o2"][-1])
        assert np.abs(r["emb"]).max() < 10.0 and r["emb"].shape == (512, 128)
        assert np.all(np.isfinite(r["overlap"]))
        ab = r["ab"]  # timed on fresh trainers, this one untouched
        assert ab["overlap_on_ms"] > 0 and ab["overlap_off_ms"] > 0
        assert ab["exchange_hidden_ms"] == (ab["overlap_off_ms"]
                                            - ab["overlap_on_ms"])
        # six epochs of 32 steps of 32 walks of 16
        assert r["words"] == 6 * 32 * 32 * 16
    for m in range(2):  # model shards bit-identical across 'data'
        for k in ("node_emb", "ctx_emb", "pi", "centroid"):
            np.testing.assert_array_equal(sbm_runs[m]["shard"][k],
                                          sbm_runs[2 + m]["shard"][k], k)
    np.testing.assert_array_equal(sbm_runs[0]["emb"], sbm_runs[3]["emb"])


def test_sbm_paired_o2_rowsharded_every_slot(sbm_runs):
    """Every slot of every paired step trained: S * B_r * 128 pairs with
    B_r rounded up to whole groups for each of the 4 workers, as JAX's
    ``_o2_rows_global`` plans it."""
    g, _ = j_sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    jt = JSharded(g, JConfig(**SBM_KW, alpha=1.0), _jmesh(2, 2))
    S, B_r = jt._o2_rows_global()
    for r in sbm_runs:
        assert r["o2_pairs"] == S * B_r * 128


# -------------------------------------------------------------- karate


@pytest.fixture(scope="module")
def kar(tmp_path_factory):
    """Karate at (2, 2) with a checkpoint, the JAX (2, 2) trainer with its
    own, and the restores at (1, 4) and (2, 1)."""
    tmp = tmp_path_factory.mktemp("karate")
    jt = JSharded(j_get_dataset("karate").graph,
                  j_get_config("karate").replace(**KARATE_KW), _jmesh(2, 2))
    jt.o1_epoch()
    jt.fit_gmm()
    jt.save_checkpoint(tmp / "jax_state")
    res = spawn(karate, 4, tmp, 2, 2, str(tmp), str(tmp / "jax_state"),
                None)
    other = {mesh: spawn(karate, mesh[0] * mesh[1], tmp, *mesh, None, None,
                         str(tmp / "state"), mesh == (1, 4))
             for mesh in ((1, 4), (2, 1))}
    return jt, res, other, tmp


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("mode", ["per_pair", "shared"])
def test_karate_trains_on_a_model_axis(kar, mesh, mode):
    _, res, other, _ = kar
    runs = res if mesh == (2, 2) else other[mesh]
    for r in (x[mode] for x in runs):
        assert np.isfinite(r["first"]) and r["second"] < r["first"]
        assert np.isfinite(r["hist"][-1]["o2_loss"])
        assert np.isfinite(r["hist"][-1]["o3_loss"])
        assert r["hist"][-1]["nmi"] > 0.3, r["hist"]
        assert r["v_pad"] == (36 if mesh == (1, 4) else 34)
        if (mesh, mode) == ((1, 4), "shared"):
            # 9 rows a shard and hubs: some ids overflow their owner's
            # bucket, which the served fraction reports (0.91 and 0.81)
            assert min(r["served"]) > 0.75
        else:
            assert r["served"] == (1.0, 1.0)
    if mesh == (1, 4):  # pad rows 34, 35 (shard 3) never updated
        assert np.all(runs[3][mode]["shard"][-2:] == 0)
    for r in runs[1:]:  # every rank gathers the same tables
        np.testing.assert_array_equal(r[mode]["views"]["emb"],
                                      runs[0][mode]["views"]["emb"])


def test_words_seen_after_one_epoch_equals_jax(kar):
    """``words_seen`` after one O1 epoch at (2, 2): the JAX (2, 2)
    trainer's (karate, per-pair; its GMM fit leaves the count)."""
    jt, res, _, _ = kar
    assert {r["per_pair"]["words_1"] for r in res} == {
        float(jt.state.words_seen)}


def test_host_fed_batches_on_a_model_axis(tmp_path):
    kw = dict(corpus="host", restart_prob=0.1, outer_iters=0,
              pretrain_epochs=1)
    res = spawn(host_corpus, 4, tmp_path, 2, 2, kw)
    cfg = get_config("karate").replace(**dict(KARATE_KW, **kw))
    g = j_get_dataset("karate").graph.permute(j_interleave(34, 2))
    for rank, r in enumerate(res):
        di = rank // 2
        ws = r["walk_starts"]
        B = min(cfg.batch_walks, len(ws) * cfg.walks_per_node)
        B = max(4, B // 4 * 4)
        nodes = np.array_split(ws, 2)[di]
        assert r["feeder"]["batch"] == B // 2
        np.testing.assert_array_equal(r["feeder"]["nodes"], nodes)
        jf = JFeeder(g, batch=B // 2, length=cfg.walk_length,
                     seed=cfg.seed + 7919 * di,
                     restart_prob=cfg.restart_prob, nodes=nodes)
        try:
            for got in r["seen"]:
                np.testing.assert_array_equal(got, next(jf))
        finally:
            jf.close()
    for m in range(2):
        np.testing.assert_array_equal(res[m]["shard"], res[2 + m]["shard"])


# ----------------------------------------------------------------- GMM


def test_two_axis_em_matches_one_device(tmp_path):
    """``tests/test_torch_gmm_sharded.py``'s same-init case (300 rows, K 3,
    d 8) at (2, 2): each model shard 150 rows, each data rank 75."""
    rng = np.random.default_rng(0)
    _blobs(rng)
    X, _ = _blobs(rng, n_per=100, K=3, d=8, spread=2.0)
    resp0 = _kmeans_init(torch.as_tensor(X), 3,
                         torch.Generator().manual_seed(5)).numpy()
    res = spawn(gmm, 4, tmp_path, 2, 2, X, 3, resp0)
    want = gmm_em_from_resp(torch.as_tensor(X), torch.as_tensor(resp0)[None],
                            1e-4, 30, 1e-3)
    for r, (a, b) in enumerate(res):
        for k in ("means", "chol"):
            np.testing.assert_allclose(a[k], want[k][0].numpy(), atol=1e-5)
        sl = slice(r % 2 * 150, (r % 2 + 1) * 150)
        np.testing.assert_allclose(a["resp"], want["resp"][0, sl].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(float(a["log_likelihood"]),
                                   float(want["log_likelihood"][0]),
                                   rtol=1e-5)
        for k in ("means", "chol", "log_likelihood"):
            np.testing.assert_array_equal(b[k], res[0][1][k])


# --------------------------------------------------------- checkpoints


def test_checkpoint_round_trip_on_a_model_axis(kar):
    _, res, _, tmp = kar
    assert all((tmp / f"state.proc{r}.npz").exists() for r in range(4))
    for r in res:
        for k, v in r["saved"].items():
            np.testing.assert_array_equal(r["restored_params"][k], v, k)
        assert r["restored_same"] == {"gen": True, "host_gen": True,
                                      "data_gen": True}
        assert r["resume"][0] == r["resume"][1]
        for k, v in r["resume_params"][0].items():
            np.testing.assert_array_equal(r["resume_params"][1][k], v, k)


@pytest.mark.parametrize("into", ["(1, 4)", "(2, 1)", "(1, 1)",
                                  "ComETrainer"])
def test_checkpoint_restores_on_another_mesh(kar, into):
    _, res, other, tmp = kar
    saved = res[0]["saved_views"]
    if into in ("(1, 4)", "(2, 1)"):
        for r in other[eval(into)]:
            assert r["restored"] == {"gen": False, "host_gen": False}
            np.testing.assert_array_equal(r["restored_views"]["emb"],
                                          saved["emb"])
            np.testing.assert_array_equal(r["restored_views"]["com"],
                                          saved["com"])
            assert r["restored_views"]["words"] == saved["words"]
            assert np.isfinite(r["after"])
        return
    ds = get_dataset("karate")
    cfg = get_config("karate").replace(**KARATE_KW)
    t = (ShardedComETrainer(ds.graph, cfg, Mesh(data=1), "cpu")
         if into == "(1, 1)" else ComETrainer(ds.graph, cfg, "cpu"))
    assert t.load_checkpoint(tmp / "state") == {"gen": False,
                                                "host_gen": False}
    np.testing.assert_array_equal(t.embeddings(), saved["emb"])
    np.testing.assert_array_equal(t.communities(), saved["com"])
    assert t.words_seen == saved["words"]
    assert np.isfinite(t.o1_epoch())


def test_checkpoint_cross_loads_with_jax_on_a_model_axis(kar):
    """JAX (2, 2) with its interleave -> port (2, 2), and port (2, 2) ->
    JAX (2, 2): embeddings, communities and words exactly."""
    jt, res, _, tmp = kar
    for r in res:
        np.testing.assert_array_equal(r["from_jax"]["emb"], jt.embeddings())
        np.testing.assert_array_equal(r["from_jax"]["com"],
                                      jt.communities())
        assert r["from_jax"]["words"] == float(jt.state.words_seen)
    back = JSharded(j_get_dataset("karate").graph,
                    j_get_config("karate").replace(**KARATE_KW),
                    _jmesh(2, 2))
    back.load_checkpoint(tmp / "state")
    saved = res[0]["saved_views"]
    np.testing.assert_array_equal(back.embeddings(), saved["emb"])
    np.testing.assert_array_equal(back.communities(), saved["com"])
    assert float(back.state.words_seen) == saved["words"]
