"""The port's data-parallel trainer (``parallel/sharded.py``) at world 2
(gloo ranks, ``tests/_torch_dp.py``) against the JAX package's
``ShardedComETrainer`` on a (2, 1) mesh:

* karate at ``tests/test_parallel.py:77-90``'s config (the second O1 epoch
  below the first, NMI > 0.3) and SBM-512 at
  ``tests/test_walk_kernel_trainer.py:60-82``'s (K1's plain version, six
  O1 epochs, loss falling, NMI > 0.5): the JAX trainer's tier names for
  the same config and mesh, bit-identical replicas on both ranks, the same
  tables from the same seed, and ``words_seen`` after one O1 epoch equal
  to the JAX sharded trainer's;
* ``corpus="host"``: every batch each rank trains equals the JAX
  package's feeder's (``come_tpu.native``) for that rank's slice of the
  walk starts and its seed;
* checkpoints: a round trip at world 2 (the parameters, ``words_seen`` and
  the generators restored, the next epoch bit for bit the saving
  trainer's), the same files restored at world 1 and into the
  single-device ``ComETrainer``, and cross-loads both ways with a JAX
  (2, 1) checkpoint (the parameters exactly);
* the CLI under ``torch.distributed.run --nproc-per-node 2`` with
  ``--device cpu --backend gloo --mesh 2,1``, and with four ranks and
  ``--mesh 2,2`` (the model axis; a mesh the world does not fill is
  refused).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_dp import host_corpus, karate, sbm, spawn
from come_tpu.config import ComEConfig as JConfig
from come_tpu.config import get_config as j_get_config
from come_tpu.graphs import get_dataset as j_get_dataset
from come_tpu.graphs import sbm_graph as j_sbm_graph
from come_tpu.native import HostWalkFeeder as JFeeder
from come_tpu.parallel import ShardedComETrainer as JSharded
from come_tpu.parallel import make_mesh as j_make_mesh
from come_tpu_torch.config import get_config
from come_tpu_torch.graphs import get_dataset
from come_tpu_torch.models.state import FIELDS
from come_tpu_torch.parallel import ShardedComETrainer, make_mesh
from come_tpu_torch.trainer import ComETrainer

REPO = Path(__file__).resolve().parents[1]
KARATE_KW = dict(outer_iters=1, pretrain_epochs=2, walks_per_node=4)
# tests/test_walk_kernel_trainer.py:11-34 with batch_walks=64 (:69)
SBM_KW = dict(dim=128, num_communities=4, walk_length=16, walks_per_node=2,
              window=4, negative_mode="shared", shared_negatives=128,
              pallas="always", batch_walks=64, batch_edges=1024,
              batch_pairs=4096, lr=0.025, outer_iters=0, pretrain_epochs=8,
              gmm_max_iter=20, reg_covar=1e-2)


def _jmesh():
    return j_make_mesh(data=2, model=1, devices=jax.devices()[:2])


def _equal_params(a: dict, b: dict):
    for k in FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def kar(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("karate")
    jt = JSharded(j_get_dataset("karate").graph,
                  j_get_config("karate").replace(**KARATE_KW), _jmesh())
    jt.o1_epoch()
    jt.fit_gmm()
    jt.save_checkpoint(tmp / "jax_state")
    res = spawn(karate, 2, tmp, KARATE_KW, str(tmp), str(tmp / "jax_state"))
    return jt, res, tmp


def test_karate_trains_at_world_2(kar):
    jt, res, _ = kar
    for r in res:
        assert np.isfinite(r["first"]) and r["second"] < r["first"]
        assert np.isfinite(r["hist"][-1]["o3_loss"])
        assert r["hist"][-1]["nmi"] > 0.3, r["hist"]
        assert r["tiers"] == (jt.o1_tier(), jt.o2_tier()) == (
            "xla-per-pair", "xla-per-pair")
    _equal_params(res[0]["params"], res[1]["params"])  # replicas
    _equal_params(res[0]["params"], res[0]["params_again"])  # same seed


def test_karate_shared_negatives_at_world_2(kar):
    """Shared negatives: O1 and O2 on the micro-batched tier (K6/K7's plain
    versions), ``xla-psum`` as the JAX trainer names it."""
    jt = JSharded(j_get_dataset("karate").graph, j_get_config(
        "karate").replace(**KARATE_KW, negative_mode="shared",
                          shared_negatives=32), _jmesh())
    res = [r["shared"] for r in kar[1]]
    for r in res:
        assert r["tiers"] == (jt.o1_tier(), jt.o2_tier()) == (
            "xla-psum", "xla-psum")
        assert np.isfinite(r["o1"]) and np.isfinite(r["o2"])
        assert r["o2_pairs"] == 2 * 78  # every arc once
    _equal_params(res[0]["params"], res[1]["params"])


def test_words_seen_after_one_epoch_equals_jax(kar):
    jt, res, _ = kar  # jt: one O1 epoch and a GMM fit
    assert res[0]["words_1"] == res[1]["words_1"] \
        == float(jt.state.words_seen) > 0


def test_checkpoint_round_trip_at_world_2(kar):
    _, res, tmp = kar
    assert (tmp / "state.proc0.npz").exists()
    assert (tmp / "state.proc1.npz").exists()
    for r in res:
        _equal_params(r["saved"], r["restored_params"])
        assert r["restored_words"] == r["saved_words"]
        assert r["restored"] == {"gen": True, "host_gen": True}
        # the generators restored: the next epoch is the saving trainer's
        assert r["resume"][0] == r["resume"][1]
        _equal_params(*r["resume_params"])


@pytest.mark.parametrize("into", ["world-1", "ComETrainer"])
def test_checkpoint_restores_at_another_world_size(kar, into):
    _, res, tmp = kar
    ds = get_dataset("karate")
    cfg = get_config("karate").replace(**KARATE_KW)
    if into == "world-1":
        t = ShardedComETrainer(ds.graph, cfg, make_mesh(), "cpu")
    else:
        t = ComETrainer(ds.graph, cfg, "cpu")
    assert t.load_checkpoint(tmp / "state") == {"gen": False,
                                                "host_gen": False}
    _equal_params(t.params.to_numpy(), res[0]["saved"])
    assert t.words_seen == res[0]["saved_words"]
    assert np.isfinite(t.o1_epoch())


def test_checkpoint_cross_loads_with_jax(kar):
    """JAX (2, 1) -> port at world 2, and port world 2 -> JAX (2, 1)."""
    jt, res, tmp = kar
    jp = jt.state.params
    for r in res:
        for k in FIELDS:
            np.testing.assert_array_equal(r["from_jax"][k],
                                          np.asarray(getattr(jp, k)), k)
        assert r["from_jax_words"] == float(jt.state.words_seen)
    back = JSharded(j_get_dataset("karate").graph,
                    j_get_config("karate").replace(**KARATE_KW), _jmesh())
    back.load_checkpoint(tmp / "state")
    np.testing.assert_array_equal(back.embeddings(),
                                  res[0]["saved"]["node_emb"])
    np.testing.assert_array_equal(back.communities(),
                                  res[0]["saved"]["pi"].argmax(1))
    assert float(back.state.words_seen) == res[0]["saved_words"]


@pytest.fixture(scope="module")
def sbm_runs(tmp_path_factory):
    return spawn(sbm, 2, tmp_path_factory.mktemp("sbm"), SBM_KW)


def test_sbm_walk_kernel_dp_trains(sbm_runs):
    g, _ = j_sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    jt = JSharded(g, JConfig(**SBM_KW), _jmesh())
    for r in sbm_runs:
        assert r["tiers"] == (jt.o1_tier(), jt.o2_tier()) == (
            "walk-kernel-dp", "star-o2-dp")
        assert np.isfinite(r["losses"][0])
        assert r["losses"][-1] < r["losses"][0]
        assert r["nmi"] > 0.5, r["nmi"]
        assert np.isfinite(r["o2"]) and r["o2_pairs"] > 0
    _equal_params(sbm_runs[0]["params"], sbm_runs[1]["params"])
    # six epochs of S steps of B_global = 64 walks of 16
    assert sbm_runs[0]["words"] == 6 * 16 * 64 * 16


def test_sbm_paired_o2_dp(sbm_runs):
    """The paired O2 tier at world 2 (``_o2_epoch_kernel``): the JAX
    trainer's name and plan (rows rounded up to 8 for each rank), every
    slot of every step trained, ``words_seen`` the global slots."""
    g, _ = j_sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    jt = JSharded(g, JConfig(**SBM_KW, o2_mode="paired"), _jmesh())
    S, B_r = jt._o2_rows_global()
    for r in sbm_runs:
        p = r["paired"]
        assert p["tier"] == jt.o2_tier() == "walk-kernel-paired-dp"
        assert p["plan"] == (B_r, S)
        assert p["o2_pairs"] == p["words"] == S * B_r * 128
        assert np.isfinite(p["o2"])
    _equal_params(sbm_runs[0]["paired"]["params"],
                  sbm_runs[1]["paired"]["params"])


def test_host_fed_batches_equal_the_jax_feeders(tmp_path):
    kw = dict(corpus="host", restart_prob=0.1, outer_iters=0,
              pretrain_epochs=2)
    res = spawn(host_corpus, 2, tmp_path, kw)
    cfg = get_config("karate").replace(**kw)
    g = j_get_dataset("karate").graph
    for rank, r in enumerate(res):
        ws = r["walk_starts"]
        B = min(cfg.batch_walks, len(ws) * cfg.walks_per_node)
        B = max(2, B // 2 * 2)
        nodes = np.array_split(ws, 2)[rank]
        assert r["feeder"]["batch"] == B // 2
        np.testing.assert_array_equal(r["feeder"]["nodes"], nodes)
        assert len(r["seen"]) == 2 * -(-len(ws) * cfg.walks_per_node // B)
        jf = JFeeder(g, batch=B // 2, length=cfg.walk_length,
                     seed=cfg.seed + 7919 * rank,
                     restart_prob=cfg.restart_prob, nodes=nodes)
        try:
            for got in r["seen"]:
                np.testing.assert_array_equal(got, next(jf))
        finally:
            jf.close()
    _equal_params(res[0]["params"], res[1]["params"])


def test_cli_under_torch_distributed_run():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "come_tpu_torch.main", "--device",
         "cpu", "--backend", "gloo", "--mesh", "2,1", "--dataset", "karate"],
        capture_output=True, text=True, env=env, timeout=240, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "mesh=(2,1) backend=gloo o1_tier=xla-per-pair" in out
    assert "o2_tier=xla-per-pair" in out
    assert out.count("final NMI:") == 1  # rank 0 alone prints
    nmi = float(out.split("final NMI:")[1].split()[0])
    assert nmi > 0.3


def test_cli_refuses_a_model_axis():
    """The CLI on a model axis: ``--mesh 2,2`` over four gloo ranks trains
    karate (rc 0, the JAX trainer's tier names, NMI > 0.3, rank 0 alone
    printing); a mesh that the world size does not fill is still
    refused."""
    from come_tpu_torch.main import build_argparser, run

    with pytest.raises(SystemExit, match="needs 4 processes"):
        run(build_argparser().parse_args(
            ["--device", "cpu", "--mesh", "2,2"]))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "come_tpu_torch.main", "--device",
         "cpu", "--backend", "gloo", "--mesh", "2,2", "--dataset", "karate"],
        capture_output=True, text=True, env=env, timeout=240, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "mesh=(2,2) backend=gloo o1_tier=xla-per-pair" in out
    assert "o2_tier=xla-per-pair" in out
    assert "o1_served=1.0000, o2_served=1.0000" in out
    assert out.count("final NMI:") == 1
    assert float(out.split("final NMI:")[1].split()[0]) > 0.3
