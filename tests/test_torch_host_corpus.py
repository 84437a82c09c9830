"""Host-corpus training (``corpus="host"``) in the port against the JAX
package: the cases of ``tests/test_host_corpus.py:17-68`` with its floors,
the batches the port's host epoch trains against the JAX feeder's, and
``words_seen`` after one epoch against the JAX trainer's.  Every trainer's
feeder is closed at the end.
"""

import math

import numpy as np
import pytest
import torch

from come_tpu.config import get_config as j_get_config
from come_tpu.graphs import get_dataset as j_get_dataset
from come_tpu.native import HostWalkFeeder as JFeeder
from come_tpu.trainer import ComETrainer as JTrainer
from come_tpu_torch.config import ComEConfig, get_config
from come_tpu_torch.evaluation import nmi_score
from come_tpu_torch.graphs import get_dataset, sbm_graph
from come_tpu_torch.trainer import ComETrainer

torch.set_num_threads(2)

# tests/test_host_corpus.py:49-54, on the port's config
SBM_CFG = ComEConfig(
    dim=128, num_communities=4, walk_length=16, walks_per_node=2,
    window=4, negative_mode="shared", shared_negatives=128,
    pallas="always", corpus="host", batch_walks=64, batch_pairs=4096,
    outer_iters=0, pretrain_epochs=8, reg_covar=1e-2, gmm_max_iter=20,
)


def test_host_corpus_o1_trains_karate():
    ds = get_dataset("karate")
    cfg = get_config("karate").replace(
        corpus="host", outer_iters=0, pretrain_epochs=6
    )
    t = ComETrainer(ds.graph, cfg, "cpu")
    try:
        first = t.o1_epoch()
        losses = [t.o1_epoch() for _ in range(5)]
        assert losses[-1] < first
        t.fit_gmm()
        assert nmi_score(ds.labels, t.communities()) > 0.2
    finally:
        t.close()
    assert t._host_feeder is None


def test_host_corpus_full_loop():
    ds = get_dataset("karate")
    cfg = get_config("karate").replace(
        corpus="host", outer_iters=1, pretrain_epochs=2
    )
    t = ComETrainer(ds.graph, cfg, "cpu")
    try:
        hist = t.train(labels=ds.labels)
    finally:
        t.close()
    assert np.isfinite(hist[-1]["o1_loss"])
    assert hist[-1]["nmi"] > 0.3


def test_host_corpus_sends_every_batch_to_o1_step():
    """corpus='host' with the walk kernel's gates met: every host batch
    trains through ``o1_step`` (K1; its plain version on the CPU)."""
    g, labels = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
    t = ComETrainer(g, SBM_CFG, "cpu")
    assert t.o1_walk_kernel and not t.o1_gen
    calls = []
    step = t.o1_step
    t.o1_step = lambda *a: calls.append(a[0].shape) or step(*a)
    try:
        first = t.o1_epoch()
        losses = [t.o1_epoch() for _ in range(7)]
        assert np.isfinite(first) and losses[-1] < first
        t.fit_gmm()
        assert nmi_score(labels, t.communities()) > 0.5
    finally:
        t.close()
    per_epoch = math.ceil(512 * SBM_CFG.walks_per_node / 64)
    assert calls == [torch.Size([64, 16])] * (8 * per_epoch)


def _record(t, name):
    """Wrap the trainer's step ``name`` to record the walks it trains."""
    seen = []
    step = getattr(t, name)

    def spy(walks, *rest):
        seen.append(walks.numpy().copy())
        return step(walks, *rest)

    setattr(t, name, spy)
    return seen


@pytest.mark.parametrize("case", ["karate", "sbm"])
def test_host_epoch_trains_the_jax_feeders_batches(case):
    """Two epochs: the port trains exactly the batches the JAX feeder makes
    for the same graph, seed, batch size, restarts and start pool."""
    if case == "karate":
        ds = get_dataset("karate")
        g = ds.graph
        cfg = get_config("karate").replace(corpus="host", restart_prob=0.1,
                                           outer_iters=0, pretrain_epochs=2)
        step = "o1_pairs_step"
    else:
        g, _ = sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)
        cfg = SBM_CFG.replace(seed=3, pretrain_epochs=2)
        step = "o1_step"
    t = ComETrainer(g, cfg, "cpu")
    seen = _record(t, step)
    try:
        t.o1_epoch()
        t.o1_epoch()
    finally:
        t.close()
    B = min(cfg.batch_walks, len(t.walk_starts))
    n = 2 * math.ceil(len(t.walk_starts) * cfg.walks_per_node / B)
    assert len(seen) == n
    jf = JFeeder(g, batch=B, length=cfg.walk_length, seed=cfg.seed,
                 restart_prob=cfg.restart_prob, nodes=t.walk_starts)
    try:
        for got in seen:
            np.testing.assert_array_equal(got, next(jf))
    finally:
        jf.close()


def test_words_seen_after_one_epoch_equals_jax():
    cfg_kw = dict(corpus="host", outer_iters=1, pretrain_epochs=1)
    jt = JTrainer(j_get_dataset("karate").graph,
                  j_get_config("karate").replace(**cfg_kw))
    t = ComETrainer(get_dataset("karate").graph,
                    get_config("karate").replace(**cfg_kw), "cpu")
    try:
        jt.o1_epoch()
        t.o1_epoch()
    finally:
        jt._host_feeder.close()
        t.close()
    assert t.words_seen == float(jt.state.words_seen) > 0
    assert t.total_words == jt.total_words


def test_cli_corpus_host_runs():
    """``--corpus host`` on the CLI trains through the host feeder and
    closes it."""
    from come_tpu_torch.main import build_argparser, run

    t, hist = run(build_argparser().parse_args(
        ["--device", "cpu", "--corpus", "host", "--outer-iters", "1",
         "--pretrain-epochs", "1"]))
    assert t.cfg.corpus == "host" and t._host_feeder is None
    assert np.isfinite(hist[-1]["o1_loss"]) and hist[-1]["nmi"] > 0.3
