"""Heavy-tailed (power-law) degree stress tests of the port, after
``tests/test_heavy_tail.py``: the degree-corrected SBM (512 nodes, 4
communities, exponent 2.2, ``tests/test_heavy_tail.py:41-44``) whose hubs
dominate the walk stream, trained through the walk kernel (K1's plain
version on the CPU) on one device and through the row-sharded tier on a
(2, 2) mesh of gloo ranks (``tests/_torch_rs.py::heavy_tail``), with the
JAX tests' floors: a falling O1 loss, NMI > 0.5, and at the default bucket
slack 2.0 every pair served (1.0) on the power-law graph.  The generator
itself is held equal to the JAX package's in ``tests/test_torch_large_v.py``.
"""

import numpy as np
import torch

from _torch_dp import spawn
from _torch_rs import heavy_tail
from come_tpu_torch.config import ComEConfig
from come_tpu_torch.evaluation import nmi_score
from come_tpu_torch.graphs import dc_sbm_graph
from come_tpu_torch.trainer import ComETrainer

torch.set_num_threads(2)

# tests/test_heavy_tail.py:18-38
CFG = dict(dim=128, num_communities=4, walk_length=16, walks_per_node=2,
           window=4, negative_mode="shared", shared_negatives=128,
           pallas="always", batch_walks=32, batch_edges=1024,
           batch_pairs=4096, lr=0.025, outer_iters=0, pretrain_epochs=8,
           gmm_max_iter=20, reg_covar=1e-2)
GRAPH = dict(num_nodes=512, num_communities=4, avg_degree=16.0,
             exponent=2.2, assortativity=30.0, seed=3)


def test_torch_walk_kernel_trains_on_heavy_tail():
    """``test_walk_kernel_trains_on_heavy_tail``: hubs flood the walk
    stream and the shared pool comes from a very skewed unigram^0.75
    table; the loss still falls and the communities still separate."""
    g, labels = dc_sbm_graph(**GRAPH)
    t = ComETrainer(g, ComEConfig(**CFG), "cpu")
    assert t.o1_walk_kernel
    first = t.o1_epoch()
    losses = [t.o1_epoch() for _ in range(7)]
    assert np.isfinite(first) and losses[-1] < first
    t.fit_gmm()
    assert nmi_score(labels, t.communities()) > 0.5


def test_torch_rowsharded_heavy_tail_capacity(tmp_path):
    """``test_rowsharded_a2a_heavy_tail_capacity``: hub rows requested by
    many workers at once must fit the bucketed all-to-all's envelope (cap =
    U/M * slack): at the default slack every pair is served, the loss is
    finite and falls, NMI > 0.5, on every rank."""
    assert ComEConfig().a2a_capacity_slack == 2.0
    for r in spawn(heavy_tail, 4, tmp_path, 2, 2, CFG, GRAPH):
        assert r["tier"] == "walk-kernel-rowsharded"
        assert r["slack"] == 2.0
        assert np.isfinite(r["first"])
        assert r["served_first"] == 1.0 and r["served"] == 1.0
        assert r["losses"][-1] < r["first"]
        assert r["nmi"] > 0.5
