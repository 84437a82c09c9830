"""The port's host modules vs the JAX package: config, graphs, sampling,
model init, NMI, and the package's independence from JAX.

Equality checks are exact (same numpy code on the same seed); random draws
made with torch generators are checked by their distribution.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from come_tpu.config import PRESETS as JPRESETS
from come_tpu.config import ComEConfig as JConfig
from come_tpu.graphs.generators import sbm_graph as j_sbm
from come_tpu.models import init_params as j_init
from come_tpu.sampling.alias import build_alias_table as j_alias
from come_tpu.sampling.alias import unigram_weights as j_unigram
from come_tpu.sampling.stars import build_star_layout as j_star
from come_tpu_torch.config import PRESETS, ComEConfig
from come_tpu_torch.evaluation.metrics import nmi_score
from come_tpu_torch.graphs import get_dataset, sbm_graph
from come_tpu_torch.models.state import FIELDS, from_numpy, init_params
from come_tpu_torch.sampling import (
    build_alias_table,
    build_star_layout,
    random_walks,
    sample_alias,
    star_layout_stats,
    unigram_weights,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def test_presets_identical():
    assert dataclasses.asdict(ComEConfig()) == dataclasses.asdict(JConfig())
    assert sorted(PRESETS) == sorted(JPRESETS)
    for k in PRESETS:
        assert dataclasses.asdict(PRESETS[k]) == dataclasses.asdict(JPRESETS[k])


@pytest.mark.parametrize("seed", [0, 5])
def test_sbm_graph_identical(seed):
    kw = dict(p_in=0.1, p_out=0.01, seed=seed, avg_degree=12.0)
    g, lab = sbm_graph(300, 5, **kw)
    jg, jlab = j_sbm(300, 5, **kw)
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    np.testing.assert_array_equal(lab, jlab)
    for a, b in zip(g.edges_undirected(), jg.edges_undirected()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.degrees, jg.degrees)


def test_to_device_packs_ptr_deg():
    g, _ = sbm_graph(100, 3, seed=1, avg_degree=6.0)
    dc = g.to_device("cpu")
    assert dc.ptr_deg.dtype == torch.int32 and dc.ptr_deg.shape == (100, 2)
    np.testing.assert_array_equal(dc.ptr_deg[:, 0].numpy(), g.indptr[:-1])
    np.testing.assert_array_equal(dc.ptr_deg[:, 1].numpy(), g.degrees)
    np.testing.assert_array_equal(dc.indices.numpy(), g.indices)


def test_stand_in_registry():
    assert get_dataset("karate").graph.num_nodes == 34
    assert get_dataset("wikipedia").name == "wikipedia-synthetic"
    big = get_dataset("synthetic-10m")
    assert big.name == "synthetic-10m" and big.num_communities == 64
    assert big.graph.num_nodes == 500_000 and big.labels.shape == (500_000,)
    with pytest.raises(KeyError):
        get_dataset("nope")


def test_alias_tables_identical_and_marginal():
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 40, 200)
    w = unigram_weights(deg)
    np.testing.assert_array_equal(w, j_unigram(deg))
    acc, ali = build_alias_table(w)
    jacc, jali = j_alias(j_unigram(deg))
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(ali, jali)
    g = torch.Generator().manual_seed(0)
    n = 400_000
    draws = sample_alias(torch.tensor(acc), torch.tensor(ali), g, (n,))
    assert draws.dtype == torch.int32
    counts = np.bincount(draws.numpy(), minlength=200)
    expected = w * n
    live = expected > 0
    assert counts[~live].sum() == 0  # degree-0 nodes are never drawn
    chi2 = np.sum((counts[live] - expected[live]) ** 2 / expected[live])
    dof = live.sum() - 1
    assert chi2 < dof + 6 * np.sqrt(2 * dof)


@pytest.mark.parametrize("restart", [0.0, 0.3])
def test_walks_follow_arcs(restart):
    g, _ = sbm_graph(150, 3, seed=2, avg_degree=5.0)
    arcs = set(zip(*(a.tolist() for a in g.arcs())))
    starts = torch.arange(150, dtype=torch.int32).repeat(4)
    gen = torch.Generator().manual_seed(1)
    w = random_walks(g.to_device("cpu"), starts, 12, gen, restart_prob=restart)
    assert w.shape == (600, 12) and w.dtype == torch.int32
    np.testing.assert_array_equal(w[:, 0].numpy(), starts.numpy())
    w = w.numpy()
    deg = g.degrees
    for row in w:
        for a, b in zip(row[:-1], row[1:]):
            if deg[a] == 0:
                assert b == a  # isolated nodes stay put
            elif restart and b == row[0] and (a, b) not in arcs:
                continue  # a restart jump back to the origin
            else:
                assert (int(a), int(b)) in arcs


def test_walk_neighbor_choice_is_uniform():
    # a star: node 0's 8 neighbors must be chosen uniformly
    from come_tpu_torch.graphs import CSRGraph

    g = CSRGraph.from_arcs(np.zeros(8, int), np.arange(1, 9), num_nodes=9)
    gen = torch.Generator().manual_seed(0)
    w = random_walks(g.to_device("cpu"), torch.zeros(80_000, dtype=torch.int32),
                     2, gen)
    counts = np.bincount(w[:, 1].numpy(), minlength=9)[1:]
    assert counts.min() > 0.95 * 10_000 and counts.max() < 1.05 * 10_000


def test_walk_starts_skip_isolated_nodes():
    from come_tpu_torch.config import PRESETS
    from come_tpu_torch.graphs import CSRGraph
    from come_tpu_torch.trainer import ComETrainer

    g, _ = sbm_graph(300, 3, seed=3, avg_degree=10.0)
    src, dst = g.arcs()
    keep = (src >= 5) & (dst >= 5)  # nodes 0..4 become isolated
    g = CSRGraph.from_arcs(src[keep], dst[keep], num_nodes=300,
                           symmetrize=False)
    cfg = PRESETS["blogcatalog"].replace(
        num_communities=3, dim=16, walk_length=8, window=2, walks_per_node=2,
        shared_negatives=8,
    )
    t = ComETrainer(g, cfg, "cpu")
    starts = t._epoch_starts()
    assert int(starts.min()) >= 5
    walks = t._gen_epoch_walks(starts)
    assert int(walks.min()) >= 5


def test_star_layout_identical_including_fat_hub():
    rng = np.random.default_rng(4)
    g, _ = sbm_graph(400, 4, seed=4, avg_degree=20.0)
    u, v = g.edges_undirected()
    for args in [(u, v, 400), (rng.integers(0, 50, 900),
                               rng.integers(0, 50, 900), 50)]:
        s, m = build_star_layout(*args)
        js, jm = j_star(*args)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(m, jm)
    deg = 11000  # one hub far past the row width and the fan-out cap
    hu, hv = np.zeros(deg, np.int64), np.arange(1, deg + 1, dtype=np.int64)
    s, m = build_star_layout(hu, hv, deg + 1)
    js, jm = j_star(hu, hv, deg + 1)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(m, jm)
    st = star_layout_stats(s, m)
    assert st["arcs"] == deg and st["pairs"] == 2 * deg


def test_init_params_shapes_range_and_carry_across():
    V, d, K = 120, 32, 4
    gen = torch.Generator().manual_seed(0)
    p = init_params(V, d, K, gen, "cpu")
    jp = j_init(V, d, K, jax.random.key(0))
    for k in FIELDS:
        tv, jv = getattr(p, k), np.asarray(getattr(jp, k))
        assert tuple(tv.shape) == jv.shape and tv.dtype == torch.float32
    ne = p.node_emb.numpy()
    assert ne.min() >= -0.5 / d and ne.max() <= 0.5 / d
    assert abs(ne.mean()) < 0.05 / d and ne.std() > 0.25 / d
    assert float(p.ctx_emb.abs().sum()) == 0.0
    np.testing.assert_array_equal(p.pi.numpy(), np.asarray(jp.pi))
    np.testing.assert_array_equal(p.chol_cov.numpy(), np.asarray(jp.chol_cov))
    carried = from_numpy({k: np.asarray(getattr(jp, k)) for k in FIELDS}, "cpu")
    back = carried.to_numpy()
    for k in FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jp, k)))
    assert set(dict(carried.named_buffers())) == set(FIELDS)


def test_nmi_matches_sklearn():
    from sklearn.metrics import normalized_mutual_info_score

    rng = np.random.default_rng(5)
    for n, ka, kb in [(50, 3, 4), (500, 10, 7), (1000, 39, 39), (30, 1, 3)]:
        a = rng.integers(0, ka, n)
        b = np.where(rng.random(n) < 0.5, a, rng.integers(0, kb, n))
        assert abs(nmi_score(a, b) - normalized_mutual_info_score(a, b)) < 1e-12
    assert nmi_score([1, 1, 1], [0, 0, 0]) == normalized_mutual_info_score(
        [1, 1, 1], [0, 0, 0])


def test_port_imports_without_jax():
    """Every submodule imports with ``jax`` blocked in sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import come_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    come_tpu_torch.__path__, 'come_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'come_tpu' or k.startswith('come_tpu.')\n"
        "               for k in sys.modules), 'come_tpu imported'\n"
        "print(' '.join(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 20
    # the measurement and verification path
    assert {f"come_tpu_torch.{m}" for m in (
        "metrics", "metrics.meters", "metrics.profiling",
        "evaluation.oracle", "evaluation.parity", "ops.smem_probe",
        "ops.star_probe", "ops.floor_probe", "tools.probe_smem",
        "tools.probe_star", "tools.probe_star_floor")} <= names
