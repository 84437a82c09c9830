"""The port's plots: the PCA projection against the JAX package's, the
PNGs written, the spring layout, and ``--plot`` without matplotlib
refused before anything is trained."""

import sys

import numpy as np
import pytest

from come_tpu.evaluation.plots import _project_2d as j_project
from come_tpu_torch.graphs import get_dataset
from come_tpu_torch.evaluation.plots import (
    graph_plot,
    node_space_plot_2d,
    project_2d,
    spring_layout,
)
from come_tpu_torch.main import build_argparser, run


@pytest.mark.parametrize("d", [2, 16, 128])
def test_projection_matches_jax(d):
    emb = np.random.default_rng(d).normal(size=(200, d)).astype(np.float32)
    xy, basis = project_2d(emb)
    jxy, jbasis = j_project(emb)
    np.testing.assert_allclose(xy, jxy, atol=1e-5)
    np.testing.assert_allclose(basis, jbasis, atol=1e-5)


def test_pngs_are_written(tmp_path):
    ds = get_dataset("karate")
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(34, 16)).astype(np.float32)
    cov = np.stack([np.eye(16) * 0.5, np.eye(16)])
    node_space_plot_2d(emb, ds.labels, emb[:2], cov,
                       path=tmp_path / "space.png", title="t")
    graph_plot(ds.graph, ds.labels, path=tmp_path / "graph.png")
    for name in ("space.png", "graph.png"):
        data = (tmp_path / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 5000


def test_spring_layout_is_bounded_and_seeded():
    g = get_dataset("karate").graph
    a, b = spring_layout(g, seed=1), spring_layout(g, seed=1)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (34, 2) and np.isfinite(a).all()
    assert np.abs(a).max() == pytest.approx(1.0)
    # linked nodes end closer than the average pair
    src, dst = g.arcs()
    linked = np.linalg.norm(a[src] - a[dst], axis=1).mean()
    every = np.linalg.norm(a[:, None] - a[None], axis=-1).mean()
    assert linked < 0.8 * every


def test_plot_without_matplotlib_raises_before_training(monkeypatch,
                                                        tmp_path):
    from come_tpu_torch import graphs
    from come_tpu_torch.trainer import ComETrainer

    started = []
    monkeypatch.setattr(graphs, "get_dataset",
                        lambda *a: started.append("dataset"))
    monkeypatch.setattr(ComETrainer, "train",
                        lambda *a, **k: started.append("train"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        run(build_argparser().parse_args(
            ["--device", "cpu", "--plot", str(tmp_path / "p")]))
    assert started == []
    assert not (tmp_path / "p").exists()
