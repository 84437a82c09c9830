"""Visualization: 2-D embedding scatter with GMM ellipses, graph plots.

Port of ``come_tpu/evaluation/plots.py``: matplotlib PNGs coloured by
community, the embedding space projected by PCA (the default) with the
fitted GMM drawn as 1- and 2-sigma covariance ellipses, or by exact t-SNE
(``method="tsne"``, ``evaluation/tsne.py``, where the JAX package calls
sklearn's Barnes-Hut ``TSNE(2, random_state=seed, init="pca")``; no
ellipses, as there), and
the graph drawn in a spring layout.  The layout is this module's own Fruchterman-Reingold loop in
numpy (networkx's algorithm, not its draws), so only matplotlib is needed.
matplotlib is imported inside the functions, never when the module is;
:func:`require_matplotlib` lets a caller fail before a run, not after it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def require_matplotlib():
    """Import matplotlib (Agg backend) or raise ImportError saying what
    needs it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plots need matplotlib, which is not installed in this "
            "environment (pip install matplotlib, or drop --plot)") from e
    matplotlib.use("Agg")
    return matplotlib


def project_2d(emb: np.ndarray, method: str = "pca", seed: int = 0,
               device=None):
    """(points [V, 2], basis [d, 2]) of the embeddings
    (``come_tpu/evaluation/plots.py:17-29``): PCA of the centred points, or
    with ``method="tsne"`` exact t-SNE on ``device`` (default the card) and
    basis None; 2-D input is returned as it is.  ``seed`` is kept only for
    the JAX signature: the t-SNE starts from the PCA init and draws
    nothing at random, so it has no effect."""
    if emb.shape[1] == 2:
        return emb, np.eye(emb.shape[1])[:, :2]
    if method == "tsne":
        from come_tpu_torch.evaluation.tsne import tsne

        return tsne(emb, device=device), None
    if method != "pca":
        raise ValueError(f"method must be 'pca' or 'tsne', not {method!r}")
    emb0 = emb - emb.mean(0)
    _, _, vt = np.linalg.svd(emb0, full_matrices=False)
    basis = vt[:2].T
    return emb0 @ basis, basis


def node_space_plot_2d(
    embeddings: np.ndarray,
    labels: np.ndarray | None = None,
    centroids: np.ndarray | None = None,
    covariances: np.ndarray | None = None,
    path: str | Path | None = None,
    method: str = "pca",
    title: str = "",
):
    """Scatter the embedding space, projected by :func:`project_2d`; under
    PCA optionally draw GMM component ellipses.

    Returns the matplotlib Figure (also saved to ``path`` when given)."""
    require_matplotlib()
    import matplotlib.pyplot as plt
    from matplotlib.patches import Ellipse

    emb = np.asarray(embeddings)
    xy, basis = project_2d(emb, method)
    fig, ax = plt.subplots(figsize=(7, 6))
    c = np.asarray(labels) if labels is not None else None
    sc = ax.scatter(xy[:, 0], xy[:, 1], c=c, cmap="tab20", s=18, alpha=0.85)
    if labels is not None:
        fig.colorbar(sc, ax=ax, shrink=0.8)

    if centroids is not None and basis is not None:
        mu2 = (np.asarray(centroids) - emb.mean(0)) @ basis
        ax.scatter(mu2[:, 0], mu2[:, 1], marker="x", c="k", s=80)
        if covariances is not None:
            for k in range(len(mu2)):
                cov2 = basis.T @ np.asarray(covariances)[k] @ basis
                vals, vecs = np.linalg.eigh(cov2)
                ang = np.degrees(np.arctan2(vecs[1, 1], vecs[0, 1]))
                for nsig in (1.0, 2.0):
                    ax.add_patch(
                        Ellipse(
                            mu2[k],
                            2 * nsig * np.sqrt(max(vals[1], 0)),
                            2 * nsig * np.sqrt(max(vals[0], 0)),
                            angle=ang,
                            fill=False,
                            edgecolor="k",
                            alpha=0.4,
                        )
                    )
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


# the layout's steps (networkx's spring_layout default) and the rows of
# one repulsion chunk, [CHUNK, V, 2] floats at a time
ITERATIONS = 50
CHUNK = 1024


def spring_layout(graph, seed: int = 0) -> np.ndarray:
    """Fruchterman-Reingold positions [V, 2] scaled into [-1, 1]: repulsion
    ``k^2 / dist`` between every pair (in row chunks of ``CHUNK``),
    attraction ``dist^2 / k`` along each arc, k = 1 / sqrt(V), steps capped
    by a temperature that falls linearly from a tenth of the layout's
    width over ``ITERATIONS`` steps."""
    v = graph.num_nodes
    pos = np.random.default_rng(seed).random((v, 2))
    if v < 2:
        return np.zeros((v, 2))
    src, dst = graph.arcs()
    k = 1.0 / np.sqrt(v)
    t = 0.1 * float(np.ptp(pos, 0).max())
    dt = t / (ITERATIONS + 1)
    for _ in range(ITERATIONS):
        disp = np.zeros_like(pos)
        for lo in range(0, v, CHUNK):
            delta = pos[lo:lo + CHUNK, None, :] - pos[None, :, :]
            d2 = np.maximum((delta * delta).sum(-1), 1e-4)
            disp[lo:lo + CHUNK] = (delta * (k * k / d2)[..., None]).sum(1)
        delta = pos[src] - pos[dst]
        dist = np.maximum(np.sqrt((delta * delta).sum(-1)), 0.01)
        np.add.at(disp, src, -delta * (dist / k)[:, None])
        length = np.maximum(np.sqrt((disp * disp).sum(-1)), 0.01)
        pos += disp * (t / length)[:, None]
        t -= dt
    pos -= pos.mean(0)
    return pos / max(float(np.abs(pos).max()), 1e-12)


def graph_plot(
    graph,
    labels: np.ndarray | None = None,
    path: str | Path | None = None,
    seed: int = 0,
    title: str = "",
):
    """Spring-layout graph drawing coloured by community."""
    require_matplotlib()
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    pos = spring_layout(graph, seed=seed)
    src, dst = graph.edges_undirected()
    fig, ax = plt.subplots(figsize=(7, 6))
    ax.add_collection(LineCollection(
        np.stack([pos[src], pos[dst]], 1), colors="#bbbbbb", linewidths=0.5,
        zorder=1))
    ax.scatter(pos[:, 0], pos[:, 1], s=60, zorder=2,
               c=np.asarray(labels) if labels is not None else "C0",
               cmap="tab20" if labels is not None else None)
    ax.set_title(title)
    ax.axis("off")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
