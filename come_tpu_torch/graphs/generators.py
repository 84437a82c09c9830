"""Synthetic graph generators with ground-truth communities.

Port of ``come_tpu/graphs/generators.py::sbm_graph``: the same numpy
``default_rng`` calls in the same order, so one seed gives the identical
graph in both packages.  The degree-corrected and power-law generators wait
for a later slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np

from come_tpu_torch.graphs.csr import CSRGraph


def sbm_graph(
    num_nodes: int,
    num_communities: int,
    p_in: float = 0.1,
    p_out: float = 0.005,
    seed: int = 0,
    avg_degree: float | None = None,
) -> tuple[CSRGraph, np.ndarray]:
    """Stochastic block model with equal-size blocks.

    If ``avg_degree`` is given, p_in/p_out are rescaled to hit it (keeping
    their ratio); edges are sampled per pair of blocks with binomial counts,
    so no O(V^2) memory is needed.
    """
    rng = np.random.default_rng(seed)
    labels = np.arange(num_nodes, dtype=np.int32) % num_communities
    rng.shuffle(labels)
    sizes = np.bincount(labels, minlength=num_communities)

    if avg_degree is not None:
        n_in = float(np.sum(sizes * (sizes - 1) / 2))
        n_out = num_nodes * (num_nodes - 1) / 2 - n_in
        exp_edges = p_in * n_in + p_out * n_out
        scale = (avg_degree * num_nodes / 2) / max(exp_edges, 1.0)
        p_in = min(p_in * scale, 1.0)
        p_out = min(p_out * scale, 1.0)

    members = [np.where(labels == k)[0] for k in range(num_communities)]
    src_all, dst_all = [], []
    for a in range(num_communities):
        for b in range(a, num_communities):
            na, nb = len(members[a]), len(members[b])
            if a == b:
                n_pairs = na * (na - 1) // 2
                p = p_in
            else:
                n_pairs = na * nb
                p = p_out
            if n_pairs == 0 or p <= 0:
                continue
            m = rng.binomial(n_pairs, p)
            if m == 0:
                continue
            pick = rng.choice(n_pairs, size=min(m, n_pairs), replace=False)
            if a == b:
                # linear index -> (i, j) strictly-upper-triangular
                i = (na - 2 - np.floor(
                    np.sqrt(-8 * pick + 4 * na * (na - 1) - 7) / 2 - 0.5
                )).astype(np.int64)
                j = (pick + i + 1 - na * (na - 1) // 2
                     + (na - i) * ((na - i) - 1) // 2).astype(np.int64)
                src_all.append(members[a][i])
                dst_all.append(members[a][j])
            else:
                src_all.append(members[a][pick // nb])
                dst_all.append(members[b][pick % nb])

    src = np.concatenate(src_all) if src_all else np.array([], np.int64)
    dst = np.concatenate(dst_all) if dst_all else np.array([], np.int64)
    g = CSRGraph.from_arcs(src, dst, num_nodes=num_nodes, symmetrize=True)
    return g, labels
