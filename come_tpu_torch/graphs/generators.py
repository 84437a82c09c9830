"""Synthetic graph generators with ground-truth communities.

Port of ``come_tpu/graphs/generators.py``: ``sbm_graph``, ``dc_sbm_graph``
and ``powerlaw_graph`` make the same numpy ``default_rng`` calls in the same
order, so one seed gives the identical graph (CSR arrays and labels) in both
packages.
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


def dc_sbm_graph(
    num_nodes: int,
    num_communities: int,
    avg_degree: float = 20.0,
    exponent: float = 2.5,
    assortativity: float = 20.0,
    seed: int = 0,
) -> tuple[CSRGraph, np.ndarray]:
    """Degree-corrected SBM: community structure with power-law degrees.

    Chung-Lu within the block structure: node i gets weight
    w_i = rank^{-1/(exponent-1)} (ranks shuffled within each block), the
    expected edge count between blocks a, b is proportional to W_a W_b,
    times ``assortativity`` when a == b, and endpoints are drawn in
    proportion to w within their block, so hubs emerge.  A node left
    without an edge is tied to a random peer of its community.
    """
    rng = np.random.default_rng(seed)
    labels = np.arange(num_nodes, dtype=np.int32) % num_communities
    rng.shuffle(labels)
    members = [np.where(labels == k)[0] for k in range(num_communities)]

    w = np.empty(num_nodes, np.float64)
    for mem in members:
        ranks = rng.permutation(len(mem)) + 1.0
        w[mem] = ranks ** (-1.0 / (exponent - 1.0))
    wsum = np.array([w[mem].sum() for mem in members])

    mix = np.outer(wsum, wsum)
    mix[np.diag_indices_from(mix)] *= assortativity
    target_edges = avg_degree * num_nodes / 2
    mix *= target_edges / np.triu(mix).sum()

    src_all, dst_all = [], []
    for a in range(num_communities):
        pa = w[members[a]] / w[members[a]].sum()
        for b in range(a, num_communities):
            m = rng.poisson(mix[a, b])
            if m == 0:
                continue
            pb = w[members[b]] / w[members[b]].sum()
            src_all.append(rng.choice(members[a], size=m, p=pa))
            dst_all.append(rng.choice(members[b], size=m, p=pb))
    src = np.concatenate(src_all) if src_all else np.array([], np.int64)
    dst = np.concatenate(dst_all) if dst_all else np.array([], np.int64)
    ns = src != dst  # from_arcs drops self-loops: they do not count
    touched = np.zeros(num_nodes, bool)
    touched[src[ns]] = True
    touched[dst[ns]] = True
    lone = np.where(~touched)[0]
    if len(lone):
        def mate(i):
            peers = members[labels[i]][members[labels[i]] != i]
            if len(peers) == 0:  # a one-node community: any other node
                return (i + 1) % num_nodes
            return rng.choice(peers)

        mates = np.array([mate(i) for i in lone])
        src = np.concatenate([src, lone])
        dst = np.concatenate([dst, mates])
    g = CSRGraph.from_arcs(src, dst, num_nodes=num_nodes, symmetrize=True)
    return g, labels


def powerlaw_graph(
    num_nodes: int,
    avg_degree: float = 20.0,
    exponent: float = 2.5,
    seed: int = 0,
) -> CSRGraph:
    """Chung-Lu power-law graph: avg_degree * num_nodes / 2 pairs whose
    endpoints are drawn with weight rank^{-1/(exponent-1)}, self-pairs
    dropped, arcs kept as drawn (not symmetrized, as the JAX package)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    w = ranks ** (-1.0 / (exponent - 1.0))
    w *= (avg_degree * num_nodes / 2) / w.sum()
    prob = w / w.sum()
    num_edges = int(avg_degree * num_nodes / 2)
    src = rng.choice(num_nodes, size=num_edges, p=prob)
    dst = rng.choice(num_nodes, size=num_edges, p=prob)
    keep = src != dst
    return CSRGraph.from_arcs(src[keep], dst[keep], num_nodes=num_nodes)
