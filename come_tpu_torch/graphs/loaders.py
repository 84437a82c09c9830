"""Graph file loaders: adjacency-list, edge-list, MATLAB .mat.

Port of ``come_tpu/graphs/loaders.py`` (numpy; scipy for ``.mat``): the
same parsing and the same densification order, so a file gives the
identical CSR arrays and label rows in both packages.  Node labels in files
may be arbitrary ints or strings; they are densified to 0..V-1 with the
original labels kept in ``node_names``.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from come_tpu_torch.graphs.csr import CSRGraph


def _open(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _sort_labels(labels: np.ndarray) -> np.ndarray:
    """Numeric order when every label parses as an int, else lexicographic.

    Shared by the graph loaders and :func:`load_ground_truth` so dense node
    ids and label rows line up.
    """
    labels = np.unique(labels)
    try:
        return labels[np.argsort([int(x) for x in labels])]
    except (TypeError, ValueError):
        return labels


def _densify(src, dst):
    """Map raw labels -> dense ids. Returns (src_ids, dst_ids, names)."""
    labels_sorted = _sort_labels(np.concatenate([src, dst]))
    lookup = {l: i for i, l in enumerate(labels_sorted)}
    src_ids = np.fromiter((lookup[x] for x in src), np.int64, len(src))
    dst_ids = np.fromiter((lookup[x] for x in dst), np.int64, len(dst))
    return src_ids, dst_ids, np.asarray(labels_sorted)


def _records(path):
    """Whitespace-split non-empty, non-comment lines."""
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split()


def load_adjacencylist(path: str | Path, undirected: bool = True) -> CSRGraph:
    """Parse `node nbr nbr ...` lines (deepwalk .adjlist format)."""
    src, dst = [], []
    for parts in _records(path):
        src += [parts[0]] * (len(parts) - 1)
        dst += parts[1:]
    src, dst, names = _densify(np.array(src), np.array(dst))
    return CSRGraph.from_arcs(src, dst, symmetrize=undirected,
                              node_names=names)


def load_edgelist(path: str | Path, undirected: bool = True) -> CSRGraph:
    """Parse `u v` (optionally `u v w`; weight ignored) lines."""
    src, dst = [], []
    for parts in _records(path):
        if len(parts) < 2:
            raise ValueError(
                f"{path}: malformed edge line {' '.join(parts)!r} "
                "(need `u v`)"
            )
        src.append(parts[0])
        dst.append(parts[1])
    src, dst, names = _densify(np.array(src), np.array(dst))
    return CSRGraph.from_arcs(src, dst, symmetrize=undirected,
                              node_names=names)


def load_matfile(
    path: str | Path,
    variable_name: str = "network",
    undirected: bool = True,
) -> CSRGraph:
    """Load a scipy-sparse adjacency from a MATLAB .mat (BlogCatalog-family:
    ``network`` adjacency; labels via :func:`load_mat_labels`)."""
    from scipy.io import loadmat
    from scipy.sparse import issparse

    mat = loadmat(str(path))
    net = mat[variable_name]
    if not issparse(net):
        raise ValueError(f"{variable_name} in {path} is not a sparse matrix")
    coo = net.tocoo()
    return CSRGraph.from_arcs(
        coo.row.astype(np.int64),
        coo.col.astype(np.int64),
        num_nodes=net.shape[0],
        symmetrize=undirected,
    )


def load_mat_labels(path: str | Path, variable_name: str = "group") -> np.ndarray:
    """Multi-label ground truth [V, C] (0/1) from a .mat `group` matrix."""
    from scipy.io import loadmat
    from scipy.sparse import issparse

    grp = loadmat(str(path))[variable_name]
    if issparse(grp):
        return np.asarray(grp.todense()).astype(np.int32)
    return np.asarray(grp).astype(np.int32)


def load_ground_truth(path: str | Path) -> np.ndarray:
    """Per-node single community label file: `node label` per line.

    Returns int labels [V] ordered by dense node id (sorted raw label, the
    graph loaders' order).
    """
    nodes, labels = [], []
    for parts in _records(path):
        nodes.append(parts[0])
        labels.append(int(parts[1]))
    nodes = np.asarray(nodes)
    lookup = {n: i for i, n in enumerate(_sort_labels(nodes))}
    out = np.zeros(len(nodes), np.int32)
    for n, l in zip(nodes, labels):
        out[lookup[n]] = l
    return out


def save_edgelist(g: CSRGraph, path: str | Path) -> None:
    src, dst = g.edges_undirected()
    with open(path, "w") as f:
        for u, v in zip(src, dst):
            f.write(f"{u} {v}\n")
