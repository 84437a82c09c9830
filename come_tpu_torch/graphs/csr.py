"""Immutable CSR graph container (numpy host side, torch device side).

Port of ``come_tpu/graphs/csr.py``.  The graph is two flat int32 arrays —
``indptr [V+1]`` and ``indices [E]`` — so a random-walk step is one flat
gather: ``indices[indptr[v] + r % degree[v]]``.  ``to_device`` returns the
torch tensors the walker reads, including the packed ``ptr_deg [V, 2]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Immutable CSR adjacency. Undirected graphs store both arc directions.

    Attributes:
      indptr:  int32 [V+1], row offsets into ``indices``.
      indices: int32 [E], flattened neighbor lists (E counts directed arcs).
      node_names: optional original node labels, index-aligned; ``None`` means
        node ids are already dense 0..V-1 ints.
    """

    indptr: np.ndarray
    indices: np.ndarray
    node_names: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "indptr", np.asarray(self.indptr, np.int32))
        object.__setattr__(self, "indices", np.asarray(self.indices, np.int32))
        if self.indptr.ndim != 1 or self.indices.ndim != 1:
            raise ValueError("indptr/indices must be 1-D")
        if self.indptr[0] != 0 or self.indptr[-1] != len(self.indices):
            raise ValueError("inconsistent indptr")

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_arcs(self) -> int:
        """Number of directed arcs stored (2x edges for undirected graphs)."""
        return len(self.indices)

    @property
    def num_edges(self) -> int:
        """Undirected edge count (arcs / 2)."""
        return self.num_arcs // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def arcs(self) -> tuple[np.ndarray, np.ndarray]:
        """All directed arcs as (src [E], dst [E])."""
        src = np.repeat(np.arange(self.num_nodes, dtype=np.int32), self.degrees)
        return src, self.indices

    def edges_undirected(self) -> tuple[np.ndarray, np.ndarray]:
        """Each undirected edge once, as (src, dst) with src < dst."""
        src, dst = self.arcs()
        keep = src < dst
        return src[keep], dst[keep]

    @staticmethod
    def from_arcs(
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: int | None = None,
        symmetrize: bool = True,
        remove_self_loops: bool = True,
        node_names: np.ndarray | None = None,
    ) -> "CSRGraph":
        """Build from arc lists; dedups; optionally adds reverse arcs."""
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        if num_nodes is None:
            num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if remove_self_loops:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        key = np.unique(src * np.int64(num_nodes) + dst)
        src = key // num_nodes
        dst = key % num_nodes
        indptr = np.zeros(num_nodes + 1, np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRGraph(indptr.astype(np.int32), dst.astype(np.int32), node_names)

    def permute(self, perm: np.ndarray) -> "CSRGraph":
        """Relabel nodes: old node ``i`` becomes ``perm[i]`` (``perm`` a
        permutation of 0..V-1).  The row-sharded trainer stripes
        community-sorted ids across its row shards with it
        (``parallel/exchange.py::interleave_permutation``); embeddings map
        back by ``emb[perm]``."""
        perm = np.asarray(perm, np.int64)
        src, dst = self.arcs()
        names = None
        if self.node_names is not None:
            names = np.empty_like(self.node_names)
            names[perm] = self.node_names
        return CSRGraph.from_arcs(
            perm[src], perm[dst], num_nodes=self.num_nodes,
            symmetrize=False, remove_self_loops=False, node_names=names,
        )

    def to_device(self, device) -> "DeviceCSR":
        """CSR arrays as int32 tensors on ``device``."""
        ptr_deg = np.stack([self.indptr[:-1], self.degrees], axis=1)
        return DeviceCSR(
            indptr=torch.as_tensor(self.indptr, device=device),
            indices=torch.as_tensor(self.indices, device=device),
            degrees=torch.as_tensor(self.degrees, device=device),
            ptr_deg=torch.as_tensor(ptr_deg.astype(np.int32), device=device),
        )


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """CSR tensors on one device; ``ptr_deg`` packs (indptr[v], degree[v])
    so a walk step reads both with one row gather."""

    indptr: torch.Tensor  # int32 [V+1]
    indices: torch.Tensor  # int32 [E]
    degrees: torch.Tensor  # int32 [V]
    ptr_deg: torch.Tensor  # int32 [V, 2]

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_arcs(self) -> int:
        return self.indices.shape[0]
