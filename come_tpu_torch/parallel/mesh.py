"""The ('data', 'model') layout of data-parallel ComE training.

Port of ``come_tpu/parallel/mesh.py`` over a ``torch.distributed`` process
group instead of a device array: one process per rank, each rank on its
own device (or, over gloo, several ranks sharing one card).  ``data`` is
the group's world size.  The model axis (row-sharded tables) is not ported
yet: ``model > 1`` raises ``NotImplementedError`` (ROADMAP item 8b).

Layout (V nodes, d dims, K communities, D ranks, model 1):
  node_emb/ctx_emb [V, d], pi [V, K]  -> replicated, one copy per rank
  centroid/cov [K, ...]               -> replicated
  walk starts / edge rows             -> ``P(None, 'data')``: rank r keeps
                                         column block r of a [S, B, ...]
                                         batch (:meth:`MeshLayout.local`)
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

MODEL_AXIS_TODO = (
    "a model axis > 1 (row-sharded tables over all_to_all) is not ported "
    "yet: ROADMAP item 8b"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh over a process group: ``data`` ranks, this
    process being ``rank``.  ``group`` None with no process group
    initialised is the one-process mesh (1, 1), whose collectives are the
    identity."""

    data: int
    model: int = 1
    rank: int = 0
    group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(data: int | None = None, model: int = 1, group=None) -> Mesh:
    """The mesh of ``group`` (the default group when None): ``data`` is its
    world size (1, rank 0, when no process group is initialised).  Raises
    ValueError when ``data`` is given and differs, NotImplementedError for
    ``model > 1``."""
    if model != 1:
        raise NotImplementedError(MODEL_AXIS_TODO)
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    elif group is not None:
        raise ValueError("a process group was given but torch.distributed "
                         "is not initialised")
    else:
        world, rank = 1, 0
    if data is None:
        data = world
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    return Mesh(data=data, model=model, rank=rank, group=group)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Where each ComE tensor family lives on a :class:`Mesh`."""

    mesh: Mesh

    @property
    def data_size(self) -> int:
        return self.mesh.data

    @property
    def model_size(self) -> int:
        return self.mesh.model

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def group(self):
        return self.mesh.group

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of a batch sharded over 'data' along ``dim``
        (``P(None, 'data')`` for ``dim`` 1): the ``size / D`` entries from
        ``rank * size / D``, as ``jax.device_put`` places a shard on the
        rank-th device of the data axis."""
        n = x.shape[dim]
        D = self.data_size
        if n % D:
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"data={D}")
        b = n // D
        return x.narrow(dim, self.rank * b, b)

    def rows_per_shard(self, v: int) -> int:
        m = self.model_size
        if v % m != 0:
            raise ValueError(
                f"num_nodes {v} must be padded to a multiple of model={m}"
            )
        return v // m
