"""The ('data', 'model') layout of sharded ComE training.

Port of ``come_tpu/parallel/mesh.py`` over a ``torch.distributed`` process
group instead of a device array: one process per rank, each rank on its
own device (or, over gloo, several ranks sharing one card).  Rank r of a
(D, M) mesh is the worker (i_d, i_m) = divmod(r, M), the order of
``np.asarray(devices).reshape(data, model)`` (``come_tpu/parallel/
mesh.py:37``).  At M > 1 every rank makes two families of sub-groups, in
the same order on every rank: the data groups (the D ranks of one model
index, over which deltas are summed) and the model groups (the M ranks of
one data index, over which rows are exchanged).

Layout (V nodes padded to V_pad, a multiple of M; d dims; K communities):
  node_emb/ctx_emb [V_pad, d], pi [V_pad, K]
                          -> row-sharded over 'model': rank (i_d, i_m)
                             holds rows [i_m V_pad/M, (i_m+1) V_pad/M)
                             (:meth:`MeshLayout.row_block`); at M = 1 one
                             whole replica per rank
  centroid/cov [K, ...]   -> replicated
  walk starts / edge rows -> ``P(None, 'data')``: rank (i_d, i_m) keeps
                             column block i_d of a [S, B, ...] batch
                             (:meth:`MeshLayout.local`); the row-sharded
                             tiers slice that block again over 'model'
                             themselves, as the JAX tiers do inside
                             ``shard_map`` (``sharded.py:518-524``)
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh over a process group of ``data * model``
    ranks, this process being ``rank``.  ``group`` None with no process
    group initialised is the one-process mesh (1, 1), whose collectives are
    the identity.  ``data_group`` sums over 'data' (this rank's model index
    on every data row), ``model_group`` exchanges over 'model' (this rank's
    data row); at M = 1 the data group is ``group`` and there is no model
    group."""

    data: int
    model: int = 1
    rank: int = 0
    group: object = None
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def _subgroups(world: int, model: int, group):
    """(data group, model group) of every rank, made on every rank in the
    same order (all data groups, then all model groups), so no rank waits
    on a group another has not made."""
    data = world // model
    glob = (list(range(world)) if group is None else
            [dist.get_global_rank(group, r) for r in range(world)])
    data_sets = [[glob[i * model + m] for i in range(data)]
                 for m in range(model)]
    model_sets = [[glob[i * model + m] for m in range(model)]
                  for i in range(data)]
    dg, _ = dist.new_subgroups_by_enumeration(data_sets)
    mg, _ = dist.new_subgroups_by_enumeration(model_sets)
    return dg, mg


def make_mesh(data: int | None = None, model: int = 1, group=None) -> Mesh:
    """The (data, model) mesh of ``group`` (the default group when None):
    ``data * model`` must be its world size (1, rank 0, when no process
    group is initialised); ``data`` None takes world / model.  Raises
    ValueError when the sizes disagree.  At ``model > 1`` this is a
    collective: every rank of the group must call it."""
    if model < 1:
        raise ValueError(f"model axis {model} < 1")
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    elif group is not None:
        raise ValueError("a process group was given but torch.distributed "
                         "is not initialised")
    else:
        world, rank = 1, 0
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    if model == 1:
        return Mesh(data=data, model=1, rank=rank, group=group,
                    data_group=group)
    dg, mg = _subgroups(world, model, group)
    return Mesh(data=data, model=model, rank=rank, group=group,
                data_group=dg, model_group=mg)


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
    def data_index(self) -> int:
        return self.mesh.data_index

    @property
    def model_index(self) -> int:
        return self.mesh.model_index

    @property
    def group(self):
        return self.mesh.group

    @property
    def data_group(self):
        return self.mesh.data_group

    @property
    def model_group(self):
        return self.mesh.model_group

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of a batch sharded over 'data' along ``dim``
        (``P(None, 'data')`` for ``dim`` 1): the ``size / D`` entries from
        ``data_index * size / D``, as ``jax.device_put`` places a shard on
        the devices of that data row."""
        n = x.shape[dim]
        D = self.data_size
        if n % D:
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"data={D}")
        b = n // D
        return x.narrow(dim, self.data_index * b, b)

    def rows_per_shard(self, v: int) -> int:
        m = self.model_size
        if v % m != 0:
            raise ValueError(
                f"num_nodes {v} must be padded to a multiple of model={m}"
            )
        return v // m

    def row_block(self, v_pad: int) -> tuple[int, int]:
        """[start, stop) of the table rows this rank holds."""
        rows = self.rows_per_shard(v_pad)
        return self.model_index * rows, (self.model_index + 1) * rows
