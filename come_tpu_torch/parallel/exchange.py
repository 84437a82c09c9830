"""Bucketed all-to-all row exchange for row-sharded embedding tables.

Port of ``come_tpu/parallel/exchange.py``.  The tables are row-sharded
over the model axis: model index i_m owns rows ``[i_m * rows_per, (i_m+1)
* rows_per)``.  A worker that needs rows sorts their ids by owner, sends
the requests with one all-to-all over its model group, the owners gather
their rows, and a second all-to-all returns them (:meth:`RowExchangePlan.
gather`).  Update rows ride the same buckets back to their owners, which
add them into a local delta (:meth:`RowExchangePlan.scatter_add`); the
caller sums those deltas over 'data'.

Buckets have a static capacity C, as in the JAX package (whose shapes must
be static): ids past an owner's C slots in one step are not served.  Their
rows gather as 0, their updates are dropped, and ``served`` (in the ids'
original order) says which ids were; the trainer's id interleave
(:func:`interleave_permutation`) and its 2x slack keep that rare.
``capacity = B`` makes the exchange exact.  Every tensor of a plan is
built as the JAX one is: a stable sort by owner, bucket starts by
``searchsorted``, slots past C dropped from the request, and indexing that
clamps where ``jnp`` clamps (the fill id ``v_pad`` of
:mod:`walk_exchange` belongs to no owner).  The collectives are
``parallel/collectives.py::all_to_all_`` over the model group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from come_tpu_torch.parallel.collectives import all_to_all_


@dataclasses.dataclass
class RowExchangePlan:
    """Bucketed routing for one set of row ids [B], or for G sets at once
    (a leading G dimension on every tensor; :meth:`step` takes one)."""

    order: torch.Tensor   # [B] stable argsort of owner
    sowner: torch.Tensor  # [B] owner of each sorted id (M for fill ids)
    pos: torch.Tensor     # [B] slot within the owner's bucket
    ok: torch.Tensor      # [B] bool, pos < capacity (sorted order)
    served: torch.Tensor  # [B] bool, in ORIGINAL order
    got: torch.Tensor     # [M, C] ids this shard must serve (or -1)
    rows_per: int
    capacity: int
    index: int            # this rank's model index
    group: object = None  # the model group

    def step(self, k: int) -> "RowExchangePlan":
        """The plan of set ``k`` of a batched plan."""
        return dataclasses.replace(
            self, order=self.order[k], sowner=self.sowner[k],
            pos=self.pos[k], ok=self.ok[k], served=self.served[k],
            got=self.got[k])

    def _local(self):
        """(local row of each requested id, whether it is a request)."""
        valid = self.got >= 0
        return self.got.long() - self.index * self.rows_per, valid

    def gather(self, table_shard: torch.Tensor) -> torch.Tensor:
        """Rows for the planned ids, [B, d] in their original order;
        unserved ids get zero rows."""
        lidx, valid = self._local()
        safe = lidx.clamp(0, self.rows_per - 1)
        rows = torch.where(valid[..., None], table_shard[safe], 0.0)
        rep = all_to_all_(torch.empty_like(rows), rows, self.group)
        M = rep.shape[0]
        posc = self.pos.clamp(0, self.capacity - 1)
        mine = torch.where(self.ok[:, None],
                           rep[self.sowner.clamp(max=M - 1), posc], 0.0)
        out = torch.empty_like(mine)
        out[self.order] = mine
        return out

    def scatter_add(self, delta_shard: torch.Tensor, upd: torch.Tensor
                    ) -> torch.Tensor:
        """Route update rows [B, d] back to their owners and add them into
        the local [rows_per, d] ``delta_shard`` (in place; returned).
        Unserved entries are dropped."""
        M, C = self.got.shape
        supd = torch.where(self.ok[:, None], upd[self.order], 0.0)
        buf = upd.new_zeros((M, C, upd.shape[-1]))
        keep = (self.sowner < M) & (self.pos < C)
        buf[self.sowner[keep], self.pos[keep]] = supd[keep]
        contrib = all_to_all_(torch.empty_like(buf), buf, self.group)
        lidx, valid = self._local()
        safe = torch.where(valid, lidx, 0)
        contrib = torch.where(valid[..., None], contrib, 0.0)
        return delta_shard.index_add_(0, safe.reshape(-1),
                                      contrib.reshape(M * C, -1))


def _route(idx: torch.Tensor, rows_per: int, capacity: int, M: int,
           batched: bool):
    """(order, sowner, pos, ok, served, request) of id sets ``idx``
    [G, B]: the JAX planner's arrays, the request [G, M, C] with -1 in
    empty slots.  An id of no owner (the fill ``v_pad``) takes the
    bucket start of owner M-1 in the one-set planner (``start[sowner]``
    clamps) and the int32 minimum in the batched one
    (``take_along_axis`` fills), so its ``pos`` wraps to ``i - 2^31``
    there: both are the JAX planners' values, and such ids never reach
    a request."""
    G, B = idx.shape
    dev = idx.device
    owner = idx // rows_per
    order = torch.argsort(owner, dim=1, stable=True)
    sowner = torch.gather(owner, 1, order)
    sidx = torch.gather(idx, 1, order)
    shards = torch.arange(M, device=dev).expand(G, M).contiguous()
    start = torch.searchsorted(sowner, shards)  # [G, M]
    i = torch.arange(B, device=dev)[None]
    pos = i - torch.gather(start, 1, sowner.clamp(max=M - 1))
    if batched:
        pos = torch.where(sowner < M, pos, i - 2**31)
    ok = pos < capacity
    req = torch.full((G, M, capacity), -1, dtype=torch.int32, device=dev)
    keep = (sowner < M) & (pos < capacity)
    gix = torch.arange(G, device=dev)[:, None].expand(G, B)
    req[gix[keep], sowner[keep], pos[keep]] = sidx[keep].to(torch.int32)
    served = torch.zeros((G, B), dtype=torch.bool, device=dev)
    served.scatter_(1, order, ok)
    return order, sowner, pos, ok, served, req


def _plans(idx: torch.Tensor, rows_per: int, capacity: int, index: int,
           size: int, group, batched: bool) -> RowExchangePlan:
    order, sowner, pos, ok, served, req = _route(idx.long(), rows_per,
                                                 capacity, size, batched)
    # split over M: [M, G, C] so block m goes to model index m
    req = req.transpose(0, 1).contiguous()
    got = all_to_all_(torch.empty_like(req), req, group)
    return RowExchangePlan(
        order=order, sowner=sowner, pos=pos, ok=ok, served=served,
        got=got.transpose(0, 1).contiguous(), rows_per=rows_per,
        capacity=capacity, index=index, group=group)


def make_exchange_plans_batched(idx: torch.Tensor, rows_per: int,
                                capacity: int, index: int, size: int,
                                group=None) -> RowExchangePlan:
    """Plan G exchanges with ONE all-to-all of their requests: ``idx`` int
    [G, B] (one id set a step), ``index`` and ``size`` this rank's model
    index and the model axis M, ``group`` the model group.  Ids do not
    depend on the parameters, so an epoch's requests all go at once, out
    of the training loop (``make_exchange_plans_batched``,
    ``come_tpu/parallel/exchange.py:137``)."""
    return _plans(idx, rows_per, capacity, index, size, group, True)


def make_exchange_plan(idx: torch.Tensor, rows_per: int, capacity: int,
                       index: int, size: int, group=None
                       ) -> RowExchangePlan:
    """Plan one exchange for the local row ids ``idx`` [B]
    (``make_exchange_plan``, ``come_tpu/parallel/exchange.py:103``).
    ``capacity``: slots per owner bucket; ``ceil(B / M * slack)`` with
    interleaved ids, or ``B`` for an exact exchange."""
    return _plans(idx[None], rows_per, capacity, index, size, group,
                  False).step(0)


def interleave_permutation(num_nodes: int, num_shards: int) -> np.ndarray:
    """Node relabelling that decorrelates contiguous row shards: int32
    ``perm`` with ``perm[old_id] = new_id``, ids reordered by ``old_id %
    num_shards`` (stable), so each contiguous shard of the relabelled
    table owns ids striped across the original order.  Community-sorted
    inputs otherwise put a walk's rows on one shard and overflow its
    bucket."""
    old = np.arange(num_nodes)
    order = np.argsort(old % num_shards, kind="stable")  # new -> old
    perm = np.empty(num_nodes, np.int32)
    perm[order] = old.astype(np.int32)
    return perm
