"""Row-sharded (model axis) tier of the walk kernel: K1, K1b and K5 on
compact tables gathered per worker.

Port of ``come_tpu/parallel/walk_exchange.py:60-244``.  The tables stay
row-sharded over 'model' (each rank holds V_pad/M rows), and each of the
D*M workers materialises only the rows its macro step touches:

  1. ids     = the step's walk slots + its negative pools
  2. uq      = their sorted unique ids, padded with ``v_pad`` to the id
               count U (``jnp.unique(size=U, fill_value=v_pad)``), so the
               unique count never overflows
  3. gather  = the bucketed all-to-all row exchange (``exchange.py``)
  4. kernel  = ``ops/walk_sgns.py::walk_sgns_step`` (K1, K1b with
               ``mxu_bf16``, K5 with ``paired``) on the COMPACT [U, d]
               tables, walks and pools remapped to compact slots
               (``searchsorted``)
  5. scatter = the delta rows (new - gathered) ride the same buckets back
               to their owners; the owners' partial deltas are summed over
               'data' (one all-reduce of both tables)

Ids do not depend on the parameters, so steps 1-2 and the id half of step
3 run for every macro step of an epoch at once (:func:`plan_walk_macro_
steps`: one id all-to-all).  With ``overlap`` the rows of step k+1 are
gathered before step k's delta lands (:func:`prefetch_loop`), so they are
one step stale, as in the JAX tier; the delta is relative to the rows the
worker gathered, so the sum of deltas stays consistent.  In this eager
port the prefetch changes what is read, not when the copy runs: the
collectives wait on the current stream (an asynchronous prefetch under
NCCL is ROADMAP work), so the trainer leaves it off unless asked.

The compact tables are f32: the JAX row-sharded tier keeps f32 shards and
f32 compact tables, so K3 (bf16 working tables) is off this tier.  Bucket
overflow leaves those rows zero and drops their delta, which skips the
affected pairs for one step; the served fraction is returned.  The
unported ``banded_walk_step_rowsharded`` is the JAX package's banded XLA
tier, which ROADMAP decision 1 does not port: the walk kernel takes every
V on the card.
"""

from __future__ import annotations

import math

import torch

from come_tpu_torch.ops.walk_sgns import walk_sgns_step
from come_tpu_torch.parallel.collectives import all_reduce_
from come_tpu_torch.parallel.exchange import make_exchange_plans_batched


def prefetch_loop(plan, n_steps: int, gather, step, overlap: bool) -> None:
    """Run ``n_steps`` macro steps (``prefetch_scan``,
    ``walk_exchange.py:60-103``): ``plan(k)`` is step k's exchange plan,
    ``gather(plan)`` fetches a step's rows from the tables as they are,
    ``step(k, rows, plan)`` applies step k.  With ``overlap`` step k+1's
    rows are gathered before step k applies (one step stale).  The JAX
    scan's last prefetch, which re-gathers the last step's rows and
    discards them, is not made."""
    if not overlap:
        for k in range(n_steps):
            step(k, gather(plan(k)), plan(k))
        return
    rows = gather(plan(0))
    for k in range(n_steps):
        nxt = gather(plan(k + 1)) if k + 1 < n_steps else None
        step(k, rows, plan(k))
        rows = nxt


def unique_padded(ids: torch.Tensor, fill: int) -> torch.Tensor:
    """Each row's sorted unique values, padded with ``fill`` to the row's
    length: ``jax.vmap(lambda i: jnp.unique(i, size=U, fill_value=fill))``
    for ``ids`` [S, U]."""
    S, U = ids.shape
    s = torch.sort(ids, dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    slot = torch.cumsum(first, 1) - 1
    uq = torch.full_like(s, fill)
    rows = torch.arange(S, device=ids.device)[:, None].expand(S, U)
    uq[rows[first], slot[first]] = s[first]
    return uq


def plan_walk_macro_steps(walks_all: torch.Tensor, sneg_all: torch.Tensor,
                          rows_per: int, capacity_slack: float, index: int,
                          size: int, group=None):
    """The exchange plans of S macro steps with ONE id all-to-all
    (``walk_exchange.py:106-153``).

    ``walks_all`` [S, B_w, L] this worker's walks (or packed edge rows) and
    ``sneg_all`` [S, n_pools, KP] its pools, in global (padded) row ids;
    ``index``/``size``: this rank's model index and M; ``group`` the model
    group.  Returns (plans, rwalks, rneg, served): ``plans`` batched over
    S, ``rwalks``/``rneg`` remapped to compact slots (int32), ``served``
    [S] the fraction of each step's real unique ids that fit their
    owner's bucket (fill entries excluded)."""
    S = walks_all.shape[0]
    v_pad = rows_per * size
    w = walks_all.reshape(S, -1).long()
    n = sneg_all.reshape(S, -1).long()
    ids = torch.cat([w, n], 1)
    U = ids.shape[1]  # the unique count can never exceed this
    # the fill v_pad sorts after every real id and belongs to no shard
    uq = unique_padded(ids, v_pad)
    cap = max(1, int(math.ceil(U / size * capacity_slack)))
    plans = make_exchange_plans_batched(uq, rows_per, cap, index, size,
                                        group)
    rwalks = torch.searchsorted(uq, w).to(torch.int32).view(walks_all.shape)
    rneg = torch.searchsorted(uq, n).to(torch.int32).view(sneg_all.shape)
    real = uq < v_pad
    served = (plans.served & real).sum(1).float() / real.sum(1).clamp_min(
        1).float()
    return plans, rwalks, rneg, served


def fused_walk_step_prepped(node_shard, ctx_shard, rows_n, rows_c, plan,
                            rwalks, wrow, rneg, lr, negw, *, window: int,
                            pool_refresh: int = 1, mxu_bf16: bool = False,
                            paired: bool = False):
    """Kernel and delta routing for one planned macro step
    (``walk_exchange.py:156-209``).

    ``rows_n``/``rows_c`` [U, d]: the gathered compact rows (maybe one
    step stale); ``rwalks``, ``rneg``: walks and pools in compact slots;
    ``wrow``: the window draws (None with ``paired``).  The kernel runs on
    copies of the gathered rows; the deltas are relative to them.
    Returns (dn, dc, loss, n_pairs): this worker's partial deltas for the
    owned row shards (not yet summed over 'data') and its loss and pair
    count.

    ``paired`` is the O2 edge mode (K5) on the TIED table: pass the node
    shard and rows as ``node_shard``/``rows_n`` and None for the ctx
    pair; the kernel runs on two copies of the rows and ``dn`` holds the
    tied composition ``new_in + new_out - 2 * rows``, routed by one
    scatter (JAX scatters ``dn`` and ``dc`` and adds them: the same sum,
    rounded in another order, for half the exchange), ``dc`` is None."""
    new_n = rows_n.clone()
    new_c = (rows_n if paired else rows_c).clone()
    _, _, loss, npairs = walk_sgns_step(
        new_n, new_c, rwalks, wrow, rneg, lr, negw, window=window,
        pool_refresh=pool_refresh, mxu_bf16=mxu_bf16, paired=paired,
    )
    if paired:
        upd = new_n.add_(new_c).sub_(2.0 * rows_n)
        return plan.scatter_add(torch.zeros_like(node_shard), upd), None, \
            loss, npairs
    dn = plan.scatter_add(torch.zeros_like(node_shard), new_n.sub_(rows_n))
    dc = plan.scatter_add(torch.zeros_like(ctx_shard), new_c.sub_(rows_c))
    return dn, dc, loss, npairs


def apply_deltas_(shards, deltas, data_group=None) -> None:
    """``shard += sum over 'data' of delta`` for each pair, with one
    all-reduce of every delta (``ne + psum(dn, 'data')``)."""
    if len(deltas) == 1:
        shards[0].add_(all_reduce_(deltas[0], data_group))
        return
    buf = all_reduce_(torch.stack(deltas), data_group)
    for s, d in zip(shards, buf):
        s.add_(d)


def fused_walk_step_rowsharded(node_shard, ctx_shard, walks, wrow, sneg, lr,
                               negw, *, window: int, index: int, size: int,
                               capacity_slack: float = 2.0,
                               pool_refresh: int = 1, mxu_bf16: bool = False,
                               paired: bool = False, model_group=None,
                               data_group=None, group=None):
    """One self-contained macro step on row-sharded tables: plan, gather,
    kernel, scatter and the sum over 'data' (``walk_exchange.py:
    212-244``), the simple one-step form of the trainer's epoch loop.

    ``node_shard``/``ctx_shard`` [rows_per, d] f32: this rank's rows,
    updated in place (``ctx_shard`` None with ``paired``: K5 on the tied
    node table); ``walks`` [B_w, L] (or packed edge rows) and ``sneg``
    [n_pools, KP] in global ids; ``wrow`` the window draws.  Returns
    (loss, n_pairs, served): loss and pair count summed over the whole
    mesh (``group``), ``served`` this worker's fraction of real unique
    rows that fit their owner's bucket."""
    rows_per = node_shard.shape[0]
    plans, rwalks, rneg, served = plan_walk_macro_steps(
        walks[None], sneg[None], rows_per, capacity_slack, index, size,
        model_group)
    plan = plans.step(0)
    rows_n = plan.gather(node_shard)
    rows_c = None if paired else plan.gather(ctx_shard)
    dn, dc, loss, npairs = fused_walk_step_prepped(
        node_shard, ctx_shard, rows_n, rows_c, plan, rwalks[0],
        None if paired else wrow, rneg[0], lr, negw, window=window,
        pool_refresh=pool_refresh, mxu_bf16=mxu_bf16, paired=paired)
    if paired:
        apply_deltas_([node_shard], [dn], data_group)
    else:
        apply_deltas_([node_shard, ctx_shard], [dn, dc], data_group)
    st = all_reduce_(torch.stack([loss, npairs]), group)
    return st[0], st[1], float(served[0])
