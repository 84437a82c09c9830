"""The slot chains and the slot scatters alone: the CUDA kernels, their
plain versions and the wrappers that pick between them by device.

Port of the slot loop of ``come_tpu/ops/pallas_walk_sgns.py``'s walk kernel
(``:369-400``): each real slot's update written to its row, on bf16 tables
(the ``TABLES_BF16`` branch at ``:377``) in slot order with each element
rounded by ``_pack_row``, on f32 tables (``:395-397``) added; and, at an
R-block end on f32 tables, ``_apply_pool`` (``:405``), which the f32
scatter takes in the same launch.  And of the star kernel's
(``come_tpu/ops/pallas_star_sgns.py:186-195``: ``emb[v] = emb[v] +
dphi[t]`` slot by slot on the tied table, then at an R-block end
``_apply_pool``, ``:197-204``, draw by draw), which the star scatter and
the star block-end scatter take.  On the card each scatter is a pass of
the walk or star steps' recorded group loop (``csrc/walk_sgns.cu``: K3's
``walk_scatter_bf16_kernel``, the f32 ``walk_scatter_kernel`` and
``block_end_scatter_kernel``; ``csrc/star_sgns.cu``:
``star_scatter_kernel`` and ``star_block_end_scatter_kernel``; each one
owner a distinct row of the group, its slots in slot order, no atomics),
and once a step ``slot_chains_kernel`` sorts every group's real slots into
the chains the scatters follow (``pool_chains_kernel`` the pools',
``fold_chains_kernel`` which rows a block end writes through both;
``csrc/owned_writes.cuh``); here each runs alone on given buffers (C
entries in ``csrc/walk_sgns.cu`` and ``csrc/star_sgns.cu``), so a check can
hold it against its plain version bit for bit and time it.  The walk
scatters' plain versions are ``ops/walk_sgns.py``'s
:func:`walk_scatter_bf16_reference`, which ``walk_sgns_step_reference``
calls, and :func:`walk_scatter_f32_reference`; the star ones are
:func:`star_chains_reference` and :func:`star_scatter_reference` here
(``star_sgns_step_reference`` keeps its ``index_add_`` writes, which on
the CPU add in slot order too).
"""

from __future__ import annotations

import torch

from come_tpu_torch.ops import build
from come_tpu_torch.ops.pool_pass import pool_chains
from come_tpu_torch.ops.walk_sgns import (
    LP,
    M32,
    NWL,
    rmw_rows_f32,
    walk_scatter_bf16_reference,
    walk_scatter_f32_reference,
)
from come_tpu_torch.sampling.stars import PAD_META


def _chains(ids: torch.Tensor, real: torch.Tensor):
    """The chains of groups ``ids`` int64 [G, 1024] over their slots where
    ``real`` bool [G, 1024]: a stable sort of each group's real slots by
    id (the plain version of ``slot_chains_kernel``)."""
    G = ids.shape[0]
    info = torch.zeros((G, NWL, 2), dtype=torch.int64, device=ids.device)
    order = torch.full((G, NWL), -1, dtype=torch.int64, device=ids.device)
    for g in range(G):
        rg = torch.nonzero(real[g])[:, 0]
        og = rg[torch.sort(ids[g][rg], stable=True).indices]
        n = og.numel()
        order[g, :n] = og
        info[g, og, 0] = torch.arange(n, device=ids.device)
        _, counts = torch.unique_consecutive(ids[g][og], return_counts=True)
        heads = torch.cumsum(counts, 0) - counts
        info[g, og[heads], 1] = counts
    return info.to(torch.int32), order.to(torch.int32)


def slot_chains_reference(slots: torch.Tensor, L: int):
    """Plain version of :func:`slot_chains`."""
    ids = slots.long().reshape(-1, NWL)
    real = (torch.arange(NWL, device=ids.device) % LP < L).expand_as(ids)
    return _chains(ids, real)


def slot_chains(slots: torch.Tensor, L: int):
    """Each group's real slots sorted into its rows' chains, as the slot
    scatters read them: (info int32 [G, 1024, 2], order int32 [G, 1024])
    for ``slots`` int [G * 1024] (walk j of group g at g*1024 + j*128, L
    real positions a walk): order[g] the group's real slots (position < L)
    in the order of a stable sort of their ids (a row's slots together, in
    slot order), -1 past its 8 * L real slots; info[g, t] = (t's place in
    order[g], the row's slots at its first slot and 0 at the others);
    (0, 0) at padding slots.

    CPU tensors run the plain version; CUDA tensors launch
    ``slot_chains_kernel`` (one CTA a group) or raise (counted in
    ``slot_chains.launches``)."""
    slots = slots.reshape(-1)
    if slots.numel() % NWL or not 1 <= L <= LP:
        raise ValueError(f"slot_chains: {slots.numel()} slots are not whole "
                         f"groups of {NWL}, or L {L} outside 1..{LP}")
    if slots.device.type == "cpu":
        return slot_chains_reference(slots, L)
    if slots.device.type != "cuda":
        raise ValueError(f"no slot chains kernel for device {slots.device}")
    G = slots.numel() // NWL
    slots = slots.to(torch.int32).contiguous()
    chains = torch.empty((3 * G * NWL,), dtype=torch.int32,
                         device=slots.device)
    code = build.library().come_slot_chains(
        slots.data_ptr(), G, L, chains.data_ptr(),
        torch.cuda.current_stream(slots.device).cuda_stream)
    slot_chains.launches += 1
    build.check(code, "come_slot_chains")
    return (chains[:2 * G * NWL].view(G, NWL, 2),
            chains[2 * G * NWL:].view(G, NWL))


slot_chains.launches = 0


def walk_scatter_bf16(emb_in: torch.Tensor, emb_out: torch.Tensor,
                      slots: torch.Tensor, dphi: torch.Tensor,
                      dphin: torch.Tensor, dctx: torch.Tensor, lr: float, *,
                      L: int, group: int, sr_seed: int | None = None,
                      chains: tuple | None = None):
    """K3's slot writes of group ``group``, in place on ``emb_in`` and
    ``emb_out`` [V, d] bf16 (d even): for each real slot t (position < L)
    of ``slots`` int [1024] in slot order, ``emb_in[v] = round(f32(row) +
    f32((dphi[t] + dphin[t]) * -lr))`` and ``emb_out[v] = round(f32(row) +
    f32(dctx[t] * -lr))``, v = slots[t], from ``dphi``, ``dphin`` (the
    negative pass's part) and ``dctx`` f32 [1024, d]; rounded stochastically
    with ``sr_seed`` (:func:`walk_sgns.sr_bits`: low 16 bits for the node
    row, high 16 for the ctx row) or truncated without.  Returns (emb_in,
    emb_out).

    CPU tensors run the plain version; CUDA tensors launch
    ``walk_scatter_bf16_kernel`` on the group's chains (``chains``, as
    :func:`slot_chains` gives them for ``slots``, or made here by it) or
    raise (counted in ``walk_scatter_bf16.launches``)."""
    d = emb_in.shape[1]
    for t in (emb_in, emb_out):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or \
                t.shape[1] != d or d % 2:
            raise ValueError("walk_scatter_bf16: tables must be contiguous "
                             "bf16 [V, d] with an even d")
    for t in (dphi, dphin, dctx):
        if t.shape != (NWL, d) or t.dtype != torch.float32 or \
                t.device != emb_in.device:
            raise ValueError(f"walk_scatter_bf16: updates must be f32 "
                             f"[{NWL}, {d}] on {emb_in.device}")
    if slots.numel() != NWL or not 1 <= L <= LP:
        raise ValueError(f"walk_scatter_bf16: one group's {NWL} slots, "
                         f"L in 1..{LP}")
    if emb_in.device.type == "cpu":
        return walk_scatter_bf16_reference(emb_in, emb_out, slots, dphi,
                                           dctx, lr, L, group, sr_seed,
                                           dphin=dphin)
    if emb_in.device.type != "cuda":
        raise ValueError(f"no slot scatter kernel for device {emb_in.device}")
    info, order = slot_chains(slots, L) if chains is None else chains
    if info.shape != (1, NWL, 2) or order.data_ptr() != \
            info.data_ptr() + 8 * NWL:
        raise ValueError("walk_scatter_bf16: chains must be slot_chains' of "
                         "these slots")
    slots = slots.to(torch.int32).contiguous()
    sr = sr_seed is not None
    code = build.library().come_walk_scatter_bf16(
        emb_in.data_ptr(), emb_out.data_ptr(), slots.data_ptr(),
        dphi.contiguous().data_ptr(), dphin.contiguous().data_ptr(),
        dctx.contiguous().data_ptr(), info.data_ptr(), d, int(L),
        int(group), float(lr), int(sr), (int(sr_seed) & M32) if sr else 0,
        torch.cuda.current_stream(emb_in.device).cuda_stream)
    walk_scatter_bf16.launches += 1
    build.check(code, "come_walk_scatter_bf16")
    return emb_in, emb_out


walk_scatter_bf16.launches = 0


def fold_chains_reference(slots: torch.Tensor, L: int, pool: torch.Tensor):
    """Plain version of :func:`fold_chains`."""
    slots = slots.long().reshape(-1)
    return _fold(slots, (torch.arange(NWL, device=slots.device) % LP) < L,
                 pool)


def _fold(slots: torch.Tensor, real: torch.Tensor, pool: torch.Tensor):
    """The fold chains of one group's ``slots`` int64 [1024], real where
    ``real``, and its block's ``pool`` [KP] (the plain version of
    ``fold_chains_kernel``)."""
    ids = torch.sort(pool.long()).values
    at = torch.searchsorted(ids, slots).clamp_max(ids.numel() - 1)
    fold_slot = torch.where(real & (ids[at] == slots), at, -1)
    fold_draw = torch.isin(pool.long(), slots[real])
    return fold_slot.to(torch.int32), fold_draw.to(torch.int32)


def fold_chains(slots: torch.Tensor, L: int, pool: torch.Tensor, *,
                chains: tuple | None = None,
                pool_chains_of: tuple | None = None):
    """Which rows a group that ends an R-block writes through both its
    slots and its block's pool, as its f32 scatter (block_end_scatter_kernel)
    reads them: (fold_slot int32 [1024], fold_draw int32 [KP]) for the
    group's ``slots`` int [1024] (L real positions a walk) and ``pool`` int
    [KP]: fold_slot[t] = the place in the pool's chain (a stable sort of
    its ids) of the first draw of real slot t's row, -1 where the pool
    does not draw it and at padding slots; fold_draw[k] = 1 where draw k's
    row is among the real slots' rows, else 0.

    CPU tensors run the plain version; CUDA tensors launch
    ``fold_chains_kernel`` on the group's chains (``chains``, as
    :func:`slot_chains` gives them, and ``pool_chains_of``, as
    ``ops/pool_pass.py``'s ``pool_chains`` gives them; made here where not
    given) or raise (counted in ``fold_chains.launches``)."""
    if slots.numel() != NWL or not 1 <= L <= LP or pool.dim() != 1:
        raise ValueError(f"fold_chains: one group's {NWL} slots, L in "
                         f"1..{LP}, a pool [KP]")
    if slots.device.type == "cpu":
        return fold_chains_reference(slots, L, pool)
    if slots.device.type != "cuda":
        raise ValueError(f"no fold chains kernel for device {slots.device}")
    KP = pool.numel()
    slots = slots.to(torch.int32).contiguous()
    pool = pool.to(torch.int32).contiguous()
    info, _ = slot_chains(slots, L) if chains is None else chains
    pinfo, _ = pool_chains(pool) if pool_chains_of is None else \
        pool_chains_of
    fold = torch.empty((NWL + KP,), dtype=torch.int32, device=slots.device)
    code = build.library().come_fold_chains(
        slots.data_ptr(), info.data_ptr(), pool.data_ptr(), pinfo.data_ptr(),
        int(L), KP, fold.data_ptr(),
        torch.cuda.current_stream(slots.device).cuda_stream)
    fold_chains.launches += 1
    build.check(code, "come_fold_chains")
    return fold[:NWL], fold[NWL:]


fold_chains.launches = 0


def walk_scatter_f32(emb_in: torch.Tensor, emb_out: torch.Tensor,
                     slots: torch.Tensor, dphi: torch.Tensor,
                     dphin: torch.Tensor, dctx: torch.Tensor, lr: float, *,
                     L: int, pool: torch.Tensor | None = None,
                     dneg: torch.Tensor | None = None,
                     chains: tuple | None = None,
                     pool_chains_of: tuple | None = None,
                     fold: tuple | None = None):
    """The f32 slot writes of one group, in place on ``emb_in`` and
    ``emb_out`` [V, d] f32: for each distinct row v of the real slots t
    (position < L) of ``slots`` int [1024], the terms ``(dphi[t] +
    dphin[t]) * -lr`` and ``dctx[t] * -lr`` (f32 products) summed in
    float64 in slot order and added to ``emb_in[v]`` and ``emb_out[v]``
    with one rounding each, from ``dphi``, ``dphin`` (the negative pass's
    part) and ``dctx`` f32 [1024, d]; with ``pool`` int [KP] (a group that
    ends an R-block) then ``emb_out[pool[k]] += dneg[k] * -lr`` for k in
    draw order, from ``dneg`` f32 [KP, d].  Returns (emb_in, emb_out).

    CPU tensors run the plain version (:func:`walk_scatter_f32_reference`);
    CUDA tensors launch ``walk_scatter_kernel``, or with a pool
    ``block_end_scatter_kernel``, on the group's chains (``chains``, as
    :func:`slot_chains` gives them for ``slots``, ``pool_chains_of``, as
    ``ops/pool_pass.py``'s ``pool_chains`` gives them for ``pool``, and
    ``fold``, as :func:`fold_chains` gives them; made here where not given)
    or raise (counted in ``walk_scatter_f32.launches`` and
    ``.launches_block_end``)."""
    d = emb_in.shape[1]
    for t in (emb_in, emb_out):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.dim() != 2 or t.shape[1] != d:
            raise ValueError("walk_scatter_f32: tables must be contiguous "
                             "f32 [V, d]")
    for t in (dphi, dphin, dctx):
        if t.shape != (NWL, d) or t.dtype != torch.float32 or \
                t.device != emb_in.device:
            raise ValueError(f"walk_scatter_f32: updates must be f32 "
                             f"[{NWL}, {d}] on {emb_in.device}")
    if slots.numel() != NWL or not 1 <= L <= LP:
        raise ValueError(f"walk_scatter_f32: one group's {NWL} slots, "
                         f"L in 1..{LP}")
    if pool is not None and (
            pool.dim() != 1 or dneg is None or
            dneg.shape != (pool.numel(), d) or dneg.dtype != torch.float32
            or pool.device != emb_in.device or dneg.device != emb_in.device):
        raise ValueError(f"walk_scatter_f32: a pool [KP] takes dneg f32 "
                         f"[KP, {d}] on {emb_in.device}")
    if emb_in.device.type == "cpu":
        return walk_scatter_f32_reference(emb_in, emb_out, slots, dphi, dctx,
                                          lr, L, dphin=dphin, pool=pool,
                                          dneg=dneg)
    if emb_in.device.type != "cuda":
        raise ValueError(f"no slot scatter kernel for device {emb_in.device}")
    info, order = slot_chains(slots, L) if chains is None else chains
    if info.shape != (1, NWL, 2) or order.data_ptr() != \
            info.data_ptr() + 8 * NWL:
        raise ValueError("walk_scatter_f32: chains must be slot_chains' of "
                         "these slots")
    slots = slots.to(torch.int32).contiguous()
    KP, pool_p, dneg_p, pch_p, fold_p = 0, None, None, None, None
    if pool is not None:
        KP = pool.numel()
        pool = pool.to(torch.int32).contiguous()
        pch = pool_chains(pool) if pool_chains_of is None else pool_chains_of
        if pch[0].shape != (1, KP, 2) or pch[1].data_ptr() != \
                pch[0].data_ptr() + 8 * KP:
            raise ValueError("walk_scatter_f32: pool chains must be "
                             "pool_chains' of this pool")
        fold = fold_chains(slots, L, pool, chains=(info, order),
                           pool_chains_of=pch) if fold is None else fold
        if fold[0].numel() != NWL or fold[1].data_ptr() != \
                fold[0].data_ptr() + 4 * NWL:
            raise ValueError("walk_scatter_f32: fold chains must be "
                             "fold_chains' of these slots and pool")
        dneg = dneg.contiguous()
        pool_p, dneg_p, pch_p, fold_p = pool.data_ptr(), dneg.data_ptr(), \
            pch[0].data_ptr(), fold[0].data_ptr()
    code = build.library().come_walk_scatter_f32(
        emb_in.data_ptr(), emb_out.data_ptr(), slots.data_ptr(),
        dphi.contiguous().data_ptr(), dphin.contiguous().data_ptr(),
        dctx.contiguous().data_ptr(), info.data_ptr(), pool_p, dneg_p, pch_p,
        fold_p, d, int(L), KP, float(lr),
        torch.cuda.current_stream(emb_in.device).cuda_stream)
    if pool is None:
        walk_scatter_f32.launches += 1
    else:
        walk_scatter_f32.launches_block_end += 1
    build.check(code, "come_walk_scatter_f32")
    return emb_in, emb_out


walk_scatter_f32.launches = 0
walk_scatter_f32.launches_block_end = 0


def _star_real(meta: torch.Tensor) -> torch.Tensor:
    """A star layout's real slots: meta is not PAD_META (pads carry node 0
    and belong to no chain)."""
    return meta != PAD_META


def star_chains_reference(slots: torch.Tensor, meta: torch.Tensor):
    """Plain version of :func:`star_chains`: the stable sort of each
    group's real slots by row."""
    ids = slots.long().reshape(-1, NWL)
    return _chains(ids, _star_real(meta.reshape(-1, NWL)))


def star_chains(slots: torch.Tensor, meta: torch.Tensor):
    """Each group's real slots of a star layout sorted into its rows'
    chains, as the star scatters read them: (info int32 [G, 1024, 2],
    order int32 [G, 1024]) for ``slots`` and ``meta`` int [G * 1024] (meta
    -2 at pads): order[g] the group's real slots (meta != -2) in the order
    of a stable sort of their ids (a row's slots together, in slot order),
    -1 past them; info[g, t] = (t's place in order[g], the row's slots at
    its first slot and 0 at the others); (0, 0) at pads, which belong to no
    chain.

    CPU tensors run the plain version; CUDA tensors launch
    ``slot_chains_kernel`` on the meta (one CTA a group) or raise (counted
    in ``star_chains.launches``)."""
    slots, meta = slots.reshape(-1), meta.reshape(-1)
    if slots.numel() % NWL or meta.shape != slots.shape:
        raise ValueError(f"star_chains: {slots.numel()} slots and "
                         f"{meta.numel()} meta are not whole groups of {NWL}")
    if slots.device.type == "cpu":
        return star_chains_reference(slots, meta)
    if slots.device.type != "cuda":
        raise ValueError(f"no star chains kernel for device {slots.device}")
    G = slots.numel() // NWL
    slots = slots.to(torch.int32).contiguous()
    meta = meta.to(torch.int32).contiguous()
    chains = torch.empty((3 * G * NWL,), dtype=torch.int32,
                         device=slots.device)
    code = build.library().come_star_chains(
        slots.data_ptr(), meta.data_ptr(), G, chains.data_ptr(),
        torch.cuda.current_stream(slots.device).cuda_stream)
    star_chains.launches += 1
    build.check(code, "come_star_chains")
    return (chains[:2 * G * NWL].view(G, NWL, 2),
            chains[2 * G * NWL:].view(G, NWL))


star_chains.launches = 0


def _block_ends(G: int, R: int) -> list:
    """The last group of each block of R groups of a step of G groups."""
    return [min(b * R + R - 1, G - 1) for b in range(-(-G // R))]


def star_fold_chains_reference(slots: torch.Tensor, meta: torch.Tensor,
                               pools: torch.Tensor, R: int = 1):
    """Plain version of :func:`star_fold_chains`."""
    ids = slots.long().reshape(-1, NWL)
    real = _star_real(meta.reshape(-1, NWL))
    blocks = pools.reshape(-1, pools.shape[-1])
    out = [_fold(ids[g], real[g], blocks[b])
           for b, g in enumerate(_block_ends(ids.shape[0], R))]
    fold_slot, fold_draw = (torch.stack(x) for x in zip(*out))
    if pools.dim() == 1:
        return fold_slot[0], fold_draw[0]
    return fold_slot, fold_draw


def star_fold_chains(slots: torch.Tensor, meta: torch.Tensor,
                     pools: torch.Tensor, *, R: int = 1,
                     chains: tuple | None = None,
                     pool_chains_of: tuple | None = None):
    """Which rows each block's last group of a star step writes through
    both its real slots and its block's pool, as
    star_block_end_scatter_kernel reads them, for ``slots`` and ``meta``
    int [G * 1024] and ``pools`` int [ceil(G / R), KP], R groups a block:
    (fold_slot int32 [blocks, 1024], fold_draw int32 [blocks, KP]), block
    b's last group g = min(b R + R - 1, G - 1): fold_slot[b, t] = the place
    in pool b's chain (a stable sort of its ids) of the first draw of real
    slot t's row of group g, -1 where the pool does not draw it and at pads;
    fold_draw[b, k] = 1 where draw k's row is among group g's real slots'
    rows, else 0.  A pool [KP] (one group, R 1) gives (fold_slot [1024],
    fold_draw [KP]).

    CPU tensors run the plain version; CUDA tensors launch
    ``fold_chains_kernel`` (one CTA a block) on the step's chains
    (``chains``, as :func:`star_chains` gives them, and ``pool_chains_of``,
    as ``ops/pool_pass.py``'s ``pool_chains`` gives them; made here where not
    given) or raise (counted in ``star_fold_chains.launches``)."""
    slots, meta = slots.reshape(-1), meta.reshape(-1)
    G = slots.numel() // NWL
    one = pools.dim() == 1
    if slots.numel() % NWL or meta.shape != slots.shape or R < 1 or \
            pools.dim() not in (1, 2) or (one and G != 1) or \
            pools.reshape(-1, pools.shape[-1]).shape[0] != -(-G // R):
        raise ValueError(f"star_fold_chains: whole groups of {NWL} slots "
                         f"and meta, a pool [KP] for one group or pools "
                         f"[ceil(G / R), KP]")
    if slots.device.type == "cpu":
        return star_fold_chains_reference(slots, meta, pools, R)
    if slots.device.type != "cuda":
        raise ValueError(f"no fold chains kernel for device {slots.device}")
    blocks = pools.reshape(-1, pools.shape[-1]).to(torch.int32).contiguous()
    nb, KP = blocks.shape
    slots = slots.to(torch.int32).contiguous()
    meta = meta.to(torch.int32).contiguous()
    info, _ = star_chains(slots, meta) if chains is None else chains
    pinfo, _ = pool_chains(blocks) if pool_chains_of is None else \
        pool_chains_of
    fold = torch.empty((G * NWL + nb * KP,), dtype=torch.int32,
                       device=slots.device)
    code = build.library().come_star_fold_chains(
        slots.data_ptr(), meta.data_ptr(), info.data_ptr(),
        blocks.data_ptr(), pinfo.data_ptr(), G, KP, int(R), fold.data_ptr(),
        torch.cuda.current_stream(slots.device).cuda_stream)
    star_fold_chains.launches += 1
    build.check(code, "come_star_fold_chains")
    if one:  # adjacent, as star_scatter takes them
        return fold[:NWL], fold[NWL:]
    # the block ends' rows, indexed on the card (a Python list of indices
    # would be copied from pageable memory and wait for the card)
    ends = torch.arange(R - 1, G - 1 + R, R, device=slots.device)
    return (fold[:G * NWL].view(G, NWL)[ends.clamp_(max=G - 1)],
            fold[G * NWL:].view(nb, KP))


star_fold_chains.launches = 0


def star_scatter_reference(emb, slots, meta, dphi, dphin, lr, pool=None,
                           dneg=None):
    """Plain version of the star slot writes of one group
    (``csrc/star_sgns.cu``: ``star_scatter_kernel``; the TPU's slot loop,
    ``pallas_star_sgns.py:186-195``) and, with ``pool``, of a block end's,
    whose pool write is folded in (``star_block_end_scatter_kernel``; the
    TPU's ``_apply_pool``, ``:197-204``): for each real slot t (meta !=
    -2) in slot order, ``emb[slots[t]] += (dphi[t] + dphin[t]) * -lr``, the
    sum, the product and the add each rounded in the table's dtype; then
    ``emb[pool[k]] += dneg[k] * -lr`` for k in draw order, product and add
    each rounded.  ``slots``, ``meta`` int [1024], ``dphi``, ``dphin``
    [1024, d] (``dphin`` the kernel's separate negative part), ``pool`` int
    [KP] and ``dneg`` [KP, d].  Returns ``emb``, updated in place."""
    d = emb.shape[1]
    real = _star_real(meta.reshape(-1))
    upd = ((dphi + dphin).reshape(NWL, d) * (-lr)).to(emb.dtype)
    rmw_rows_f32(emb, slots.long().reshape(-1)[real], upd[real])
    if pool is not None:
        rmw_rows_f32(emb, pool.long(), (dneg * (-lr)).to(emb.dtype))
    return emb


def star_scatter(emb: torch.Tensor, slots: torch.Tensor, meta: torch.Tensor,
                 dphi: torch.Tensor, dphin: torch.Tensor, lr: float, *,
                 pool: torch.Tensor | None = None,
                 dneg: torch.Tensor | None = None,
                 chains: tuple | None = None,
                 pool_chains_of: tuple | None = None,
                 fold: tuple | None = None):
    """The star slot writes of one group, in place on the tied table
    ``emb`` [V, d] f32: for each real slot t (meta != -2) of ``slots`` and
    ``meta`` int [1024] in slot order, ``emb[slots[t]] += (dphi[t] +
    dphin[t]) * -lr``, each add rounded in f32, from ``dphi`` and ``dphin``
    (the negative pass's part) f32 [1024, d]; with ``pool`` int [KP] (a
    group that ends an R-block) then ``emb[pool[k]] += dneg[k] * -lr`` for k
    in draw order, from ``dneg`` f32 [KP, d].  Returns ``emb``.

    CPU tensors run the plain version (:func:`star_scatter_reference`);
    CUDA tensors launch ``star_scatter_kernel``, or with a pool
    ``star_block_end_scatter_kernel``, on the group's chains (``chains``, as
    :func:`star_chains` gives them for ``slots`` and ``meta``,
    ``pool_chains_of``, as ``ops/pool_pass.py``'s ``pool_chains`` gives them
    for ``pool``, and ``fold``, as :func:`star_fold_chains` gives them; made
    here where not given) or raise (counted in ``star_scatter.launches``
    and ``.launches_block_end``)."""
    d = emb.shape[1] if emb.dim() == 2 else 0
    if emb.dtype != torch.float32 or not emb.is_contiguous() or d < 1:
        raise ValueError("star_scatter: the table must be contiguous f32 "
                         "[V, d]")
    for t in (dphi, dphin):
        if t.shape != (NWL, d) or t.dtype != torch.float32 or \
                t.device != emb.device:
            raise ValueError(f"star_scatter: updates must be f32 "
                             f"[{NWL}, {d}] on {emb.device}")
    if slots.numel() != NWL or meta.numel() != NWL:
        raise ValueError(f"star_scatter: one group's {NWL} slots and meta")
    if pool is not None and (
            pool.dim() != 1 or dneg is None or
            dneg.shape != (pool.numel(), d) or dneg.dtype != torch.float32
            or pool.device != emb.device or dneg.device != emb.device):
        raise ValueError(f"star_scatter: a pool [KP] takes dneg f32 "
                         f"[KP, {d}] on {emb.device}")
    if emb.device.type == "cpu":
        return star_scatter_reference(emb, slots, meta, dphi, dphin, lr,
                                      pool=pool, dneg=dneg)
    if emb.device.type != "cuda":
        raise ValueError(f"no star scatter kernel for device {emb.device}")
    info, order = star_chains(slots, meta) if chains is None else chains
    if info.shape != (1, NWL, 2) or order.data_ptr() != \
            info.data_ptr() + 8 * NWL:
        raise ValueError("star_scatter: chains must be star_chains' of "
                         "these slots")
    slots = slots.to(torch.int32).contiguous()
    KP, pool_p, dneg_p, pch_p, fold_p = 0, None, None, None, None
    if pool is not None:
        KP = pool.numel()
        pool = pool.to(torch.int32).contiguous()
        pch = pool_chains(pool) if pool_chains_of is None else pool_chains_of
        if pch[0].shape != (1, KP, 2) or pch[1].data_ptr() != \
                pch[0].data_ptr() + 8 * KP:
            raise ValueError("star_scatter: pool chains must be "
                             "pool_chains' of this pool")
        fold = star_fold_chains(slots, meta, pool, chains=(info, order),
                                pool_chains_of=pch) if fold is None else fold
        if fold[0].numel() != NWL or fold[1].data_ptr() != \
                fold[0].data_ptr() + 4 * NWL:
            raise ValueError("star_scatter: fold chains must be "
                             "star_fold_chains' of these slots and pool")
        dneg = dneg.contiguous()
        pool_p, dneg_p, pch_p, fold_p = pool.data_ptr(), dneg.data_ptr(), \
            pch[0].data_ptr(), fold[0].data_ptr()
    code = build.library().come_star_scatter(
        emb.data_ptr(), slots.data_ptr(), dphi.contiguous().data_ptr(),
        dphin.contiguous().data_ptr(), info.data_ptr(), pool_p, dneg_p,
        pch_p, fold_p, d, KP, float(lr),
        torch.cuda.current_stream(emb.device).cuda_stream)
    if pool is None:
        star_scatter.launches += 1
    else:
        star_scatter.launches_block_end += 1
    build.check(code, "come_star_scatter")
    return emb


star_scatter.launches = 0
star_scatter.launches_block_end = 0
