"""Walk-banded SGNS macro step: the CUDA kernel, its plain version and the
wrappers that pick between them by device.

Port of ``come_tpu/ops/pallas_walk_sgns.py::fused_walk_sgns_step`` and
``fused_walk_sgns_gen_step`` (kernel source: ``csrc/walk_sgns.cu``), in the
TPU kernel's modes: K1 (the banded O1 step, f32 tables), K1b (``mxu_bf16``:
product operands rounded to bf16, f32 sums), K5 (``paired``: the O2 edge
mode), K4 (walks generated in the kernel from the CSR and an input bit
matrix) and K3 (bf16 tables: K1b's arithmetic on rows stored in bf16, each
slot's write a read-modify-write rounded to bf16, stochastically with
``sr_seed``).  Walks come in groups of 8 (1024 slots, each walk padded to
128 positions); groups run in order, so group g+1 sees group g's update,
and one shared negative pool serves each block of R groups (staged at its
start, its gradient applied at its end).

Differences from the JAX functions, all deliberate:
  * the reduced-window draws are an input, ``wrow`` int32 [G*1024] in
    {1..W} (clamped to W), instead of the TPU's in-kernel PRNG, so every
    implementation can be fed the same draws;
  * the stochastic-rounding bits are a counter-based hash of (step seed,
    group, slot, element) (:func:`sr_bits`) instead of the TPU's on-chip
    PRNG, so the kernel and its plain version round alike; the pool write
    has its own counter range (slots 1024 + k), where the TPU reads its
    1024-row draw buffer at row k < KP (``pallas_walk_sgns.py:418`` against
    ``:603``), past its end when KP > 1024;
  * bf16 tables stay plain [V, d] bf16 (no u32 row-pair packing);
  * the tables are updated IN PLACE (no second [V, d] copy per step) and
    returned;
  * on the card a macro step is one unit the card replays, where the TPU
    runs one ``pallas_call`` with a grid over the groups: the step's
    launch plan (``ops/launch_plan.py``) records the group loop once as a
    CUDA graph, and a call sets its head kernel's parameters (the call's
    walks, window draws, pools, lr and SR seed) and replays it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from come_tpu_torch.ops import build, launch_plan

LP = 128  # slots per walk (walks are padded to this many positions)
NW = 8  # walks per group
NWL = LP * NW  # slots per group

# The band and star passes' routes on the card (csrc/sgns_common.cuh:
# PosRoute, decided in C by whether a CTA's rows fit in shared memory):
# "rows" up to d 192, "whole" (the *_wide_kernel forms, whole rows held in
# shared memory) past it where the rows fit, "slab" (column slabs) where
# they do not.
POS_ROUTES = ("rows", "whole", "slab")


def new_routes() -> dict:
    """A wrapper's count of steps by band or star route."""
    return dict.fromkeys(POS_ROUTES, 0)


def count_route(plan, how: int, fn, lib) -> None:
    """Count one step of ``fn`` by the route of the band or star pass that
    its plan's recording launched (``come_step_graph_route``, read when
    the step records; a replay runs what was recorded)."""
    if how != launch_plan.RECORD_NONE or plan.route is None:
        r = lib.come_step_graph_route(plan.slot)
        if not 0 <= r < len(POS_ROUTES):
            raise RuntimeError(f"come_step_graph_route: no route ({r})")
        plan.route = POS_ROUTES[r]
    fn.routes[plan.route] += 1


def pad_walks(walks: torch.Tensor) -> torch.Tensor:
    """[B, L] walks -> int32 [G*1024] slots: B wraps up to a multiple of 8
    with real walks (``jnp.resize`` semantics), positions pad to 128 with
    node 0 (masked)."""
    B, L = walks.shape
    if L > LP:
        raise ValueError(
            f"walk_length {L} > {LP}: the walk kernel takes walks of at most "
            f"{LP} (the trainer sends longer walks to the micro-batched tier)"
        )
    G = -(-B // NW)
    w = walks[torch.arange(G * NW, device=walks.device) % B]
    return F.pad(w, (0, LP - L)).reshape(G * NWL).to(torch.int32).contiguous()


def expand_pools(pools: torch.Tensor, G: int, R: int) -> torch.Tensor:
    """Pools as contiguous int32 [ceil(G / R), KP]; one [KP] pool serves
    every R-block."""
    n_pools = -(-G // R)
    if pools.dim() == 1:
        pools = pools[None].expand(n_pools, -1)
    if pools.shape[0] != n_pools:
        raise ValueError(
            f"per-block pools: got {pools.shape[0]} pools for {G} groups "
            f"at pool_refresh={R} (need {n_pools})"
        )
    return pools.to(torch.int32).contiguous()


def mxu(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even) and widened back when ``bf16``:
    the TPU kernels' cast of a product operand to ``mxu_t``."""
    return x.to(torch.bfloat16).to(x.dtype) if bf16 else x


# ------------------------------------------ K3: bf16 tables, rounded writes

M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2^32 for x < 2^32 (an int or an int64 tensor), split so no
    product passes 2^49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(x):
    """A bijective 32-bit integer hash (x < 2^32; int or int64 tensor);
    csrc/walk_sgns.cu's ``mix32`` bit for bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sr_key(seed: int, group: int) -> int:
    """The stochastic-rounding key of one group of one step."""
    return mix32((seed & M32) ^ mix32(group & M32))


def sr_bits(key: int, counter: torch.Tensor) -> torch.Tensor:
    """32 random bits per counter (int64 tensor of values < 2^32): slot t's
    element k has counter t*d + k; its node-table write rounds with the low
    16 bits, its ctx-table write with the high 16.  The pool row k of a
    block ending at group g uses slot 1024 + k of g, low 16 bits."""
    return mix32(counter ^ key)


def round_bf16(x: torch.Tensor, rnd: torch.Tensor | None) -> torch.Tensor:
    """f32 ``x`` to bf16 as the TPU's ``_pack_row`` writes it
    (``pallas_walk_sgns.py:76-88``): ``(bits(x) + rnd) >> 16`` with
    ``rnd`` int64 in [0, 2^16) (stochastic rounding), or truncation
    (``rnd`` None)."""
    b = x.contiguous().view(torch.int32).long() & M32
    if rnd is not None:
        b = (b + rnd) & M32
    h = b >> 16
    return torch.where(h >= 0x8000, h - 0x10000, h).to(torch.int16).view(
        torch.bfloat16)


def occurrence_rank(ids: torch.Tensor) -> torch.Tensor:
    """For each position i, how many earlier positions hold ids[i]."""
    ids = ids.long()
    order = torch.sort(ids, stable=True).indices
    s = ids[order]
    rank = torch.empty_like(ids)
    rank[order] = torch.arange(ids.numel(), device=ids.device) - \
        torch.searchsorted(s, s)
    return rank


def rmw_rows(table, ids, upd, rnd):
    """``table[ids[i]] = round_bf16(f32(table[ids[i]]) + upd[i], rnd[i])``
    for i in order, one read-modify-write per i: rows that repeat are
    applied in rounds by occurrence rank (distinct rows commute), so the
    result is the sequential one.  ``table`` bf16 [V, d], ``upd`` f32
    [n, d], ``rnd`` int64 [n, d] or None (truncation)."""
    rank = occurrence_rank(ids)
    for r in range(int(rank.max()) + 1 if ids.numel() else 0):
        sel = rank == r
        rows = ids[sel]
        table[rows] = round_bf16(table[rows].float() + upd[sel],
                                 None if rnd is None else rnd[sel])


def rmw_rows_f32(table, ids, upd):
    """``table[ids[i]] += upd[i]`` for i in order, each add rounded in the
    table's dtype: rows that repeat are applied in rounds by occurrence
    rank, each round adding to distinct rows, so a row's terms apply in
    order on any device (a CUDA ``index_add_`` adds a repeated row's terms
    in the order its atomics land)."""
    rank = occurrence_rank(ids)
    for r in range(int(rank.max()) + 1 if ids.numel() else 0):
        sel = rank == r
        rows = ids[sel]
        table[rows] = table[rows] + upd[sel]


def pool_stage_reference(table, pool, acc: torch.dtype = torch.float32):
    """Plain version of the pool stage (``csrc/sgns_common.cuh``:
    ``stage_pool_kernel``; the TPU's ``_stage_pool``,
    ``pallas_walk_sgns.py:216``): (cneg, dneg) = (``table[pool]`` widened
    to ``acc``, zeros of its shape)."""
    cneg = table[pool].to(acc)
    return cneg, torch.zeros_like(cneg)


def pool_sr_bits(sr_seed: int | None, group: int, KP: int, d: int,
                 device) -> torch.Tensor | None:
    """The rounding bits of the pool write of a block whose last group is
    ``group``: row k's element j takes the low 16 bits of
    ``sr_bits(sr_key(sr_seed, group), (1024 + k) * d + j)``, int64 [KP, d];
    None (truncation) without a seed."""
    if sr_seed is None:
        return None
    counter = torch.arange(NWL * d, (NWL + KP) * d, device=device).view(KP, d)
    return sr_bits(sr_key(sr_seed, group), counter) & 0xFFFF


def walk_scatter_bf16_reference(emb_in, emb_out, ids, dphi, dctx, lr, L,
                                group, sr_seed=None, dphin=None):
    """Plain version of K3's slot writes for one group (``csrc/walk_sgns.cu``:
    ``walk_scatter_bf16_kernel``; the TPU's slot ``fori_loop`` on bf16
    tables, ``pallas_walk_sgns.py:369-400``): for each real slot t (position
    < L) in slot order, ``emb_in[ids[t]] = round(f32(row) + f32(dphi[t] *
    -lr))`` and ``emb_out[ids[t]] = round(f32(row) + f32(dctx[t] * -lr))``
    (:func:`rmw_rows`), rounded by the low and the high 16 bits of
    ``sr_bits(sr_key(sr_seed, group), t * d + k)`` or truncated
    (``sr_seed`` None).  ``ids`` int [1024] the group's slot rows, ``dphi``
    and ``dctx`` [1024, d] (or [8, 128, d]) in the step's arithmetic dtype;
    ``dphin`` (the kernel's separate negative part) is added to ``dphi``
    first where given.  Returns (emb_in, emb_out), updated in place."""
    d = emb_in.shape[1]
    dev = emb_in.device
    real = (torch.arange(NWL, device=dev) % LP) < L
    if dphin is not None:
        dphi = dphi + dphin
    lo = hi = None
    if sr_seed is not None:
        counter = torch.arange(NWL * d, device=dev).view(NWL, d)[real]
        bits = sr_bits(sr_key(sr_seed, group), counter)
        lo, hi = bits & 0xFFFF, bits >> 16
    ids = ids.long()[real]
    dphi, dctx = dphi.reshape(NWL, d)[real], dctx.reshape(NWL, d)[real]
    rmw_rows(emb_in, ids, (dphi * (-lr)).float(), lo)
    rmw_rows(emb_out, ids, (dctx * (-lr)).float(), hi)
    return emb_in, emb_out


def walk_scatter_f32_reference(emb_in, emb_out, ids, dphi, dctx, lr, L,
                               dphin=None, pool=None, dneg=None):
    """Plain version of the f32 slot writes of one group
    (``csrc/walk_sgns.cu``: ``walk_scatter_kernel``; the TPU's slot
    ``fori_loop``, ``pallas_walk_sgns.py:369-400``, f32 at ``:395-397``)
    and, with ``pool``, of a block end's, whose pool write is folded in
    (``block_end_scatter_kernel``; the TPU's ``_apply_pool``, ``:405``).
    For each distinct row v of the real slots t (position < L), the terms
    ``dphi[t] * -lr`` and ``dctx[t] * -lr`` (each product rounded in the
    tables' dtype) are summed in float64 in slot order and each sum is
    added to ``emb_in[v]`` and ``emb_out[v]`` with one rounding; then
    ``emb_out[pool[k]] += dneg[k] * -lr`` for k in draw order, product and
    add each rounded.  ``ids`` int [1024] the group's slot rows, ``dphi``,
    ``dctx`` [1024, d] (or [8, 128, d]); ``dphin`` (the kernel's separate
    negative part) is added to ``dphi`` first where given; ``pool`` int
    [KP] and ``dneg`` [KP, d].  Returns (emb_in, emb_out), updated in
    place."""
    d = emb_in.shape[1]
    dev = emb_in.device
    real = (torch.arange(NWL, device=dev) % LP) < L
    if dphin is not None:
        dphi = dphi + dphin
    rows, at = torch.unique(ids.long()[real], return_inverse=True)
    for table, upd in ((emb_in, dphi), (emb_out, dctx)):
        terms = (upd.reshape(NWL, d)[real] * (-lr)).double()
        # index_add_ adds in index order on the CPU (each row's terms in
        # slot order); a CUDA one's float64 atomics may take another order,
        # which moves the rounded f32 row only at a float64 tie
        sums = torch.zeros((rows.numel(), d), dtype=torch.float64,
                           device=dev).index_add_(0, at, terms)
        table[rows] = (table[rows].double() + sums).to(table.dtype)
    if pool is not None:  # a row's draws in draw order
        rmw_rows_f32(emb_out, pool.long(), (dneg * (-lr)).to(emb_out.dtype))
    return emb_in, emb_out


def pool_apply_bf16_reference(table, pool, dneg, lr, rnd):
    """Plain version of K3's pool write (``apply_pool_bf16_kernel``; the
    TPU's ``_apply_pool`` on bf16 tables, ``pallas_walk_sgns.py:405``):
    ``table[pool[k]] = round(f32(table[pool[k]]) + f32(dneg[k] * -lr),
    rnd[k])`` for k in draw order (:func:`rmw_rows`), ``rnd`` from
    :func:`pool_sr_bits` or None.  Returns ``table``, updated in place."""
    rmw_rows(table, pool, (dneg * (-lr)).float(), rnd)
    return table


# The pool passes inside the walk and star steps' recorded group loops, in
# the order of csrc/sgns_common.cuh's PoolPass: stage_pool_kernel on f32 and
# on bf16 tables, every walk and star step's pool_chains_kernel (once a
# step: the pools sorted into the chains their pool writes follow), K3's
# apply_pool_bf16_kernel, the bf16 passes' stage past d 192
# (stage_pool_bf16_kernel: bf16 rows in the wide negative pass's core
# layout), the walk steps' slot passes: slot_chains_kernel (once a step:
# each group's slots sorted into the chains its slot scatter follows), K3's
# walk_scatter_bf16_kernel and the f32 walk_scatter_kernel (once a group
# that ends no R-block) or block_end_scatter_kernel (once a block: the
# last group's scatter with the block's pool write folded in), then
# apply_pool_kernel (P3's pool write: no step launches it, so a step reads
# 0 here), the f32 walk and star steps' fold_chains_kernel (once a step:
# which rows each block's last group writes through both its slots and its
# pool), and the star steps' slot passes: their slot chains (once a step,
# slot_chains_kernel on the layout's meta), star_scatter_kernel (once a
# group that ends no R-block) and star_block_end_scatter_kernel (once a
# block, the pool write folded in).
POOL_PASSES = ("stage_pool", "stage_pool_bf16_tables", "pool_chains",
               "apply_pool_bf16", "stage_pool_bf16", "slot_chains",
               "walk_scatter_bf16", "walk_scatter", "block_end_scatter",
               "apply_pool", "fold_chains", "star_chains", "star_scatter",
               "star_block_end_scatter")
# Their launches in the steps the wrappers launched.  Reset by assigning
# zeros.
POOL_LAUNCHES = dict.fromkeys(POOL_PASSES, 0)


def new_pools() -> dict:
    """A step wrapper's count of the pool passes its steps launched."""
    return dict.fromkeys(POOL_PASSES, 0)


def count_pool_passes(plan, how: int, lib, fn=None) -> None:
    """Add one step's pool passes to :data:`POOL_LAUNCHES`, and to the
    step wrapper ``fn``'s own ``pools`` where given: those its plan's
    recording launched (``come_step_graph_pool``, which the C group loop
    counts as it launches them; read when the step records, since a replay
    runs what was recorded)."""
    if how != launch_plan.RECORD_NONE or plan.pool is None:
        plan.pool = tuple(lib.come_step_graph_pool(plan.slot, i)
                          for i in range(len(POOL_PASSES)))
        if min(plan.pool) < 0:
            raise RuntimeError(f"come_step_graph_pool: no counts {plan.pool}")
    for name, n in zip(POOL_PASSES, plan.pool):
        POOL_LAUNCHES[name] += n
        if fn is not None:
            fn.pools[name] += n


def walk_sgns_step_reference(emb_in, emb_out, walks, wrow, pools, lr, negw,
                             *, window: int, pool_refresh: int = 1,
                             mxu_bf16: bool = False, paired: bool = False,
                             sr_seed: int | None = None,
                             acc: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`walk_sgns_step` (same signature and
    semantics): a loop over groups with dense per-walk [128, 128] band
    scores.  ``mxu_bf16`` rounds phi, ctx, each band g, the pool rows and
    each negative g where the TPU kernel casts to bf16 (``paired`` keeps
    its positive pass f32, as the TPU does); ``paired`` trains only each
    slot's partner t^1 (``wrow`` and ``window`` are not read).  bf16 tables
    (K3) take ``mxu_bf16``'s rounding and apply each slot's update
    ``-lr * d`` as a rounded read-modify-write (:func:`rmw_rows`), the
    pool's at the block end, by stochastic rounding with ``sr_seed`` or
    truncation without.  ``acc`` is the dtype of the arithmetic (float64
    only in ``ops/tolerance.py``'s emulation of another sum order; bf16
    tables then round its f32 cast).  Returns (emb_in, emb_out, loss,
    n_pairs)."""
    tables_bf16 = _tables_bf16(emb_in, emb_out, paired)
    mxu_bf16 = mxu_bf16 or tables_bf16
    B, L = walks.shape
    slots = pad_walks(walks).long()
    G = slots.shape[0] // NWL
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R).long()
    dev = emb_in.device
    pos = torch.arange(LP, device=dev)
    off = pos[None, :] - pos[:, None]  # [t, u] = u - t
    valid = (pos[:, None] < L) & (pos[None, :] < L) & (off != 0)
    if paired:
        band = (valid & (pos[None, :] == (pos[:, None] ^ 1))).to(acc)[None]
    else:
        wrow = wrow.reshape(G, NW, LP).clamp(max=window)
    rnd = mxu_bf16 and not paired  # the paired positive pass is f32
    loss = torch.zeros((), dtype=acc, device=dev)
    npairs = torch.zeros((), dtype=acc, device=dev)
    d = emb_in.shape[1]
    for g in range(G):
        if g % R == 0:
            pool = pools[g // R]
            cneg, dneg = pool_stage_reference(emb_out, pool, acc)
            cneg = mxu(cneg, mxu_bf16)
        ids = slots[g * NWL:(g + 1) * NWL]
        phi = emb_in[ids].to(acc).view(NW, LP, d)
        ctx = mxu(emb_out[ids].to(acc).view(NW, LP, d), rnd)
        phi_p = mxu(phi, rnd)
        m = band if paired else (
            valid[None] & (off.abs()[None] <= wrow[g][:, :, None])).to(acc)
        s = phi_p @ ctx.transpose(1, 2)  # [NW, t, u]
        gpos = mxu((torch.sigmoid(s) - 1.0) * m, rnd)
        loss = loss - (m * F.logsigmoid(s)).sum()
        n_t = m.sum(2, keepdim=True).expand(NW, LP, 1)  # [NW, LP, 1]
        npairs = npairs + n_t.sum()
        dphi = gpos @ ctx
        dctx = gpos.transpose(1, 2) @ phi_p
        phi_m = mxu(phi, mxu_bf16)
        sn = phi_m @ cneg.T  # [NW, LP, KP]
        gneg = mxu(torch.sigmoid(sn) * (negw * n_t), mxu_bf16)
        loss = loss - negw * (n_t * F.logsigmoid(-sn)).sum()
        dphi = dphi + gneg @ cneg
        dneg = dneg + torch.einsum("bsk,bsd->kd", gneg, phi_m)
        end = g % R == R - 1 or g == G - 1
        if not tables_bf16:
            # f32 adds in index order (the CPU's), the form chip_smoke.py's
            # bf16 checks were set against: the float64 sums of
            # walk_scatter_f32_reference here put the bench step's check at
            # d 256 past its bound in a share of runs (PERF.md §6)
            emb_in.index_add_(0, ids, dphi.reshape(NWL, d), alpha=-lr)
            emb_out.index_add_(0, ids, dctx.reshape(NWL, d), alpha=-lr)
            if end:
                emb_out.index_add_(0, pool, dneg, alpha=-lr)
            continue
        # K3: one rounded RMW per real slot in slot order (padded slots
        # carry exact zeros, which round to the row itself), then the pool's
        walk_scatter_bf16_reference(emb_in, emb_out, ids, dphi, dctx, lr, L,
                                    g, sr_seed)
        if end:
            pool_apply_bf16_reference(
                emb_out, pool, dneg, lr,
                pool_sr_bits(sr_seed, g, pool.numel(), d, dev))
    return emb_in, emb_out, loss, npairs


def _tables_bf16(emb_in, emb_out, paired: bool) -> bool:
    """Whether the walk tables are bf16 (K3); raises on mixed dtypes and on
    bf16 tables in paired mode (the TPU's K5 takes f32 tables only,
    ``come_tpu/trainer/come.py:841-856``)."""
    if emb_in.dtype != emb_out.dtype:
        raise ValueError("emb_in/emb_out dtypes must match")
    bf16 = emb_in.dtype == torch.bfloat16
    if bf16 and paired:
        raise ValueError("paired mode takes f32 tables only")
    return bf16


def check_cuda_inputs(*tensors, kernel: str,
                      table_dtypes=(torch.float32,)):
    """Raise unless every tensor shares one device, the first two (the
    tables) are contiguous and of one of ``table_dtypes``, and d >= 1 (even
    for bf16 tables, whose writes go by pairs).  ``kernel`` names the
    caller's mode (K1, K1b, K3, K4, K5, K2, K2b, P3, K6, K7) in the
    message.  Every mode takes any d: past ``csrc/sgns_common.cuh``'s
    MAX_DIM (192) the kernels hold whole rows where they fit and stage
    column slabs where they do not."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
    for t in tensors[:2]:
        if t.dtype not in table_dtypes or not t.is_contiguous():
            raise ValueError(f"{kernel}: tables must be contiguous "
                             f"{table_dtypes}")
    d = tensors[0].shape[1]
    if d < 1:
        raise ValueError(f"{kernel}: dim {d} < 1")
    if tensors[0].dtype == torch.bfloat16 and d % 2:
        raise ValueError(f"{kernel}: bf16 tables need an even dim")


def walk_plan(entry: str, device, stream: int, mode: tuple, d: int, G: int,
              L: int, W: int, KP: int, R: int) -> launch_plan.LaunchPlan:
    """The launch plan of a walk-kernel step: ``entry`` "walk_sgns" (mode
    (bf16, paired, tables_bf16, sr)) or "walk_sgns_gen" (mode (bf16,
    tables_bf16, sr); the plan also holds the generated walks), keyed on
    the shape (d, G, L, W, KP, R).  Its staged inputs: the walks (K4: the
    starts and the 32-bit draws), the window draws (not paired) and the
    pools; its chains: the pools' (3 int32 a pool draw:
    ``csrc/sgns_common.cuh``'s pool_chains_kernel), after them the groups'
    slots' (3 int32 a slot: ``csrc/walk_sgns.cu``'s slot_chains_kernel),
    which every mode's slot and pool writes follow, and the f32 block
    ends' fold chains (1 int32 a slot, then 1 a pool draw:
    fold_chains_kernel; K3 leaves them unused)."""
    gen = entry == "walk_sgns_gen"
    inputs = {"starts": G * NW, "bits": G * NWL} if gen else \
        {"walks": G * NWL}
    if gen or not mode[1]:
        inputs["wrow"] = G * NWL
    inputs["pools"] = -(-G // R) * KP
    return launch_plan.plan_for(
        entry, device, stream, mode, (d, G, L, W, KP, R), KP=KP, d=d,
        walk_slots=G * NWL if gen else 0, inputs=inputs,
        chains=4 * (inputs["pools"] + G * NWL))


def walk_entry_args(plan, how: int, emb_in, emb_out, slots, wrow, pools,
                    d: int, G: int, L: int, W: int, KP: int, R: int,
                    bf16: int, paired: int, tables_bf16: int, sr: int,
                    seed: int, lr: float, negw: float, stream: int,
                    gen: tuple | None = None) -> tuple:
    """The arguments of ``come_walk_sgns_step`` (``gen`` None) or
    ``come_walk_sgns_gen_step`` (``gen`` = (starts, bits, indptr,
    indices); the walks go to ``plan.walks``) for one step: the plan's
    graph slot, scratch, staged inputs and argument block, and this step's
    own tensors, ``lr`` and seed; ``how`` is :meth:`LaunchPlan.begin`'s.
    """
    st, cneg, dneg, dphi, dctx, nt = plan.scratch()
    head = (plan.slot, how, emb_in.data_ptr(), emb_out.data_ptr())
    if gen is not None:
        head += tuple(t.data_ptr() for t in gen) + (plan.walks.data_ptr(),)
    else:
        head += (slots.data_ptr(),)
    wbuf = plan.inputs.get("wrow")
    head += (None if wrow is None else wrow.data_ptr(), pools.data_ptr(), st,
             cneg, dneg, dphi, dctx, nt)
    head += plan.staged("starts", "bits") if gen is not None else \
        plan.staged("walks")
    chains = None if plan.chains is None else plan.chains.data_ptr()
    head += (None if wbuf is None else wbuf.data_ptr(),) + \
        plan.staged("pools") + (plan.args.data_ptr(), chains, d, G, L, W, KP,
                                R, bf16)
    if gen is None:
        head += (paired,)
    return head + (tables_bf16, sr, seed, float(lr), float(negw), stream)


def _check_wrow(wrow, G):
    wrow = wrow.to(torch.int32).contiguous()
    if wrow.numel() != G * NWL:
        raise ValueError(f"wrow has {wrow.numel()} draws, need {G * NWL}")
    return wrow


def _table_modes(emb_in, emb_out, paired, sr_seed):
    """(tables_bf16, sr, seed) for the C entries; K3's SR seed is 32 bits."""
    tables_bf16 = _tables_bf16(emb_in, emb_out, paired)
    sr = tables_bf16 and sr_seed is not None
    return int(tables_bf16), int(sr), (int(sr_seed) & M32) if sr else 0


_BOTH = (torch.float32, torch.bfloat16)


def _walk_kernel(mxu_bf16: bool, paired: bool, tables_bf16) -> str:
    """The name of a walk step's mode: K3, K5 (paired, f32 products), K1b
    (bf16 products, paired or not) or K1."""
    if tables_bf16:
        return "K3"
    if mxu_bf16:
        return "K1b"
    return "K5" if paired else "K1"


def _count_walk_launch(mxu_bf16: bool, paired: bool, tables_bf16) -> None:
    if tables_bf16:
        walk_sgns_step.launches_bf16_tables += 1
    elif paired:
        walk_sgns_step.launches_paired += 1
    elif mxu_bf16:
        walk_sgns_step.launches_bf16 += 1
    else:
        walk_sgns_step.launches += 1


def walk_sgns_step(emb_in, emb_out, walks, wrow, pools, lr, negw, *,
                   window: int, pool_refresh: int = 1,
                   mxu_bf16: bool = False, paired: bool = False,
                   sr_seed: int | None = None):
    """One walk-kernel macro step over ``walks`` [B, L] (L <= 128).

    Args:
      emb_in, emb_out: [V, d] node and context tables, updated in place:
        float32, or bfloat16 for K3 (d even, not ``paired``).
      walks: int [B, L] node ids; B wraps up to a multiple of 8 walks.
        With ``paired``, each row holds L/2 edges [u0, v0, u1, v1, ...]
        (L even).
      wrow: int32 [G*1024] window draws per padded slot, in {1..window}
        (None with ``paired``).
      pools: int [ceil(G / pool_refresh), KP] negative pools (or [KP]).
      lr, negw: step size and negative weight (k / KP), Python floats.
      mxu_bf16: round every product operand to bf16 (K1b; with ``paired``,
        only the negative pass's), f32 sums.  bf16 tables imply it.
      paired: the O2 edge mode (K5): each slot trains only its partner.
      sr_seed: with bf16 tables, the step's stochastic-rounding seed (an
        int, 32 bits used); None truncates each write instead.

    Returns (emb_in, emb_out, loss, n_pairs); loss and n_pairs are 0-dim
    float32 tensors on the tables' device.  CPU tensors run the plain
    version; CUDA tensors launch the kernel, as one replayed graph
    (``ops/launch_plan.py``), or raise.  Launches are counted by mode:
    ``walk_sgns_step.launches`` (K1), ``.launches_bf16`` (K1b),
    ``.launches_paired`` (K5) and ``.launches_bf16_tables`` (K3); the
    graph's events over all modes in ``.recordings``, ``.instantiations``,
    ``.updates`` and ``.replays``; steps by the band pass's route over all
    modes in ``.routes`` ({"rows", "whole", "slab"}: :data:`POS_ROUTES`);
    the pool passes its steps launched in ``.pools`` (by
    :data:`POOL_PASSES`).
    """
    if paired and walks.shape[1] % 2:
        raise ValueError("paired mode needs an even number of slots per row")
    if emb_in.device.type == "cpu":
        return walk_sgns_step_reference(
            emb_in, emb_out, walks, wrow, pools, lr, negw, window=window,
            pool_refresh=pool_refresh, mxu_bf16=mxu_bf16, paired=paired,
            sr_seed=sr_seed,
        )
    if emb_in.device.type != "cuda":
        raise ValueError(f"no walk_sgns kernel for device {emb_in.device}")
    tables_bf16, sr, seed = _table_modes(emb_in, emb_out, paired, sr_seed)
    check_cuda_inputs(emb_in, emb_out, walks, wrow, pools, table_dtypes=_BOTH,
                      kernel=_walk_kernel(mxu_bf16, paired, tables_bf16))
    B, L = walks.shape
    slots = pad_walks(walks)
    G = slots.shape[0] // NWL
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R)
    wrow = None if paired else _check_wrow(wrow, G)
    d = emb_in.shape[1]
    KP = pools.shape[1]
    W = 1 if paired else int(window)
    bf16 = int(mxu_bf16 or tables_bf16)
    stream = torch.cuda.current_stream(emb_in.device).cuda_stream
    plan = walk_plan("walk_sgns", emb_in.device, stream,
                     (bf16, int(paired), tables_bf16, sr), d, G, L, W, KP, R)
    lib = build.library()
    plan.graph_slot(lib)
    how = plan.begin((emb_in.data_ptr(), emb_out.data_ptr(), float(negw)))
    code = lib.come_walk_sgns_step(*walk_entry_args(
        plan, how, emb_in, emb_out, slots, wrow, pools, d, G, L, W, KP, R,
        bf16, int(paired), tables_bf16, sr, seed, lr, negw, stream))
    _count_walk_launch(mxu_bf16, paired, tables_bf16)
    build.check(code, "come_walk_sgns_step")
    count_route(plan, how, walk_sgns_step, lib)
    count_pool_passes(plan, how, lib, walk_sgns_step)
    plan.done(how, walk_sgns_step)
    return (emb_in, emb_out) + plan.result()


walk_sgns_step.launches = 0
walk_sgns_step.launches_bf16 = 0
walk_sgns_step.launches_paired = 0
walk_sgns_step.launches_bf16_tables = 0
walk_sgns_step.routes = new_routes()
walk_sgns_step.pools = new_pools()
# the graph's events, over every mode (ops/launch_plan.py)
walk_sgns_step.recordings = 0
walk_sgns_step.instantiations = 0
walk_sgns_step.updates = 0
walk_sgns_step.replays = 0


# ----------------------------------------------------------- K4: gen mode


def walks_from_bits(starts, bits, indptr, indices, walk_length: int):
    """The gen kernel's walks: int32 [G*8, walk_length] from ``starts`` [B]
    (wrapped to G*8 = 8*ceil(B/8)) and ``bits`` (G*1024 32-bit values as
    int32; walk j's hop t reads bits[j*128 + t]).  A hop from v reads
    ``u = float((b >> 8) & 0xFFFFFF) * 2^-24`` and moves to
    ``indices[indptr[v] + min(int(u * float(deg)), max(deg - 1, 0))]`` (f32
    products, truncation); a node of degree 0 stays where it is
    (``pallas_walk_sgns.py:182-201``)."""
    B = starts.shape[0]
    n = -(-B // NW) * NW
    dev = starts.device
    v = starts.to(dev).long()[torch.arange(n, device=dev) % B]
    bits = bits.reshape(n, LP).to(torch.int32)
    u = ((bits >> 8) & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    indptr, indices = indptr.long(), indices.long()
    walks = torch.empty((walk_length, n), dtype=torch.int32, device=dev)
    walks[0] = v.to(torch.int32)
    for t in range(1, walk_length):
        lo = indptr[v]
        deg = indptr[v + 1] - lo
        r = torch.minimum((u[:, t] * deg.to(torch.float32)).to(torch.int64),
                          (deg - 1).clamp_min(0))
        if indices.numel():
            nxt = indices[(lo + r).clamp_max(indices.numel() - 1)]
            v = torch.where(deg > 0, nxt, v)
        walks[t] = v.to(torch.int32)
    return walks.T.contiguous()


def walk_sgns_gen_step_reference(emb_in, emb_out, starts, bits, indptr,
                                 indices, wrow, pools, lr, negw, *,
                                 walk_length: int, window: int,
                                 pool_refresh: int = 1,
                                 mxu_bf16: bool = False,
                                 return_walks: bool = False,
                                 sr_seed: int | None = None):
    """Plain PyTorch version of :func:`walk_sgns_gen_step`:
    :func:`walks_from_bits`, then :func:`walk_sgns_step_reference`."""
    walks = walks_from_bits(starts, bits, indptr, indices, walk_length)
    out = walk_sgns_step_reference(
        emb_in, emb_out, walks, wrow, pools, lr, negw, window=window,
        pool_refresh=pool_refresh, mxu_bf16=mxu_bf16, sr_seed=sr_seed,
    )
    return out + (walks,) if return_walks else out


def walk_sgns_gen_step(emb_in, emb_out, starts, bits, indptr, indices, wrow,
                       pools, lr, negw, *, walk_length: int, window: int,
                       pool_refresh: int = 1, mxu_bf16: bool = False,
                       return_walks: bool = False,
                       sr_seed: int | None = None):
    """One O1 macro step with the walks generated in the kernel (K4).

    Args:
      starts: int [B] walk origins (B wraps up to G*8, G = ceil(B/8)).
      bits: int32 [G*1024] (or [G, 1024]) random 32-bit values; walk j's
        hop t reads bits[j*128 + t] (see :func:`walks_from_bits`).
      indptr, indices: the graph's CSR, int32 [V+1] and [E], on the
        tables' device.
      wrow, pools, lr, negw, window, pool_refresh, mxu_bf16, sr_seed: as
        :func:`walk_sgns_step` (bf16 tables run K3's group loop).
      return_walks: also return the generated walks, int32 [G*8, L].

    Returns (emb_in, emb_out, loss, n_pairs[, walks]); the walks are a
    copy (the plan's buffer is the next step's).  CPU tensors run the
    plain version; CUDA tensors launch the generator and the walk kernel,
    as one replayed graph, or raise.  Launches are counted by mode, apart
    from :func:`walk_sgns_step`'s: ``walk_sgns_gen_step.launches`` (K4
    with f32 products), ``.launches_bf16`` (K4 with K1b's bf16 products)
    and ``.launches_bf16_tables`` (K4 over K3's bf16 tables); the graph's
    events in ``.recordings``, ``.instantiations``, ``.updates`` and
    ``.replays``; steps by the band pass's route in ``.routes``; the pool
    passes in ``.pools``.
    """
    if emb_in.device.type == "cpu":
        return walk_sgns_gen_step_reference(
            emb_in, emb_out, starts, bits, indptr, indices, wrow, pools, lr,
            negw, walk_length=walk_length, window=window,
            pool_refresh=pool_refresh, mxu_bf16=mxu_bf16,
            return_walks=return_walks, sr_seed=sr_seed,
        )
    if emb_in.device.type != "cuda":
        raise ValueError(f"no walk_sgns kernel for device {emb_in.device}")
    check_cuda_inputs(emb_in, emb_out, starts, bits, indptr, indices, wrow,
                      pools, table_dtypes=_BOTH, kernel="K4")
    tables_bf16, sr, seed = _table_modes(emb_in, emb_out, False, sr_seed)
    L = int(walk_length)
    if not 1 <= L <= LP:
        raise ValueError(f"walk_length {L} outside 1..{LP}")
    B = starts.shape[0]
    G = -(-B // NW)
    starts = starts[torch.arange(G * NW, device=starts.device) % B]
    starts = starts.to(torch.int32).contiguous()
    bits = bits.to(torch.int32).contiguous()
    if bits.numel() != G * NWL:
        raise ValueError(f"bits has {bits.numel()} values, need {G * NWL}")
    indptr = indptr.to(torch.int32).contiguous()
    indices = indices.to(torch.int32).contiguous()
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R)
    wrow = _check_wrow(wrow, G)
    d = emb_in.shape[1]
    KP = pools.shape[1]
    W = int(window)
    bf16 = int(mxu_bf16 or tables_bf16)
    stream = torch.cuda.current_stream(emb_in.device).cuda_stream
    plan = walk_plan("walk_sgns_gen", emb_in.device, stream,
                     (bf16, tables_bf16, sr), d, G, L, W, KP, R)
    lib = build.library()
    plan.graph_slot(lib)
    how = plan.begin((emb_in.data_ptr(), emb_out.data_ptr(), float(negw),
                      indptr.data_ptr(), indices.data_ptr()))
    code = lib.come_walk_sgns_gen_step(*walk_entry_args(
        plan, how, emb_in, emb_out, None, wrow, pools, d, G, L, W, KP, R,
        bf16, 0, tables_bf16, sr, seed, lr, negw, stream,
        gen=(starts, bits, indptr, indices)))
    if tables_bf16:
        walk_sgns_gen_step.launches_bf16_tables += 1
    elif mxu_bf16:
        walk_sgns_gen_step.launches_bf16 += 1
    else:
        walk_sgns_gen_step.launches += 1
    build.check(code, "come_walk_sgns_gen_step")
    count_route(plan, how, walk_sgns_gen_step, lib)
    count_pool_passes(plan, how, lib, walk_sgns_gen_step)
    plan.done(how, walk_sgns_gen_step)
    out = (emb_in, emb_out) + plan.result()
    if return_walks:
        out = out + (plan.walks.view(G * NW, LP)[:, :L].clone(),)
    return out


walk_sgns_gen_step.launches = 0
walk_sgns_gen_step.launches_bf16 = 0
walk_sgns_gen_step.launches_bf16_tables = 0
walk_sgns_gen_step.routes = new_routes()
walk_sgns_gen_step.pools = new_pools()
walk_sgns_gen_step.recordings = 0
walk_sgns_gen_step.instantiations = 0
walk_sgns_gen_step.updates = 0
walk_sgns_gen_step.replays = 0
