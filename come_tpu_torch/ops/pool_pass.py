"""The pool stage, the bf16 passes' stage past d 192, K3's pool chains and
K3's pool write alone: the CUDA kernels, their plain versions and the
wrappers that pick between them by device.

Port of the two pool phases of ``come_tpu/ops/pallas_walk_sgns.py``'s walk
kernel: ``_stage_pool`` (``:216``: the R-block's negative pool rows staged
in f32, bf16 tables widened; with ``mxu_bf16`` rounded to bf16 as
``cneg_m``) and ``_apply_pool`` on bf16 tables (``:405``: the pool's
gradient written back, row k of the pool in draw order, each element
rounded by ``_pack_row``).  On the card they are passes of the walk and
star steps' recorded group loops (``csrc/sgns_common.cuh``:
``stage_pool_kernel``; past d 192 in the bf16 modes
``stage_pool_bf16_kernel``, which stages the rows as the bf16 wide
negative pass reads them; ``apply_pool_bf16_kernel``, and once a K3 step
``pool_chains_kernel``, which sorts every block's pool into the chains of
draws the pool write follows); here each runs alone on given buffers
(``csrc/pool_pass.cu``), so a check can hold it against its plain version
bit for bit and time it.  The plain versions are
``ops/walk_sgns.py``'s :func:`pool_stage_reference` and
:func:`pool_apply_bf16_reference`, which ``walk_sgns_step_reference``
calls, and :func:`pool_stage_wide_bf16_reference` here (the plain step
rounds the f32 rows of :func:`pool_stage_reference` instead: the same
values, without the layout).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from come_tpu_torch.ops import build
from come_tpu_torch.ops.walk_sgns import (
    M32,
    pool_apply_bf16_reference,
    pool_sr_bits,
    pool_stage_reference,
)

_TYPES = (torch.float32, torch.bfloat16)


def _check(table, pool, kernel: str):
    if table.dtype not in _TYPES or not table.is_contiguous() or \
            table.dim() != 2:
        raise ValueError(f"{kernel}: table must be a contiguous [V, d] "
                         f"tensor of one of {_TYPES}")
    if pool.dim() != 1 or pool.device != table.device:
        raise ValueError(f"{kernel}: pool must be [KP] on {table.device}")


def pool_stage(table: torch.Tensor, pool: torch.Tensor):
    """(cneg, dneg): ``table[pool]`` widened to f32 and zeros, each [KP, d]
    f32, from ``table`` [V, d] f32 or bf16 and ``pool`` int [KP].

    CPU tensors run the plain version; CUDA tensors launch
    ``stage_pool_kernel`` or raise.  Launches are counted in
    ``pool_stage.launches`` (f32 tables) and ``.launches_bf16_tables``."""
    _check(table, pool, "pool_stage")
    if table.device.type == "cpu":
        return pool_stage_reference(table, pool.long())
    if table.device.type != "cuda":
        raise ValueError(f"no pool stage kernel for device {table.device}")
    pool = pool.to(torch.int32).contiguous()
    KP, d = pool.numel(), table.shape[1]
    cneg = torch.empty((KP, d), dtype=torch.float32, device=table.device)
    dneg = torch.empty_like(cneg)
    bf16 = table.dtype == torch.bfloat16
    code = build.library().come_pool_stage(
        table.data_ptr(), pool.data_ptr(), cneg.data_ptr(), dneg.data_ptr(),
        d, KP, int(bf16), torch.cuda.current_stream(table.device).cuda_stream)
    if bf16:
        pool_stage.launches_bf16_tables += 1
    else:
        pool_stage.launches += 1
    build.check(code, "come_pool_stage")
    return cneg, dneg


pool_stage.launches = 0
pool_stage.launches_bf16_tables = 0


# csrc/sgns_common.cuh: the bf16 wide negative pass's pool chunk (NEG_KC
# rows) and column slab (NEG_WHOLE)
NEG_KC = 32
NEG_WHOLE = 256


def core_off(R: int, r, c):
    """Element (r, c) of an R-row bf16 matrix in wgmma's core-matrix layout
    without swizzle (``csrc/sgns_common.cuh``: ``core_off``): 8 x 8 blocks
    of 8 rows of 8 contiguous elements, the blocks of a band of 8 columns
    one after another down the rows, the bands one after another.  ``r``
    and ``c`` ints or int tensors."""
    return ((c >> 3) * (R >> 3) + (r >> 3)) * 64 + (r & 7) * 8 + (c & 7)


def wide_row(d: int) -> int:
    """The width of a pool row as the bf16 wide pass reads it: whole slabs
    of NEG_WHOLE columns."""
    return -(-d // NEG_WHOLE) * NEG_WHOLE


def pool_stage_wide_bf16_reference(table, pool):
    """Plain version of :func:`pool_stage_wide_bf16` (``csrc/sgns_common.cuh``:
    ``stage_pool_bf16_kernel``): (cnegb, dneg).  ``cnegb`` bf16 [KP *
    wide_row(d)]: row k = ``table[pool[k]]`` rounded to bf16 (nearest even)
    with zeros past d; each whole chunk of NEG_KC rows one block a slab of
    NEG_WHOLE columns, in core layout (:func:`core_off` of NEG_KC rows), the
    blocks by chunk, then slab; the rows of a last, partial chunk after
    them, plain.  ``dneg`` f32 zeros [KP, d]."""
    KP, d = pool.numel(), table.shape[1]
    wd = wide_row(d)
    ns, whole = wd // NEG_WHOLE, KP // NEG_KC * NEG_KC
    rows = F.pad(table[pool.long()].float(), (0, wd - d)).to(torch.bfloat16)
    # [chunk, row block, row, slab, band, column] -> [chunk, slab, band,
    # row block, row, column]: core_off's order inside each block
    blocks = rows[:whole].view(whole // NEG_KC, NEG_KC // 8, 8, ns,
                               NEG_WHOLE // 8, 8).permute(0, 3, 4, 1, 2, 5)
    cnegb = torch.cat([blocks.reshape(-1), rows[whole:].reshape(-1)])
    return cnegb, torch.zeros((KP, d), dtype=torch.float32,
                              device=table.device)


def pool_stage_wide_bf16(table: torch.Tensor, pool: torch.Tensor):
    """(cnegb, dneg): the pool's rows ``table[pool]`` rounded to bf16 in the
    bf16 wide negative pass's layout (bf16 [KP * wide_row(d)],
    :func:`pool_stage_wide_bf16_reference`) and zeros [KP, d] f32, from
    ``table`` [V, d] f32 or bf16 and ``pool`` int [KP]: the stage the bf16
    modes take past d 192.

    CPU tensors run the plain version; CUDA tensors launch
    ``stage_pool_bf16_kernel`` or raise (counted in
    ``pool_stage_wide_bf16.launches``)."""
    _check(table, pool, "pool_stage_wide_bf16")
    if table.device.type == "cpu":
        return pool_stage_wide_bf16_reference(table, pool)
    if table.device.type != "cuda":
        raise ValueError(f"no pool stage kernel for device {table.device}")
    pool = pool.to(torch.int32).contiguous()
    KP, d = pool.numel(), table.shape[1]
    cnegb = torch.empty((KP * wide_row(d),), dtype=torch.bfloat16,
                        device=table.device)
    dneg = torch.empty((KP, d), dtype=torch.float32, device=table.device)
    code = build.library().come_pool_stage_wide_bf16(
        table.data_ptr(), pool.data_ptr(), cnegb.data_ptr(), dneg.data_ptr(),
        d, KP, int(table.dtype == torch.bfloat16),
        torch.cuda.current_stream(table.device).cuda_stream)
    pool_stage_wide_bf16.launches += 1
    build.check(code, "come_pool_stage_wide_bf16")
    return cnegb, dneg


pool_stage_wide_bf16.launches = 0


def pool_apply_bf16(table: torch.Tensor, pool: torch.Tensor,
                    dneg: torch.Tensor, lr: float, *, group: int,
                    sr_seed: int | None = None,
                    chains: tuple | None = None) -> torch.Tensor:
    """K3's pool write at the end of a block whose last group is ``group``:
    ``table[pool[k]] = round(f32(table[pool[k]]) + f32(dneg[k] * -lr))``
    for k in draw order, in place on ``table`` [V, d] bf16 (d even), from
    ``pool`` int [KP] and ``dneg`` f32 [KP, d]; rounded stochastically
    with ``sr_seed`` (:func:`pool_sr_bits`: the step's seed, 32 bits used)
    or truncated without.  Returns ``table``.

    CPU tensors run the plain version; CUDA tensors launch
    ``apply_pool_bf16_kernel`` on the pool's chains (``chains``, as
    :func:`pool_chains` gives them for ``pool``, or made here by it) or
    raise (counted in ``pool_apply_bf16.launches``)."""
    _check(table, pool, "pool_apply_bf16")
    KP, d = pool.numel(), table.shape[1]
    if table.dtype != torch.bfloat16 or d % 2:
        raise ValueError("pool_apply_bf16: table must be bf16 with an even d")
    if dneg.shape != (KP, d) or dneg.dtype != torch.float32 or \
            dneg.device != table.device:
        raise ValueError(f"pool_apply_bf16: dneg must be f32 [{KP}, {d}]")
    if table.device.type == "cpu":
        return pool_apply_bf16_reference(
            table, pool.long(), dneg, lr,
            pool_sr_bits(sr_seed, group, KP, d, table.device))
    if table.device.type != "cuda":
        raise ValueError(f"no pool write kernel for device {table.device}")
    info, order = pool_chains(pool) if chains is None else chains
    if info.shape != (1, KP, 2) or order.data_ptr() != \
            info.data_ptr() + 8 * KP:
        raise ValueError("pool_apply_bf16: chains must be pool_chains' of "
                         "this pool")
    pool = pool.to(torch.int32).contiguous()
    dneg = dneg.contiguous()
    sr = sr_seed is not None
    code = build.library().come_pool_apply_bf16(
        table.data_ptr(), pool.data_ptr(), dneg.data_ptr(), info.data_ptr(),
        d, KP, int(group), float(lr), int(sr),
        (int(sr_seed) & M32) if sr else 0,
        torch.cuda.current_stream(table.device).cuda_stream)
    pool_apply_bf16.launches += 1
    build.check(code, "come_pool_apply_bf16")
    return table


pool_apply_bf16.launches = 0


def pool_chains_reference(pools: torch.Tensor):
    """Plain version of :func:`pool_chains`."""
    pools = pools.long().reshape(-1, pools.shape[-1])
    n, KP = pools.shape
    order = torch.sort(pools, dim=1, stable=True).indices
    info = torch.zeros((n, KP, 2), dtype=torch.int64, device=pools.device)
    place = torch.arange(KP, device=pools.device)
    for b in range(n):
        ids = pools[b][order[b]]
        info[b, order[b], 0] = place
        _, counts = torch.unique_consecutive(ids, return_counts=True)
        heads = torch.cumsum(counts, 0) - counts
        info[b, order[b][heads], 1] = counts
    return info.to(torch.int32), order.to(torch.int32)


def pool_chains(pools: torch.Tensor):
    """The draws of each pool sorted into its rows' chains, as K3's pool
    write reads them: (info int32 [n, KP, 2], order int32 [n, KP]) for
    ``pools`` int [n, KP] (or [KP]): order[b] the pool's draws k in the
    order of a stable sort of its ids (a row's draws together, in
    increasing k), info[b, k] = (k's place in order[b], the row's draws
    at its first draw and 0 at the others).

    CPU tensors run the plain version; CUDA tensors launch
    ``pool_chains_kernel`` (one CTA a pool; the library refuses KP past its
    POOL_CHAIN_MAX) or raise
    (counted in ``pool_chains.launches``)."""
    pools = pools.reshape(-1, pools.shape[-1])
    if pools.device.type == "cpu":
        return pool_chains_reference(pools)
    if pools.device.type != "cuda":
        raise ValueError(f"no pool chains kernel for device {pools.device}")
    n, KP = pools.shape
    pools = pools.to(torch.int32).contiguous()
    chains = torch.empty((3 * n * KP,), dtype=torch.int32, device=pools.device)
    code = build.library().come_pool_chains(
        pools.data_ptr(), n, KP, chains.data_ptr(),
        torch.cuda.current_stream(pools.device).cuda_stream)
    pool_chains.launches += 1
    build.check(code, "come_pool_chains")
    return chains[:2 * n * KP].view(n, KP, 2), chains[2 * n * KP:].view(n, KP)


pool_chains.launches = 0
