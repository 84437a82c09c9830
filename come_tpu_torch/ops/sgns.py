"""Flat SGNS micro-step against one shared negative pool (K6, and K7 on one
tied table): the CUDA kernels, their plain versions and the wrappers that
pick between them by device.

Port of ``come_tpu/ops/pallas_sgns.py::fused_sgns_step`` (K6, O1 in the
micro-batched tier) and ``fused_sgns_step_tied`` (K7, O2 per arc); kernel
source ``csrc/sgns_fused.cu``.  Semantics are the TPU kernels':

  * the P pairs pad to whole tiles of ``tile_pairs`` with masked pairs
    (ids 0); tiles run in order, each reading the tables as the previous
    tile left them, and pairs within a tile update synchronously
    (duplicate rows sum);
  * the KP pool rows are staged ONCE, from the tables at the start of the
    call; their gradient accumulates over every tile and is applied once,
    after the last tile;
  * masked pairs contribute nothing (the TPU zeroes them and subtracts
    their constant loss; the port skips them), so the loss is the sum over
    valid pairs and ``n_pairs`` the valid-pair count.

The tables are updated IN PLACE and returned.  On the card a micro-step is
one unit the card replays: the plan (``ops/launch_plan.py::FusedPlan``,
which also holds the packed pairs, the tiles' masks, the pool and the
scratch, so a call allocates no scratch) records the tile loop once as a
CUDA graph; a call sets the graph's first kernel's parameters (it packs the
call's pairs and pool into the plan's buffers) and replays it.

:func:`fused_sgns_scan` (and ``_tied``) applies a macro batch of
micro-steps, each against its own pool, as the JAX trainer's ``lax.scan``
over them does (``come_tpu/trainer/come.py:350``): on the card one launch
of a WHILE graph whose body is one recorded micro-step
(``launch_plan.ScanPlan``), on the CPU the loop of plain micro-steps.
"""

from __future__ import annotations

import torch

from come_tpu_torch.losses.sgns_block import sgns_block_grads_from_rows
from come_tpu_torch.ops import build, launch_plan
from come_tpu_torch.ops.sparse import scatter_add_rows_
from come_tpu_torch.ops.walk_sgns import check_cuda_inputs

TILE_PAIRS = 1024


def _tiles(centers, contexts, mask, TP: int, extra: int = 0):
    """int32 [3, n_tiles * TP + extra] (centers, contexts, mask != 0),
    zero-padded, and n_tiles."""
    P = centers.shape[0]
    n_tiles = -(-P // TP)
    out = torch.zeros((3, n_tiles * TP + extra), dtype=torch.int32,
                      device=centers.device)
    out[0, :P] = centers
    out[1, :P] = contexts
    out[2, :P] = mask != 0
    return out, n_tiles


def _plain(emb_in, emb_out, centers, contexts, pool, mask, lr, negw, TP,
           tied):
    cxm, n_tiles = _tiles(centers, contexts, mask, TP)
    cxm = cxm.long()
    pool = pool.long()
    cneg = emb_out[pool].clone()
    dneg = torch.zeros_like(cneg)
    loss = torch.zeros((), dtype=torch.float32, device=emb_in.device)
    npairs = torch.zeros((), dtype=torch.float32, device=emb_in.device)
    for t in range(n_tiles):
        c, x, m = cxm[:, t * TP:(t + 1) * TP]
        tl, tn, (d_phi, d_cpos, d_cneg) = sgns_block_grads_from_rows(
            emb_in[c], emb_out[x], cneg, m, negw
        )
        loss += tl
        npairs += tn
        dneg += d_cneg
        if tied:  # one scatter into the one table
            scatter_add_rows_(emb_in, torch.cat([c, x]),
                              torch.cat([d_phi, d_cpos]), -lr)
        else:
            scatter_add_rows_(emb_in, c, d_phi, -lr)
            scatter_add_rows_(emb_out, x, d_cpos, -lr)
    scatter_add_rows_(emb_out, pool, dneg, -lr)
    return loss, npairs


def fused_sgns_step_reference(emb_in, emb_out, centers, contexts, pool, mask,
                              lr, negw, *, tile_pairs: int = TILE_PAIRS):
    """Plain PyTorch version of :func:`fused_sgns_step` (same signature and
    semantics): a loop over tiles on :func:`sgns_block_grads_from_rows`.
    Returns (emb_in, emb_out, loss, n_pairs)."""
    loss, npairs = _plain(emb_in, emb_out, centers, contexts, pool, mask, lr,
                          negw, int(tile_pairs), tied=False)
    return emb_in, emb_out, loss, npairs


def fused_sgns_step_tied_reference(emb, centers, contexts, pool, mask, lr,
                                   negw, *, tile_pairs: int = TILE_PAIRS):
    """Plain PyTorch version of :func:`fused_sgns_step_tied`.  Returns
    (emb, loss, n_pairs)."""
    loss, npairs = _plain(emb, emb, centers, contexts, pool, mask, lr, negw,
                          int(tile_pairs), tied=True)
    return emb, loss, npairs


def fused_plan(device, stream: int, tied: int, d: int, TP: int, KP: int,
               n_tiles: int) -> launch_plan.FusedPlan:
    """The launch plan of a K6 (``tied`` 0) or K7 (1) micro-step, keyed on
    (tied, d, TP, KP, n_tiles)."""
    return launch_plan.fused_plan_for(
        "fused_sgns_tied" if tied else "fused_sgns", device, stream, tied, d,
        TP, KP, n_tiles)


def _ids(t):
    """``t`` as the C entries take ids: contiguous int32 or int64."""
    if t.dtype not in (torch.int32, torch.int64):
        t = t.long()
    return t.contiguous()


def _recorded(tables, negw: float) -> tuple:
    """What a K6/K7 recording holds besides its plan's buffers: the tables'
    addresses and ``negw``."""
    return tuple(t.data_ptr() for t in tables) + (float(negw),)


def fused_entry_args(plan, how: int, tables, centers, contexts, mask, pool,
                     lr: float, negw: float, stream: int) -> tuple:
    """The arguments of ``come_fused_sgns_step`` (two tables) or
    ``come_fused_sgns_step_tied`` (one) for one call: the plan's graph
    slot, buffers, scratch and argument block, and this call's tables,
    pairs (``centers`` and ``contexts`` of one dtype, int32 or int64;
    ``mask`` f32), pool (int32 or int64), ``lr`` and result, all
    contiguous; ``how`` is :meth:`FusedPlan.begin`'s."""
    st, cneg, dneg, dphi, dcpos, _ = plan.scratch()
    return ((plan.slot, how) + tuple(t.data_ptr() for t in tables)
            + (centers.data_ptr(), contexts.data_ptr(), mask.data_ptr(),
               pool.data_ptr(), centers.shape[0],
               int(centers.dtype == torch.int64),
               int(pool.dtype == torch.int64), plan.ids.data_ptr(),
               plan.nt.data_ptr(), plan.pool.data_ptr(), st,
               plan.out.data_ptr(), cneg, dneg, dphi, dcpos,
               plan.args.data_ptr(), plan.cneg.shape[1], plan.n_tiles,
               plan.TP, plan.cneg.shape[0], float(lr), float(negw), stream))


def _inputs(tables, centers, contexts, pool, mask, kernel: str):
    """The call's pairs, mask and pool as the C entries take them: ids of
    one dtype (int32 or int64), the mask f32, all contiguous."""
    check_cuda_inputs(tables[0], tables[-1], centers, contexts, pool, mask,
                      kernel=kernel)
    c, x = _ids(centers), _ids(contexts)
    if c.dtype != x.dtype:
        c, x = c.long(), x.long()
    if mask.dtype != torch.float32:
        mask = mask.float()
    return c, x, mask.contiguous(), _ids(pool)


def _launch(fn, tables, centers, contexts, pool, mask, lr, negw, TP):
    """One micro-step on CUDA tensors through its launch plan: record the
    tile loop at the plan's first call (again if a table moved), set its
    first kernel's parameters (this call's pairs, pool, lr and result) and
    replay it (counted on ``fn``).  Returns (loss, n_pairs)."""
    if TP < 1:
        raise ValueError(f"tile_pairs {TP} < 1")
    P = centers.shape[0]
    if contexts.shape[0] != P or mask.shape[0] != P:
        raise ValueError(f"{P} centres, {contexts.shape[0]} contexts and "
                         f"{mask.shape[0]} mask values")
    c, x, mask, pool = _inputs(tables, centers, contexts, pool, mask,
                               "K7" if len(tables) == 1 else "K6")
    dev = tables[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    tied = int(len(tables) == 1)
    plan = fused_plan(dev, stream, tied, tables[0].shape[1], TP,
                      pool.shape[0], -(-P // TP))
    lib = build.library()
    plan.graph_slot(lib)
    how = plan.begin(_recorded(tables, negw))
    name = "come_fused_sgns_step_tied" if tied else "come_fused_sgns_step"
    code = getattr(lib, name)(*fused_entry_args(
        plan, how, tables, c, x, mask, pool, lr, negw, stream))
    fn.launches += 1
    build.check(code, name)
    plan.done(how, fn)
    return plan.result()


def fused_sgns_step(emb_in, emb_out, centers, contexts, pool, mask, lr, negw,
                    *, tile_pairs: int = TILE_PAIRS):
    """One micro-step of P pairs against one shared pool (K6, O1).

    Args:
      emb_in, emb_out: [V, d] float32 node and context tables, updated in
        place.
      centers, contexts: int [P] pair ends; mask: [P] (nonzero = valid).
      pool: int [KP] shared negative rows (of ``emb_out``).
      lr, negw: step size and negative weight (k / KP), Python floats.
      tile_pairs: pairs per sequential tile.

    Returns (emb_in, emb_out, loss, n_pairs); loss and n_pairs are 0-dim
    float32 tensors on the tables' device.  CPU tensors run the plain
    version; CUDA tensors launch the kernel, as one replayed graph
    (``ops/launch_plan.py``; counted in ``fused_sgns_step.launches``, and
    the graph's events in ``.recordings``, ``.instantiations``,
    ``.updates`` and ``.replays``) or raise.
    """
    if emb_in.device.type == "cpu":
        return fused_sgns_step_reference(
            emb_in, emb_out, centers, contexts, pool, mask, lr, negw,
            tile_pairs=tile_pairs,
        )
    if emb_in.device.type != "cuda":
        raise ValueError(f"no fused_sgns kernel for device {emb_in.device}")
    loss, npairs = _launch(fused_sgns_step, (emb_in, emb_out), centers,
                           contexts, pool, mask, lr, negw, int(tile_pairs))
    return emb_in, emb_out, loss, npairs


def fused_sgns_step_tied(emb, centers, contexts, pool, mask, lr, negw, *,
                         tile_pairs: int = TILE_PAIRS):
    """K6 on one tied table (K7, O2 per arc): both pair ends and the pool
    live in ``emb`` [V, d], updated in place.  Returns (emb, loss,
    n_pairs); CUDA launches are counted in
    ``fused_sgns_step_tied.launches``."""
    if emb.device.type == "cpu":
        return fused_sgns_step_tied_reference(
            emb, centers, contexts, pool, mask, lr, negw,
            tile_pairs=tile_pairs,
        )
    if emb.device.type != "cuda":
        raise ValueError(f"no fused_sgns_tied kernel for device {emb.device}")
    loss, npairs = _launch(fused_sgns_step_tied, (emb,), centers, contexts,
                           pool, mask, lr, negw, int(tile_pairs))
    return emb, loss, npairs


# -------------------------------------------- a macro batch as one launch

def scan_plan(device, stream: int, tied: int, d: int, TP: int, KP: int,
              n_tiles: int) -> launch_plan.ScanPlan:
    """The launch plan of a K6 (``tied`` 0) or K7 (1) scan, keyed on
    (tied, d, TP, KP, n_tiles) of one micro-step."""
    return launch_plan.fused_plan_for(
        "fused_scan_tied" if tied else "fused_scan", device, stream, tied, d,
        TP, KP, n_tiles)


def _scan_loop(plan, lib, tables, negw: float) -> None:
    """Record ``plan``'s WHILE graph (``come_fused_scan_record``) on its
    tables."""
    import ctypes

    plan.release_loop(lib)
    handle = ctypes.c_ulonglong(0)
    with torch.cuda.device(plan.device):
        plan.loop = lib.come_while_graph_new(ctypes.byref(handle))
    if not plan.loop:
        raise RuntimeError("come_while_graph_new: no WHILE graph (the CUDA "
                           "runtime must be 12.4 or later)")
    st, cneg, dneg, dphi, dcpos, _ = plan.scratch()
    build.check(lib.come_fused_scan_record(
        plan.slot, plan.loop, handle.value, tables[0].data_ptr(),
        tables[-1].data_ptr(), plan.ids.data_ptr(), plan.nt.data_ptr(),
        plan.pool.data_ptr(), st, cneg, dneg, dphi, dcpos,
        plan.args.data_ptr(), plan.cneg.shape[1], plan.n_tiles, plan.TP,
        plan.cneg.shape[0], float(negw)), "come_fused_scan_record")


def _scan(fn, step, tables, centers, contexts, pools, mask, lr, negw, TP):
    """A macro batch of micro-steps: centers, contexts, mask [n_micro, mb],
    pools [n_micro, KP].  On the CPU the loop of ``step`` (the plain
    micro-steps), summing (loss, n_pairs) in order; on the card one launch
    of the plan's WHILE graph (counted on ``fn``: one replay, and
    ``n_micro`` micro-steps on ``step.launches``).  Returns (loss,
    n_pairs)."""
    n_micro = centers.shape[0]
    if centers.dim() != 2 or contexts.shape != centers.shape \
            or mask.shape != centers.shape or pools.dim() != 2 \
            or pools.shape[0] != n_micro:
        raise ValueError(f"a scan takes pairs [n_micro, mb] and pools "
                         f"[n_micro, KP]: {tuple(centers.shape)}, "
                         f"{tuple(contexts.shape)}, {tuple(mask.shape)}, "
                         f"{tuple(pools.shape)}")
    dev = tables[0].device
    if dev.type == "cpu":
        tot_loss = torch.zeros((), device=dev)
        tot_pairs = torch.zeros((), device=dev)
        for i in range(n_micro):
            *_, loss, npairs = step(*tables, centers[i], contexts[i],
                                    pools[i], mask[i], lr, negw,
                                    tile_pairs=TP)
            tot_loss += loss
            tot_pairs += npairs
        return tot_loss, tot_pairs
    if dev.type != "cuda":
        raise ValueError(f"no fused_sgns scan for device {dev}")
    if TP < 1:
        raise ValueError(f"tile_pairs {TP} < 1")
    tied = int(len(tables) == 1)
    c, x, mask, pools = _inputs(tables, centers, contexts, pools, mask,
                                "K7" if tied else "K6")
    mb = c.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = scan_plan(dev, stream, tied, tables[0].shape[1], TP,
                     pools.shape[1], -(-mb // TP))
    lib = build.library()
    plan.graph_slot(lib)
    how = plan.begin(_recorded(tables, negw))
    if how != launch_plan.RECORD_NONE:
        _scan_loop(plan, lib, tables, negw)
    code = lib.come_fused_scan_launch(
        plan.loop, plan.args.data_ptr(), c.data_ptr(), x.data_ptr(),
        mask.data_ptr(), pools.data_ptr(), mb, n_micro,
        int(c.dtype == torch.int64), int(pools.dtype == torch.int64),
        plan.n_tiles, TP, float(lr), plan.out.data_ptr(), stream)
    step.launches += n_micro
    build.check(code, "come_fused_scan_launch")
    plan.done(how, fn)
    return plan.result()


def fused_sgns_scan(emb_in, emb_out, centers, contexts, pools, mask, lr,
                    negw, *, tile_pairs: int = TILE_PAIRS):
    """A macro batch of K6 micro-steps: micro-step i applies
    :func:`fused_sgns_step` to the pairs ``centers[i]``, ``contexts[i]``,
    ``mask[i]`` ([n_micro, mb] each) against the pool ``pools[i]``
    ([n_micro, KP]), in order, each reading the tables as the last left
    them (``come_tpu/trainer/come.py:350``'s ``lax.scan``).

    Returns (emb_in, emb_out, loss, n_pairs), the sums over the
    micro-steps.  CPU tensors run the loop of plain micro-steps; CUDA
    tensors launch the whole batch as one WHILE graph
    (``launch_plan.ScanPlan``; counted in ``fused_sgns_scan.replays`` and
    the other graph counters, and as ``n_micro`` micro-steps in
    ``fused_sgns_step.launches``) or raise: a runtime without conditional
    graph nodes (CUDA < 12.4) raises.
    """
    loss, npairs = _scan(fused_sgns_scan, fused_sgns_step, (emb_in, emb_out),
                         centers, contexts, pools, mask, lr, negw,
                         int(tile_pairs))
    return emb_in, emb_out, loss, npairs


def fused_sgns_scan_tied(emb, centers, contexts, pools, mask, lr, negw, *,
                         tile_pairs: int = TILE_PAIRS):
    """:func:`fused_sgns_scan` of K7 micro-steps on one tied table.
    Returns (emb, loss, n_pairs); micro-steps counted in
    ``fused_sgns_step_tied.launches``."""
    loss, npairs = _scan(fused_sgns_scan_tied, fused_sgns_step_tied, (emb,),
                         centers, contexts, pools, mask, lr, negw,
                         int(tile_pairs))
    return emb, loss, npairs


for _fn in (fused_sgns_step, fused_sgns_step_tied, fused_sgns_scan,
            fused_sgns_scan_tied):
    _fn.launches = 0
    # the graph's events (ops/launch_plan.py)
    _fn.recordings = _fn.instantiations = _fn.updates = _fn.replays = 0
del _fn
