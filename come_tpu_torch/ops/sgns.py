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

The tables are updated IN PLACE and returned.
"""

from __future__ import annotations

import torch

from come_tpu_torch.losses.sgns_block import sgns_block_grads_from_rows
from come_tpu_torch.ops import build
from come_tpu_torch.ops.sparse import scatter_add_rows_
from come_tpu_torch.ops.walk_sgns import check_cuda_inputs

TILE_PAIRS = 1024
BLK = 128  # rows per CTA of the kernels' negative pass


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


def _launch(name, tables, centers, contexts, pool, mask, lr, negw, TP):
    """Run the C entry ``name`` on CUDA tensors; returns (loss, n_pairs)."""
    check_cuda_inputs(tables[0], tables[-1], centers, contexts, pool, mask)
    if TP < 1:
        raise ValueError(f"tile_pairs {TP} < 1")
    # BLK extra ids: the negative pass reads whole 128-row chunks of a tile
    cxm, n_tiles = _tiles(centers, contexts, mask, TP, extra=BLK)
    pool = pool.to(torch.int32).contiguous()
    V, d = tables[0].shape
    KP = pool.shape[0]
    TPr = -(-TP // BLK) * BLK
    dev = tables[0].device
    f32 = torch.float32
    stats = torch.zeros(2, dtype=torch.float64, device=dev)
    cneg = torch.empty((KP, d), dtype=f32, device=dev)
    dneg = torch.empty((KP, d), dtype=f32, device=dev)
    dphi = torch.empty((TPr, d), dtype=f32, device=dev)
    dcpos = torch.empty((TPr, d), dtype=f32, device=dev)
    nt = torch.empty((TPr,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = getattr(build.library(), name)(
        *(t.data_ptr() for t in tables), cxm[0].data_ptr(),
        cxm[1].data_ptr(), cxm[2].data_ptr(), pool.data_ptr(),
        stats.data_ptr(), cneg.data_ptr(), dneg.data_ptr(), dphi.data_ptr(),
        dcpos.data_ptr(), nt.data_ptr(), d, n_tiles, TP, KP, float(lr),
        float(negw), stream,
    )
    build.check(code, name)
    st = stats.to(f32)
    return st[0], st[1]


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
    version; CUDA tensors launch the kernel (counted in
    ``fused_sgns_step.launches``) or raise.
    """
    if emb_in.device.type == "cpu":
        return fused_sgns_step_reference(
            emb_in, emb_out, centers, contexts, pool, mask, lr, negw,
            tile_pairs=tile_pairs,
        )
    if emb_in.device.type != "cuda":
        raise ValueError(f"no fused_sgns kernel for device {emb_in.device}")
    loss, npairs = _launch("come_fused_sgns_step", (emb_in, emb_out),
                           centers, contexts, pool, mask, lr, negw,
                           int(tile_pairs))
    fused_sgns_step.launches += 1
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
    loss, npairs = _launch("come_fused_sgns_step_tied", (emb,), centers,
                           contexts, pool, mask, lr, negw, int(tile_pairs))
    fused_sgns_step_tied.launches += 1
    return emb, loss, npairs


fused_sgns_step.launches = 0
fused_sgns_step_tied.launches = 0
