"""Star fan-out tied SGNS macro step (O2): the CUDA kernel, its plain
version and the wrapper that picks between them by device.

Port of ``come_tpu/ops/pallas_star_sgns.py::fused_star_sgns_step`` (kernel
source: ``csrc/star_sgns.cu``): K2, and K2b with ``mxu_bf16`` (product
operands rounded to bf16, f32 sums).  The slot stream comes from
``sampling.stars.build_star_layout``; groups of 1024 slots (eight 128-slot
rows) run in order, and one shared negative pool serves each block of R
groups.  The table is updated IN PLACE and returned.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from come_tpu_torch.ops import build
from come_tpu_torch.ops.walk_sgns import check_cuda_inputs, expand_pools, mxu
from come_tpu_torch.sampling.stars import PAD_META

BLK = 128  # slots per star row: pairs never cross a row
NWL = 1024  # slots per group


def _pad_stream(slots: torch.Tensor, meta: torch.Tensor):
    T = slots.shape[0]
    G = -(-T // NWL)
    pad = G * NWL - T
    slots = F.pad(slots, (0, pad)).to(torch.int32).contiguous()
    meta = F.pad(meta, (0, pad), value=PAD_META).to(torch.int32).contiguous()
    return slots, meta, G


def star_group_grads(phi, mt, cneg, negw, mxu_bf16: bool, neg: bool = True):
    """One group's gradients as ``_star_kernel`` computes them, with dense
    [128, 128] block scores: ``phi`` [1024, d] the group's rows as read,
    ``mt`` [1024] their meta, ``cneg`` [KP, d] the staged pool rows (already
    rounded in the bf16 mode).  ``mxu_bf16`` rounds phi, each pair g and
    each negative g where the TPU casts to bf16; ``neg`` False skips the
    negative pass.  Returns (dphi [1024, d], the pool gradient's increment
    [KP, d] or None, the positive and the negative log-sigmoid sums, whose
    negatives are the loss, and the pair count)."""
    nb = NWL // BLK
    d = phi.shape[1]
    mt = mt.view(nb, BLK)
    seg, hub = mt >> 1, mt & 1
    m = (
        (seg[:, :, None] == seg[:, None, :])
        & ((hub[:, :, None] ^ hub[:, None, :]) == 1)
    ).float()  # [nb, a, b]
    phi = mxu(phi.view(nb, BLK, d), mxu_bf16)
    s = phi @ phi.transpose(1, 2)
    gpos = mxu((torch.sigmoid(s) - 1.0) * m, mxu_bf16)
    lpos = (m * F.logsigmoid(s)).sum()
    n_t = m.sum(2, keepdim=True)
    dphi = gpos @ phi + gpos.transpose(1, 2) @ phi  # source + context
    lneg = ddneg = None
    if neg:
        sn = phi @ cneg.T
        gneg = mxu(torch.sigmoid(sn) * (negw * n_t), mxu_bf16)
        lneg = negw * (n_t * F.logsigmoid(-sn)).sum()
        dphi = dphi + gneg @ cneg
        ddneg = torch.einsum("bsk,bsd->kd", gneg, phi)
    return dphi.reshape(NWL, d), ddneg, lpos, lneg, n_t.sum()


def star_sgns_step_reference(emb, slots, meta, pools, lr, negw, *,
                             pool_refresh: int = 1, mxu_bf16: bool = False):
    """Plain PyTorch version of :func:`star_sgns_step` (same signature and
    semantics): a loop over groups of :func:`star_group_grads`.
    ``mxu_bf16`` rounds phi, each pair g, the pool rows and each negative g
    where ``_star_kernel`` casts to bf16.  Returns (emb, loss, n_pairs)."""
    slots, meta, G = _pad_stream(slots, meta)
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R).long()
    dev = emb.device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    npairs = torch.zeros((), dtype=torch.float32, device=dev)
    for g in range(G):
        if g % R == 0:
            pool = pools[g // R]
            cneg = mxu(emb[pool], mxu_bf16)
            dneg = torch.zeros_like(cneg)
        ids = slots[g * NWL:(g + 1) * NWL].long()
        dphi, ddneg, lpos, lneg, n = star_group_grads(
            emb[ids], meta[g * NWL:(g + 1) * NWL], cneg, negw, mxu_bf16)
        loss = loss - lpos
        npairs = npairs + n
        loss = loss - lneg
        dneg = dneg + ddneg
        emb.index_add_(0, ids, dphi, alpha=-lr)
        if g % R == R - 1 or g == G - 1:
            emb.index_add_(0, pool, dneg, alpha=-lr)
    return emb, loss, npairs


def star_sgns_step(emb, slots, meta, pools, lr, negw, *,
                   pool_refresh: int = 1, mxu_bf16: bool = False):
    """One O2 macro step over a star slot stream.

    Args:
      emb: [V, d] float32 tied node table, updated in place.
      slots, meta: int [T] star layout stream (meta = seg*2 + hub, -2 at
        pads); T pads up to a multiple of 1024 with pad slots.
      pools: int [ceil(G / pool_refresh), KP] negative pools (or [KP]).
      lr, negw: step size and negative weight (k / KP), Python floats.
      mxu_bf16: round every product operand to bf16 (K2b), f32 sums.

    Returns (emb, loss, n_pairs), n_pairs == 2 * arcs in the stream; loss
    and n_pairs are 0-dim float32 tensors on the table's device.  CPU
    tensors run the plain version; CUDA tensors launch the kernel (counted
    in ``star_sgns_step.launches``, K2, or ``.launches_bf16``, K2b) or
    raise.
    """
    if emb.device.type == "cpu":
        return star_sgns_step_reference(
            emb, slots, meta, pools, lr, negw, pool_refresh=pool_refresh,
            mxu_bf16=mxu_bf16,
        )
    if emb.device.type != "cuda":
        raise ValueError(f"no star_sgns kernel for device {emb.device}")
    check_cuda_inputs(emb, emb, slots, meta, pools)
    slots, meta, G = _pad_stream(slots, meta)
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R)
    V, d = emb.shape
    KP = pools.shape[1]
    dev = emb.device
    f32 = torch.float32
    stats = torch.zeros(2, dtype=torch.float64, device=dev)
    cneg = torch.empty((KP, d), dtype=f32, device=dev)
    dneg = torch.empty((KP, d), dtype=f32, device=dev)
    dphi = torch.empty((2, NWL, d), dtype=f32, device=dev)  # star, negative
    nt = torch.empty((NWL,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = build.library().come_star_sgns_step(
        emb.data_ptr(), slots.data_ptr(), meta.data_ptr(), pools.data_ptr(),
        stats.data_ptr(), cneg.data_ptr(), dneg.data_ptr(), dphi.data_ptr(),
        nt.data_ptr(), d, G, KP, R, int(mxu_bf16), float(lr), float(negw),
        stream,
    )
    if mxu_bf16:
        star_sgns_step.launches_bf16 += 1
    else:
        star_sgns_step.launches += 1
    build.check(code, "come_star_sgns_step")
    st = stats.to(f32)
    return emb, st[0], st[1]


star_sgns_step.launches = 0
star_sgns_step.launches_bf16 = 0
