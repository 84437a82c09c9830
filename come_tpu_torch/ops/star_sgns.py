"""Star fan-out tied SGNS macro step (O2): the CUDA kernel, its plain
version and the wrapper that picks between them by device.

Port of ``come_tpu/ops/pallas_star_sgns.py::fused_star_sgns_step`` (kernel
source: ``csrc/star_sgns.cu``): K2, and K2b with ``mxu_bf16`` (product
operands rounded to bf16, f32 sums).  The slot stream comes from
``sampling.stars.build_star_layout``; groups of 1024 slots (eight 128-slot
rows) run in order, and one shared negative pool serves each block of R
groups.  The table is updated IN PLACE and returned.  On the card a macro
step is one unit the card replays: the step's launch plan
(``ops/launch_plan.py``) records the group loop once as a CUDA graph, and a
call sets its head kernel's parameters (the call's slots, meta, pools and
lr) and replays it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from come_tpu_torch.ops import build, launch_plan
from come_tpu_torch.ops.walk_sgns import (
    check_cuda_inputs,
    count_pool_passes,
    count_route,
    expand_pools,
    mxu,
    new_pools,
    new_routes,
)
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


def star_plan(device, stream: int, bf16: int, d: int, G: int, KP: int,
              R: int) -> launch_plan.LaunchPlan:
    """The launch plan of a star step, keyed on the mode (bf16) and the
    shape (d, G, KP, R); its staged inputs: the slots, meta and pools; its
    chains, as a walk step's: the pools' (3 int32 a pool draw:
    ``csrc/sgns_common.cuh``'s pool_chains_kernel), the groups' real
    slots' (3 int32 a slot: ``csrc/owned_writes.cuh``'s slot_chains_kernel
    on the meta) and the block ends' fold chains (1 int32 a slot, then 1 a
    pool draw: fold_chains_kernel), which its slot and pool writes
    follow."""
    pools = -(-G // R) * KP
    return launch_plan.plan_for(
        "star_sgns", device, stream, (bf16,), (d, G, KP, R), KP=KP, d=d,
        ctx=False, inputs={"slots": G * NWL, "meta": G * NWL,
                           "pools": pools},
        chains=4 * (pools + G * NWL))


def star_entry_args(plan, how: int, emb, slots, meta, pools, d: int, G: int,
                    KP: int, R: int, bf16: int, lr: float, negw: float,
                    stream: int) -> tuple:
    """The arguments of ``come_star_sgns_step`` for one step: the plan's
    graph slot, scratch, staged inputs and argument block, and this step's
    own tensors and ``lr``; ``how`` is :meth:`LaunchPlan.begin`'s."""
    st, cneg, dneg, dphi, _, nt = plan.scratch()
    return ((plan.slot, how, emb.data_ptr(), slots.data_ptr(),
             meta.data_ptr(), pools.data_ptr(), st, cneg, dneg, dphi, nt)
            + plan.staged("slots", "meta", "pools")
            + (plan.args.data_ptr(), plan.chains.data_ptr(), d, G, KP, R,
               bf16, float(lr), float(negw), stream))


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
    tensors run the plain version; CUDA tensors launch the kernel, as one
    replayed graph (``ops/launch_plan.py``; counted in
    ``star_sgns_step.launches``, K2, or ``.launches_bf16``, K2b, and the
    graph's events in ``.recordings``, ``.instantiations``, ``.updates`` and
    ``.replays``; steps by the star pass's route in ``.routes``,
    ``ops/walk_sgns.py``'s POS_ROUTES; the pool and slot passes its steps
    launched in ``.pools``, by POOL_PASSES: once a step the pool, star and
    fold chains, once a group the star scatter or, at an R-block end, the
    star block-end scatter with the pool write in it) or raise.
    """
    if emb.device.type == "cpu":
        return star_sgns_step_reference(
            emb, slots, meta, pools, lr, negw, pool_refresh=pool_refresh,
            mxu_bf16=mxu_bf16,
        )
    if emb.device.type != "cuda":
        raise ValueError(f"no star_sgns kernel for device {emb.device}")
    check_cuda_inputs(emb, emb, slots, meta, pools,
                      kernel="K2b" if mxu_bf16 else "K2")
    slots, meta, G = _pad_stream(slots, meta)
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R)
    d = emb.shape[1]
    KP = pools.shape[1]
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    plan = star_plan(emb.device, stream, int(mxu_bf16), d, G, KP, R)
    lib = build.library()
    plan.graph_slot(lib)
    how = plan.begin((emb.data_ptr(), float(negw)))
    code = lib.come_star_sgns_step(*star_entry_args(
        plan, how, emb, slots, meta, pools, d, G, KP, R, int(mxu_bf16), lr,
        negw, stream))
    if mxu_bf16:
        star_sgns_step.launches_bf16 += 1
    else:
        star_sgns_step.launches += 1
    build.check(code, "come_star_sgns_step")
    count_route(plan, how, star_sgns_step, lib)
    count_pool_passes(plan, how, lib, star_sgns_step)
    plan.done(how, star_sgns_step)
    return (emb,) + plan.result()


star_sgns_step.launches = 0
star_sgns_step.launches_bf16 = 0
star_sgns_step.routes = new_routes()
star_sgns_step.pools = new_pools()
star_sgns_step.recordings = 0
star_sgns_step.instantiations = 0
star_sgns_step.updates = 0
star_sgns_step.replays = 0
