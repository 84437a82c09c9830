"""P3, the star kernel's section-cost probe: the CUDA kernel, its plain
version and the wrapper that picks between them by device.

Port of ``scripts/probe_star.py`` (``_kern :33``, ``step :163``, its
``pallas_call :211``): K2b's group loop (``ops/star_sgns.py`` with
``mxu_bf16``, kernel source ``csrc/star_probe.cu``) cut into five sections
that switch off one by one, to attribute a group's time by subtraction:

  gather   phi = emb[slots] for the group's 1024 slots
  math     the positive pass on phi and, with ``neg``, the negative pass
           against the staged pool: dphi, the pair counts, the loss
  neg      the negative pass inside ``math``
  scatter  emb[slots] -= lr * dphi, every slot
  pool     stage the pool rows at an R-block start, apply their gradient at
           its end

``unroll`` is the rows a warp keeps in flight in the gather and scatter
(8, 16, 32, 64 or 128; the TPU's loop unroll); it does not change the
result.  With every section on the step is K2b's (or K2's, with
``mxu_bf16=False``).  A section that is off leaves its buffers as they were
made: phi, dphi, the pair counts and the pool rows and gradient start at
zero once per call (the TPU's scratch would hold whatever was there, so only
the variants that read nothing unwritten compare with the TPU probe).  The
variants are not training steps; they exist to locate the cost.  The table
is updated IN PLACE and returned.
"""

from __future__ import annotations

import torch

from come_tpu_torch.ops import build
from come_tpu_torch.ops.star_sgns import NWL, _pad_stream, star_group_grads
from come_tpu_torch.ops.walk_sgns import check_cuda_inputs, expand_pools, mxu

SECTIONS = ("gather", "math", "neg", "scatter", "pool")
UNROLLS = (8, 16, 32, 64, 128)


def star_probe_step_reference(emb, slots, meta, pools, lr, negw, *,
                              pool_refresh: int = 1, mxu_bf16: bool = True,
                              gather: bool = True, math: bool = True,
                              neg: bool = True, scatter: bool = True,
                              pool: bool = True, unroll: int = 32):
    """Plain PyTorch version of :func:`star_probe_step` (same signature and
    semantics; ``unroll`` is not read).  Returns (emb, loss, n_pairs)."""
    slots, meta, G = _pad_stream(slots, meta)
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R).long()
    d = emb.shape[1]
    dev = emb.device
    # the buffers start at zero; a section that is off leaves them so
    phi = torch.zeros((NWL, d), dtype=torch.float32, device=dev)
    dphi = torch.zeros_like(phi)
    cneg = torch.zeros((pools.shape[1], d), dtype=torch.float32, device=dev)
    dneg = torch.zeros_like(cneg)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    npairs = torch.zeros((), dtype=torch.float32, device=dev)
    for g in range(G):
        pool_ids = pools[g // R]
        if pool and g % R == 0:
            cneg = mxu(emb[pool_ids], mxu_bf16)
            dneg = torch.zeros_like(cneg)
        ids = slots[g * NWL:(g + 1) * NWL].long()
        if gather:
            phi = emb[ids]
        if math:
            dphi, ddneg, lpos, lneg, n = star_group_grads(
                phi, meta[g * NWL:(g + 1) * NWL], cneg, negw, mxu_bf16, neg)
            loss = loss - lpos
            npairs = npairs + n
            if neg:
                loss = loss - lneg
                dneg = dneg + ddneg
        if scatter:
            emb.index_add_(0, ids, dphi, alpha=-lr)
        if pool and (g % R == R - 1 or g == G - 1):
            emb.index_add_(0, pool_ids, dneg, alpha=-lr)
    return emb, loss, npairs


def star_probe_step(emb, slots, meta, pools, lr, negw, *,
                    pool_refresh: int = 1, mxu_bf16: bool = True,
                    gather: bool = True, math: bool = True, neg: bool = True,
                    scatter: bool = True, pool: bool = True,
                    unroll: int = 32):
    """One probe step over a star slot stream (arguments as
    :func:`ops.star_sgns.star_sgns_step`, plus the section switches and
    ``unroll``; d a multiple of 4 on the card).

    Returns (emb, loss, n_pairs); loss and n_pairs are 0-dim float32
    tensors on the table's device.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (counted in ``star_probe_step.launches``) or
    raise.
    """
    flags = dict(gather=gather, math=math, neg=neg, scatter=scatter,
                 pool=pool)
    if emb.device.type == "cpu":
        return star_probe_step_reference(
            emb, slots, meta, pools, lr, negw, pool_refresh=pool_refresh,
            mxu_bf16=mxu_bf16, unroll=unroll, **flags,
        )
    if emb.device.type != "cuda":
        raise ValueError(f"no star probe kernel for device {emb.device}")
    check_cuda_inputs(emb, emb, slots, meta, pools)
    if slots.shape != meta.shape:
        raise ValueError(f"slots {tuple(slots.shape)} and meta "
                         f"{tuple(meta.shape)} differ")
    if emb.shape[1] % 4 or unroll not in UNROLLS:
        raise ValueError(f"the probe takes d % 4 == 0 and unroll in "
                         f"{UNROLLS}, got {emb.shape[1]} and {unroll}")
    slots, meta, G = _pad_stream(slots, meta)
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R)
    d = emb.shape[1]
    KP = pools.shape[1]
    dev = emb.device
    f32 = torch.float32
    stats = torch.zeros(2, dtype=torch.float64, device=dev)
    phi = torch.zeros((NWL, d), dtype=f32, device=dev)
    dphi = torch.zeros((NWL, d), dtype=f32, device=dev)
    nt = torch.zeros((NWL,), dtype=f32, device=dev)
    cneg = torch.zeros((KP, d), dtype=f32, device=dev)
    dneg = torch.zeros((KP, d), dtype=f32, device=dev)
    iota = torch.arange(NWL, dtype=torch.int32, device=dev)
    sections = sum(1 << i for i, s in enumerate(SECTIONS) if flags[s])
    code = build.library().come_star_probe_step(
        emb.data_ptr(), slots.data_ptr(), meta.data_ptr(), pools.data_ptr(),
        iota.data_ptr(), stats.data_ptr(), phi.data_ptr(), cneg.data_ptr(),
        dneg.data_ptr(), dphi.data_ptr(), nt.data_ptr(), d, G, KP, R,
        int(mxu_bf16), sections, int(unroll), float(lr), float(negw),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    star_probe_step.launches += 1
    build.check(code, "come_star_probe_step")
    st = stats.to(f32)
    return emb, st[0], st[1]


star_probe_step.launches = 0
