"""Walk-banded SGNS macro step (O1): the CUDA kernel, its plain version and
the wrapper that picks between them by device.

Port of ``come_tpu/ops/pallas_walk_sgns.py::fused_walk_sgns_step`` with f32
tables (kernel source: ``csrc/walk_sgns.cu``).  Walks come in groups of 8
(1024 slots, each walk padded to 128 positions); groups run in order, so
group g+1 sees group g's update, and one shared negative pool serves each
block of R groups (staged at its start, its gradient applied at its end).

Differences from the JAX function, both deliberate:
  * the reduced-window draws are an input, ``wrow`` int32 [G*1024] in
    {1..W} (clamped to W), instead of the TPU's in-kernel PRNG, so every
    implementation can be fed the same draws;
  * the tables are updated IN PLACE (no second [V, d] copy per step) and
    returned.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from come_tpu_torch.ops import build

LP = 128  # slots per walk (walks are padded to this many positions)
NW = 8  # walks per group
NWL = LP * NW  # slots per group


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


def walk_sgns_step_reference(emb_in, emb_out, walks, wrow, pools, lr, negw,
                             *, window: int, pool_refresh: int = 1):
    """Plain PyTorch version of :func:`walk_sgns_step` (same signature and
    semantics): a loop over groups with dense per-walk [128, 128] band
    scores.  Returns (emb_in, emb_out, loss, n_pairs)."""
    B, L = walks.shape
    slots = pad_walks(walks).long()
    G = slots.shape[0] // NWL
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R).long()
    wrow = wrow.reshape(G, NW, LP).clamp(max=window)
    dev = emb_in.device
    pos = torch.arange(LP, device=dev)
    off = pos[None, :] - pos[:, None]  # [t, u] = u - t
    valid = (pos[:, None] < L) & (pos[None, :] < L) & (off != 0)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    npairs = torch.zeros((), dtype=torch.float32, device=dev)
    d = emb_in.shape[1]
    for g in range(G):
        if g % R == 0:
            pool = pools[g // R]
            cneg = emb_out[pool].clone()
            dneg = torch.zeros_like(cneg)
        ids = slots[g * NWL:(g + 1) * NWL]
        phi = emb_in[ids].view(NW, LP, d)
        ctx = emb_out[ids].view(NW, LP, d)
        m = (valid[None] & (off.abs()[None] <= wrow[g][:, :, None])).float()
        s = phi @ ctx.transpose(1, 2)  # [NW, t, u]
        gpos = (torch.sigmoid(s) - 1.0) * m
        loss = loss - (m * F.logsigmoid(s)).sum()
        n_t = m.sum(2, keepdim=True)  # [NW, LP, 1]
        npairs = npairs + n_t.sum()
        dphi = gpos @ ctx
        dctx = gpos.transpose(1, 2) @ phi
        sn = phi @ cneg.T  # [NW, LP, KP]
        gneg = torch.sigmoid(sn) * (negw * n_t)
        loss = loss - negw * (n_t * F.logsigmoid(-sn)).sum()
        dphi = dphi + gneg @ cneg
        dneg = dneg + torch.einsum("bsk,bsd->kd", gneg, phi)
        emb_in.index_add_(0, ids, dphi.reshape(NWL, d), alpha=-lr)
        emb_out.index_add_(0, ids, dctx.reshape(NWL, d), alpha=-lr)
        if g % R == R - 1 or g == G - 1:
            emb_out.index_add_(0, pool, dneg, alpha=-lr)
    return emb_in, emb_out, loss, npairs


def check_cuda_inputs(*tensors):
    """Raise unless every tensor shares one device, the first two (the
    tables) are contiguous float32, and d fits the kernels (<= 192)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    for t in tensors[:2]:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("tables must be contiguous float32")
    d = tensors[0].shape[1]
    if d > 192:
        raise ValueError(f"dim {d} > 192 exceeds the kernels' shared memory")


def walk_sgns_step(emb_in, emb_out, walks, wrow, pools, lr, negw, *,
                   window: int, pool_refresh: int = 1):
    """One O1 macro step over ``walks`` [B, L] (L <= 128).

    Args:
      emb_in, emb_out: [V, d] float32 node and context tables, updated in
        place.
      walks: int [B, L] node ids; B wraps up to a multiple of 8 walks.
      wrow: int32 [G*1024] window draws per padded slot, in {1..window}.
      pools: int [ceil(G / pool_refresh), KP] negative pools (or [KP]).
      lr, negw: step size and negative weight (k / KP), Python floats.

    Returns (emb_in, emb_out, loss, n_pairs); loss and n_pairs are 0-dim
    float32 tensors on the tables' device.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (counted in
    ``walk_sgns_step.launches``) or raise.
    """
    if emb_in.device.type == "cpu":
        return walk_sgns_step_reference(
            emb_in, emb_out, walks, wrow, pools, lr, negw, window=window,
            pool_refresh=pool_refresh,
        )
    if emb_in.device.type != "cuda":
        raise ValueError(f"no walk_sgns kernel for device {emb_in.device}")
    check_cuda_inputs(emb_in, emb_out, walks, wrow, pools)
    B, L = walks.shape
    slots = pad_walks(walks)
    G = slots.shape[0] // NWL
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R)
    wrow = wrow.to(torch.int32).contiguous()
    if wrow.numel() != G * NWL:
        raise ValueError(f"wrow has {wrow.numel()} draws, need {G * NWL}")
    V, d = emb_in.shape
    KP = pools.shape[1]
    dev = emb_in.device
    f32 = torch.float32
    stats = torch.zeros(2, dtype=torch.float64, device=dev)
    cneg = torch.empty((KP, d), dtype=f32, device=dev)
    dneg = torch.empty((KP, d), dtype=f32, device=dev)
    dphi = torch.empty((NWL, d), dtype=f32, device=dev)
    dctx = torch.empty((NWL, d), dtype=f32, device=dev)
    nt = torch.empty((NWL,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = build.library().come_walk_sgns_step(
        emb_in.data_ptr(), emb_out.data_ptr(), slots.data_ptr(),
        wrow.data_ptr(), pools.data_ptr(), stats.data_ptr(),
        cneg.data_ptr(), dneg.data_ptr(), dphi.data_ptr(), dctx.data_ptr(),
        nt.data_ptr(), d, G, L, int(window), KP, R, float(lr), float(negw),
        stream,
    )
    walk_sgns_step.launches += 1
    build.check(code, "come_walk_sgns_step")
    st = stats.to(f32)
    return emb_in, emb_out, st[0], st[1]


walk_sgns_step.launches = 0
