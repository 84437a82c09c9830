"""Walk-banded SGNS macro step: the CUDA kernel, its plain version and the
wrappers that pick between them by device.

Port of ``come_tpu/ops/pallas_walk_sgns.py::fused_walk_sgns_step`` and
``fused_walk_sgns_gen_step`` with f32 tables (kernel source:
``csrc/walk_sgns.cu``), in the TPU kernel's modes for them: K1 (the banded
O1 step), K1b (``mxu_bf16``: product operands rounded to bf16, f32 sums),
K5 (``paired``: the O2 edge mode) and K4 (walks generated in the kernel
from the CSR and an input bit matrix).  Walks come in groups of 8 (1024
slots, each walk padded to 128 positions); groups run in order, so group
g+1 sees group g's update, and one shared negative pool serves each block
of R groups (staged at its start, its gradient applied at its end).

Differences from the JAX functions, both deliberate:
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


def mxu(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even) and widened back when ``bf16``:
    the TPU kernels' cast of a product operand to ``mxu_t``."""
    return x.to(torch.bfloat16).to(x.dtype) if bf16 else x


def walk_sgns_step_reference(emb_in, emb_out, walks, wrow, pools, lr, negw,
                             *, window: int, pool_refresh: int = 1,
                             mxu_bf16: bool = False, paired: bool = False):
    """Plain PyTorch version of :func:`walk_sgns_step` (same signature and
    semantics): a loop over groups with dense per-walk [128, 128] band
    scores.  ``mxu_bf16`` rounds phi, ctx, each band g, the pool rows and
    each negative g where the TPU kernel casts to bf16 (``paired`` keeps
    its positive pass f32, as the TPU does); ``paired`` trains only each
    slot's partner t^1 (``wrow`` and ``window`` are not read).  Returns
    (emb_in, emb_out, loss, n_pairs)."""
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
        band = (valid & (pos[None, :] == (pos[:, None] ^ 1))).float()[None]
    else:
        wrow = wrow.reshape(G, NW, LP).clamp(max=window)
    rnd = mxu_bf16 and not paired  # the paired positive pass is f32
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    npairs = torch.zeros((), dtype=torch.float32, device=dev)
    d = emb_in.shape[1]
    for g in range(G):
        if g % R == 0:
            pool = pools[g // R]
            cneg = mxu(emb_out[pool], mxu_bf16)
            dneg = torch.zeros_like(cneg)
        ids = slots[g * NWL:(g + 1) * NWL]
        phi = emb_in[ids].view(NW, LP, d)
        ctx = mxu(emb_out[ids].view(NW, LP, d), rnd)
        phi_p = mxu(phi, rnd)
        m = band if paired else (
            valid[None] & (off.abs()[None] <= wrow[g][:, :, None])).float()
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
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    for t in tensors[:2]:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("tables must be contiguous float32")
    d = tensors[0].shape[1]
    if d > 192:
        raise ValueError(f"dim {d} > 192 exceeds the kernels' shared memory")


class _Scratch:
    """Per-call device buffers of the walk kernel's C entries."""

    def __init__(self, dev, KP: int, d: int):
        f32 = torch.float32
        self.stats = torch.zeros(2, dtype=torch.float64, device=dev)
        self.cneg = torch.empty((KP, d), dtype=f32, device=dev)
        self.dneg = torch.empty((KP, d), dtype=f32, device=dev)
        self.dphi = torch.empty((NWL, d), dtype=f32, device=dev)
        self.dctx = torch.empty((NWL, d), dtype=f32, device=dev)
        self.nt = torch.empty((NWL,), dtype=f32, device=dev)

    def ptrs(self):
        return (self.stats.data_ptr(), self.cneg.data_ptr(),
                self.dneg.data_ptr(), self.dphi.data_ptr(),
                self.dctx.data_ptr(), self.nt.data_ptr())

    def result(self):
        st = self.stats.to(torch.float32)
        return st[0], st[1]


def _check_wrow(wrow, G):
    wrow = wrow.to(torch.int32).contiguous()
    if wrow.numel() != G * NWL:
        raise ValueError(f"wrow has {wrow.numel()} draws, need {G * NWL}")
    return wrow


def _count_walk_launch(mxu_bf16: bool, paired: bool) -> None:
    if paired:
        walk_sgns_step.launches_paired += 1
    elif mxu_bf16:
        walk_sgns_step.launches_bf16 += 1
    else:
        walk_sgns_step.launches += 1


def walk_sgns_step(emb_in, emb_out, walks, wrow, pools, lr, negw, *,
                   window: int, pool_refresh: int = 1,
                   mxu_bf16: bool = False, paired: bool = False):
    """One walk-kernel macro step over ``walks`` [B, L] (L <= 128).

    Args:
      emb_in, emb_out: [V, d] float32 node and context tables, updated in
        place.
      walks: int [B, L] node ids; B wraps up to a multiple of 8 walks.
        With ``paired``, each row holds L/2 edges [u0, v0, u1, v1, ...]
        (L even).
      wrow: int32 [G*1024] window draws per padded slot, in {1..window}
        (None with ``paired``).
      pools: int [ceil(G / pool_refresh), KP] negative pools (or [KP]).
      lr, negw: step size and negative weight (k / KP), Python floats.
      mxu_bf16: round every product operand to bf16 (K1b; with ``paired``,
        only the negative pass's), f32 sums.
      paired: the O2 edge mode (K5): each slot trains only its partner.

    Returns (emb_in, emb_out, loss, n_pairs); loss and n_pairs are 0-dim
    float32 tensors on the tables' device.  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise.  Launches are counted
    by mode: ``walk_sgns_step.launches`` (K1), ``.launches_bf16`` (K1b) and
    ``.launches_paired`` (K5).
    """
    if paired and walks.shape[1] % 2:
        raise ValueError("paired mode needs an even number of slots per row")
    if emb_in.device.type == "cpu":
        return walk_sgns_step_reference(
            emb_in, emb_out, walks, wrow, pools, lr, negw, window=window,
            pool_refresh=pool_refresh, mxu_bf16=mxu_bf16, paired=paired,
        )
    if emb_in.device.type != "cuda":
        raise ValueError(f"no walk_sgns kernel for device {emb_in.device}")
    check_cuda_inputs(emb_in, emb_out, walks, wrow, pools)
    B, L = walks.shape
    slots = pad_walks(walks)
    G = slots.shape[0] // NWL
    R = int(pool_refresh)
    pools = expand_pools(pools, G, R)
    wrow = None if paired else _check_wrow(wrow, G)
    d = emb_in.shape[1]
    KP = pools.shape[1]
    sc = _Scratch(emb_in.device, KP, d)
    stream = torch.cuda.current_stream(emb_in.device).cuda_stream
    code = build.library().come_walk_sgns_step(
        emb_in.data_ptr(), emb_out.data_ptr(), slots.data_ptr(),
        None if paired else wrow.data_ptr(), pools.data_ptr(), *sc.ptrs(),
        d, G, L, 1 if paired else int(window), KP, R, int(mxu_bf16),
        int(paired), float(lr), float(negw), stream,
    )
    _count_walk_launch(mxu_bf16, paired)
    build.check(code, "come_walk_sgns_step")
    return (emb_in, emb_out) + sc.result()


walk_sgns_step.launches = 0
walk_sgns_step.launches_bf16 = 0
walk_sgns_step.launches_paired = 0


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
                                 return_walks: bool = False):
    """Plain PyTorch version of :func:`walk_sgns_gen_step`:
    :func:`walks_from_bits`, then :func:`walk_sgns_step_reference`."""
    walks = walks_from_bits(starts, bits, indptr, indices, walk_length)
    out = walk_sgns_step_reference(
        emb_in, emb_out, walks, wrow, pools, lr, negw, window=window,
        pool_refresh=pool_refresh, mxu_bf16=mxu_bf16,
    )
    return out + (walks,) if return_walks else out


def walk_sgns_gen_step(emb_in, emb_out, starts, bits, indptr, indices, wrow,
                       pools, lr, negw, *, walk_length: int, window: int,
                       pool_refresh: int = 1, mxu_bf16: bool = False,
                       return_walks: bool = False):
    """One O1 macro step with the walks generated in the kernel (K4).

    Args:
      starts: int [B] walk origins (B wraps up to G*8, G = ceil(B/8)).
      bits: int32 [G*1024] (or [G, 1024]) random 32-bit values; walk j's
        hop t reads bits[j*128 + t] (see :func:`walks_from_bits`).
      indptr, indices: the graph's CSR, int32 [V+1] and [E], on the
        tables' device.
      wrow, pools, lr, negw, window, pool_refresh, mxu_bf16: as
        :func:`walk_sgns_step`.
      return_walks: also return the generated walks, int32 [G*8, L].

    Returns (emb_in, emb_out, loss, n_pairs[, walks]).  CPU tensors run the
    plain version; CUDA tensors launch the generator and the walk kernel or
    raise.  Launches are counted by mode, apart from
    :func:`walk_sgns_step`'s: ``walk_sgns_gen_step.launches`` (K4 with f32
    products) and ``.launches_bf16`` (K4 with K1b's bf16 products).
    """
    if emb_in.device.type == "cpu":
        return walk_sgns_gen_step_reference(
            emb_in, emb_out, starts, bits, indptr, indices, wrow, pools, lr,
            negw, walk_length=walk_length, window=window,
            pool_refresh=pool_refresh, mxu_bf16=mxu_bf16,
            return_walks=return_walks,
        )
    if emb_in.device.type != "cuda":
        raise ValueError(f"no walk_sgns kernel for device {emb_in.device}")
    check_cuda_inputs(emb_in, emb_out, starts, bits, indptr, indices, wrow,
                      pools)
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
    sc = _Scratch(emb_in.device, KP, d)
    slots = torch.empty((G * NWL,), dtype=torch.int32, device=emb_in.device)
    stream = torch.cuda.current_stream(emb_in.device).cuda_stream
    code = build.library().come_walk_sgns_gen_step(
        emb_in.data_ptr(), emb_out.data_ptr(), starts.data_ptr(),
        bits.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
        slots.data_ptr(), wrow.data_ptr(), pools.data_ptr(), *sc.ptrs(), d,
        G, L, int(window), KP, R, int(mxu_bf16), float(lr), float(negw),
        stream,
    )
    if mxu_bf16:
        walk_sgns_gen_step.launches_bf16 += 1
    else:
        walk_sgns_gen_step.launches += 1
    build.check(code, "come_walk_sgns_gen_step")
    out = (emb_in, emb_out) + sc.result()
    if return_walks:
        out = out + (slots.view(G * NW, LP)[:, :L],)
    return out


walk_sgns_gen_step.launches = 0
walk_sgns_gen_step.launches_bf16 = 0
