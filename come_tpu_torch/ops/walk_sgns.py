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
    real = (torch.arange(NWL, device=dev) % LP) < L
    # SR counters: slot t's element k is t*d + k, pool row k slot NWL + k
    counter = torch.arange((NWL + pools.shape[1]) * d, device=dev).view(-1, d)
    for g in range(G):
        if g % R == 0:
            pool = pools[g // R]
            cneg = mxu(emb_out[pool].to(acc), mxu_bf16)
            dneg = torch.zeros_like(cneg)
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
            emb_in.index_add_(0, ids, dphi.reshape(NWL, d), alpha=-lr)
            emb_out.index_add_(0, ids, dctx.reshape(NWL, d), alpha=-lr)
            if end:
                emb_out.index_add_(0, pool, dneg, alpha=-lr)
            continue
        # K3: one rounded RMW per real slot (padded slots carry exact
        # zeros, which round to the row itself), then the pool's
        lo = hi = pbits = None
        if sr_seed is not None:
            key = sr_key(sr_seed, g)
            bits = sr_bits(key, counter[:NWL][real])
            lo, hi = bits & 0xFFFF, bits >> 16
            pbits = sr_bits(key, counter[NWL:]) & 0xFFFF
        dphi, dctx = dphi.reshape(NWL, d)[real], dctx.reshape(NWL, d)[real]
        rmw_rows(emb_in, ids[real], (dphi * (-lr)).float(), lo)
        rmw_rows(emb_out, ids[real], (dctx * (-lr)).float(), hi)
        if end:
            rmw_rows(emb_out, pool, (dneg * (-lr)).float(), pbits)
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


def check_cuda_inputs(*tensors, table_dtypes=(torch.float32,)):
    """Raise unless every tensor shares one device, the first two (the
    tables) are contiguous and of one of ``table_dtypes``, and d fits the
    kernels (<= 192; even for bf16 tables, whose writes go by pairs)."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    for t in tensors[:2]:
        if t.dtype not in table_dtypes or not t.is_contiguous():
            raise ValueError(f"tables must be contiguous {table_dtypes}")
    d = tensors[0].shape[1]
    if d > 192:
        raise ValueError(f"dim {d} > 192 exceeds the kernels' shared memory")
    if tensors[0].dtype == torch.bfloat16 and d % 2:
        raise ValueError("bf16 tables need an even dim")


_RETRIES: dict[torch.device, torch.Tensor] = {}


def cas_retries(device) -> torch.Tensor:
    """K3's running count of compare-and-swap retries on ``device``: a
    float64 [1] device tensor that every K3 launch adds to (a retry is
    another thread writing the same bf16 pair between a read and its
    write).  Zero it with ``.zero_()``."""
    dev = torch.device(device)
    if dev not in _RETRIES:
        _RETRIES[dev] = torch.zeros(1, dtype=torch.float64, device=dev)
    return _RETRIES[dev]


class _Scratch:
    """Per-call device buffers of the walk kernel's C entries."""

    def __init__(self, dev, KP: int, d: int):
        f32 = torch.float32
        self.stats = torch.zeros(2, dtype=torch.float64, device=dev)
        self.retries = cas_retries(dev)
        self.cneg = torch.empty((KP, d), dtype=f32, device=dev)
        self.dneg = torch.empty((KP, d), dtype=f32, device=dev)
        # the positive pass's part of each slot's update, then the negative
        # pass's: the scatter adds the two once, as the plain version does
        self.dphi = torch.empty((2, NWL, d), dtype=f32, device=dev)
        self.dctx = torch.empty((NWL, d), dtype=f32, device=dev)
        self.nt = torch.empty((NWL,), dtype=f32, device=dev)

    def ptrs(self):
        return (self.stats.data_ptr(), self.retries.data_ptr(),
                self.cneg.data_ptr(), self.dneg.data_ptr(),
                self.dphi.data_ptr(), self.dctx.data_ptr(),
                self.nt.data_ptr())

    def result(self):
        st = self.stats.to(torch.float32)
        return st[0], st[1]


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
    version; CUDA tensors launch the kernel or raise.  Launches are counted
    by mode: ``walk_sgns_step.launches`` (K1), ``.launches_bf16`` (K1b),
    ``.launches_paired`` (K5) and ``.launches_bf16_tables`` (K3).
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
    check_cuda_inputs(emb_in, emb_out, walks, wrow, pools, table_dtypes=_BOTH)
    tables_bf16, sr, seed = _table_modes(emb_in, emb_out, paired, sr_seed)
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
        d, G, L, 1 if paired else int(window), KP, R,
        int(mxu_bf16 or tables_bf16), int(paired), tables_bf16, sr, seed,
        float(lr), float(negw), stream,
    )
    _count_walk_launch(mxu_bf16, paired, tables_bf16)
    build.check(code, "come_walk_sgns_step")
    return (emb_in, emb_out) + sc.result()


walk_sgns_step.launches = 0
walk_sgns_step.launches_bf16 = 0
walk_sgns_step.launches_paired = 0
walk_sgns_step.launches_bf16_tables = 0


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

    Returns (emb_in, emb_out, loss, n_pairs[, walks]).  CPU tensors run the
    plain version; CUDA tensors launch the generator and the walk kernel or
    raise.  Launches are counted by mode, apart from
    :func:`walk_sgns_step`'s: ``walk_sgns_gen_step.launches`` (K4 with f32
    products), ``.launches_bf16`` (K4 with K1b's bf16 products) and
    ``.launches_bf16_tables`` (K4 over K3's bf16 tables).
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
                      pools, table_dtypes=_BOTH)
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
    sc = _Scratch(emb_in.device, KP, d)
    slots = torch.empty((G * NWL,), dtype=torch.int32, device=emb_in.device)
    stream = torch.cuda.current_stream(emb_in.device).cuda_stream
    code = build.library().come_walk_sgns_gen_step(
        emb_in.data_ptr(), emb_out.data_ptr(), starts.data_ptr(),
        bits.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
        slots.data_ptr(), wrow.data_ptr(), pools.data_ptr(), *sc.ptrs(), d,
        G, L, int(window), KP, R, int(mxu_bf16 or tables_bf16), tables_bf16,
        sr, seed, float(lr), float(negw), stream,
    )
    if tables_bf16:
        walk_sgns_gen_step.launches_bf16_tables += 1
    elif mxu_bf16:
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
walk_sgns_gen_step.launches_bf16_tables = 0
