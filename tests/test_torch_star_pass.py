"""The work splits of the card's star pass and f32 negative pass, emulated
in numpy on the CPU.

``csrc/star_pos.cuh::star_pos_kernel`` cuts each 128-slot row of a star
layout into strips of 8 slots, one CTA each; a CTA owns the segments whose
hub lies in its strip, found with warp ballots of each segment's first and
last slot.  ``star_split`` below repeats that arithmetic word by word.  Over
``build_star_layout`` outputs (``chip_smoke.star_edge_layout``: random
graphs, a degree-300 hub, max_fanout 32 and 4, a hub filling a row,
segments dropped to pads mid-row) it must score every pair the TPU
kernel's dense mask keeps (``come_tpu/ops/pallas_star_sgns.py:144-146``:
same segment, exactly one hub) exactly once, give every slot exactly one
writer, and give each slot the dense mask's pair count.

``csrc/sgns_common.cuh::neg_pool_splits`` sizes the negative pass's grid
from the CTAs that fit on the card at once (the kernel's occupancy times the
SMs); the f32 pass rounds it up to whole clusters (``negf_cluster``) and
gives a tile no more clusters than fit on the card at once.  ``pool_splits``
and ``f32_grid`` repeat them, and at every KP, slot count and fit every
(tile, chunk) must be walked by exactly one CTA, none by more than ``per``,
and a cluster's CTAs must sum disjoint slots of their tile.
"""

import numpy as np
import pytest

from chip_smoke import star_edge_layout
from come_tpu_torch.sampling.stars import PAD_META

ROW, STRIP = 128, 8
M32 = 0xFFFFFFFF


def _ballot(flags):
    """The four 32-bit warp ballots of 128 flags."""
    return [sum(1 << i for i in range(32) if flags[32 * w + i])
            for w in range(ROW // 32)]


def _clz(x):
    return 32 - x.bit_length()


def _ffs(x):
    return (x & -x).bit_length()


def star_split(meta):
    """star_pos_kernel's split of one row: (pairs scored as (hub, leaf) by
    each CTA, writers of each slot, n of each slot)."""
    m = [int(x) for x in meta]
    real = [x >= 0 for x in m]
    first = _ballot([real[t] and (t == 0 or m[t - 1] >> 1 != m[t] >> 1)
                     for t in range(ROW)])
    last = _ballot([real[t] and (t == ROW - 1 or m[t + 1] >> 1 != m[t] >> 1)
                    for t in range(ROW)])
    hub = []
    for t in range(ROW):
        h, lane = -1, t & 31
        for w in range(t >> 5, -1, -1):
            if not real[t]:
                break
            bits = first[w] & (((2 << lane) - 1) & M32) if w == t >> 5 \
                else first[w]
            if bits:
                h = 32 * w + 31 - _clz(bits)
                break
        hub.append(h)
    pairs, writers = [], [[] for _ in range(ROW)]
    n = [0.0] * ROW
    for k in range(ROW // STRIP):
        s0 = k * STRIP
        for a in range(s0, s0 + STRIP):
            if m[a] < 0:
                writers[a].append(k)
        own = (first[s0 >> 5] >> (s0 & 31)) & ((1 << STRIP) - 1)
        if not own:
            continue
        lo, top = s0 + _ffs(own) - 1, s0 + 31 - _clz(own)
        hi = ROW
        for w in range(top >> 5, ROW // 32):
            bits = last[w] & ((M32 << (top & 31)) & M32) if w == top >> 5 \
                else last[w]
            if bits:
                hi = 32 * w + _ffs(bits)
                break
        for u in range(lo, hi):
            if m[u] < 0:
                continue
            writers[u].append(k)
            if hub[u] != u:
                pairs.append((hub[u], u))
                n[u] = 1.0
            else:
                v = u + 1
                while v < hi and hub[v] == u:
                    v += 1
                n[u] = float(v - u - 1)
    return pairs, writers, n


@pytest.mark.parametrize("kind,max_fanout", [
    ("random", 32), ("random", 4), ("hub", 32), ("hub", 4),
    ("fat", 127), ("pads", 32), ("pads", 4),
])
def test_star_split_scores_each_masked_pair_once(kind, max_fanout):
    _, meta = star_edge_layout(600, 4000, kind, len(kind) + max_fanout,
                               max_fanout)
    rows = meta.reshape(-1, ROW)
    if kind == "pads":
        assert any((r[:-1] == PAD_META).any() and (r[r != PAD_META].size > 0)
                   for r in rows)
    n_pairs = 0
    for mr in rows:
        seg, hub = mr >> 1, mr & 1
        mask = (seg[:, None] == seg[None, :]) & ((hub[:, None] ^ hub[None, :])
                                                 == 1)
        dense = {(a, b) for a, b in zip(*np.nonzero(np.triu(mask)))}
        pairs, writers, n = star_split(mr)
        assert len(pairs) == len(set(pairs))  # scored once
        assert {tuple(sorted(p)) for p in pairs} == dense
        assert all(len(w) == 1 for w in writers)  # one writer per slot
        np.testing.assert_array_equal(n, mask.sum(1))
        n_pairs += 2 * len(pairs)
    assert n_pairs == 2 * int(((meta >= 0) & (meta & 1 == 0)).sum())


def pool_splits(tiles, nch, fit):
    """sgns_common.cuh::neg_pool_splits: (ny, per)."""
    per = (nch * tiles + fit - 1) // fit
    return (nch + per - 1) // per, per


def f32_splits(ny):
    """The f32 pass's cluster size (sgns_common.cuh::negf_cluster) and ny
    rounded up to a multiple of it (NegativePass::size)."""
    c = 8 if ny >= 8 else 4 if ny >= 4 else 2 if ny >= 2 else 1
    return c, -(-ny // c) * c


def f32_grid(tiles, nch, fit, clusters):
    """NegativePass::size for the f32 pass, where ``clusters`` clusters of
    its size fit on the card at once (0: not asked): (cluster size, ny)."""
    ny, _ = pool_splits(tiles, nch, fit)
    c, ny = f32_splits(ny)
    if c > 1 and clusters >= tiles and tiles * (ny // c) > clusters:
        ny = clusters // tiles * c
    return c, ny


@pytest.mark.parametrize("KP", [1, 31, 100, 512, 2048, 5000])
def test_negative_grid_walks_every_tile_chunk_once(KP):
    nch = -(-KP // 32)
    for nslots in (64, 896, 1024, 4096):
        tiles = nslots // 64
        for per_sm in (1, 2, 3):  # the kernel's occupancy
            for sms, clusters in ((1, 0), (8, 1), (132, 0), (132, 30),
                                  (132, 45)):
                fit = per_sm * sms
                ny, per = pool_splits(tiles, nch, fit)
                assert 1 <= ny <= nch
                c, ny32 = f32_grid(tiles, nch, fit, clusters)
                assert ny32 % c == 0 and 64 % c == 0 and c <= ny32
                if c > 1 and clusters >= tiles:  # one wave of clusters
                    assert tiles * ny32 // c <= clusters
                for n, most in ((ny, per), (ny32, -(-nch // ny32))):
                    walked = np.zeros((tiles, nch), int)
                    for x in range(tiles):
                        for y in range(n):
                            chunks = list(range(y, nch, n))
                            assert len(chunks) <= most
                            assert chunks or n > nch  # only pads are idle
                            walked[x, chunks] += 1
                    assert (walked == 1).all()
                # each cluster's ranks sum disjoint slot ranges of the tile
                rows = [range(q * 64 // c, (q + 1) * 64 // c) for q in range(c)]
                assert sorted(i for r in rows for i in r) == list(range(64))
