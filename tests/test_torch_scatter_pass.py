"""The slot scatters and their chains (``ops/scatter_pass.py``): K3's
scatter's plain version against the code it was factored out of, the plain
version of the chains that the scatters follow, the plain K3 step on
hub-heavy walks against the JAX package's Pallas kernel, the f32 walk and
star scatters' plain versions against element-by-element loops, the fold
lookup, the ownership the kernels derive from the chains, the star step on
split hubs and repeated pool draws against the Pallas star kernel, and the
wrappers on the CPU.  The CUDA kernels themselves are held against these
plain versions, bit for bit, by ``tests/test_torch_cuda.py`` (``-m cuda``)
and ``chip_smoke.py``'s phase 4m.

Tolerances: the factored plain functions equal the old code bit for bit;
the plain K3 step (truncation) on walks that a few rows fill equals the
Pallas bf16-table kernel in interpret mode bit for bit but for one bf16 ulp
on at most 0.1% of the elements (both write a row's repeated slots in slot
order; the two sum their f32 products in another order, which moves one
element of 1920 at d 32 and none at d 128), loss within 1e-5 relative,
pair counts exact; the star and f32 walk steps against the Pallas kernels
at the kernel tests' f32 tolerance (rtol 1e-3, atol 3e-5 on the table, loss
within 1e-4 relative, pair counts exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import star_edge_layout
from come_tpu.ops.pallas_star_sgns import fused_star_sgns_step
from come_tpu.ops.pallas_walk_sgns import fused_walk_sgns_step
from come_tpu_torch.ops import walk_sgns as ws
from come_tpu_torch.ops.pool_pass import pool_chains_reference
from come_tpu_torch.ops.scatter_pass import (
    fold_chains,
    fold_chains_reference,
    slot_chains,
    slot_chains_reference,
    star_chains,
    star_chains_reference,
    star_fold_chains,
    star_fold_chains_reference,
    star_scatter,
    star_scatter_reference,
    walk_scatter_bf16,
    walk_scatter_f32,
)
from come_tpu_torch.ops.star_sgns import (
    star_group_grads,
    star_sgns_step,
    star_sgns_step_reference,
)
from come_tpu_torch.sampling.stars import PAD_META
from come_tpu_torch.ops.walk_sgns import (
    LP,
    NWL,
    pad_walks,
    rmw_rows,
    sr_bits,
    sr_key,
    walk_scatter_bf16_reference,
    walk_scatter_f32_reference,
    walk_sgns_step,
)

torch.set_num_threads(2)


def _bits16(t):
    return t.view(torch.int16).numpy().astype(np.int32)


def _walks(kind, rng, V, B, L):
    """[B, L] walks: uniform over V, over a few rows ("hub": 4 rows fill
    every walk), or revisiting a short cycle ("cycle": walks of period 3)."""
    if kind == "hub":
        rows = rng.choice(V, size=4, replace=False)
        return rows[rng.integers(0, 4, (B, L))].astype(np.int32)
    if kind == "cycle":
        base = rng.integers(0, V, (B, 3))
        return base[:, np.arange(L) % 3].astype(np.int32)
    return rng.integers(0, V, (B, L)).astype(np.int32)


def _group(kind, rng, V, L):
    """One group's padded slots (int64 [1024]) of 8 walks of L."""
    return pad_walks(torch.tensor(_walks(kind, rng, V, 8, L))).long()


# ------------------------------------------ the factored plain scatter


def _old_scatter(emb_in, emb_out, ids, dphi, dctx, lr, L, g, sr_seed):
    """walk_sgns_step_reference's inline K3 slot writes before they were
    factored (its SR counters: slot t's element k at t * d + k)."""
    d = emb_in.shape[1]
    real = (torch.arange(NWL) % LP) < L
    counter = torch.arange(NWL * d).view(NWL, d)
    lo = hi = None
    if sr_seed is not None:
        bits = sr_bits(sr_key(sr_seed, g), counter[real])
        lo, hi = bits & 0xFFFF, bits >> 16
    dphi, dctx = dphi.reshape(NWL, d)[real], dctx.reshape(NWL, d)[real]
    rmw_rows(emb_in, ids[real], (dphi * (-lr)).float(), lo)
    rmw_rows(emb_out, ids[real], (dctx * (-lr)).float(), hi)
    return emb_in, emb_out


@pytest.mark.parametrize("kind", ["uniform", "hub", "cycle"])
@pytest.mark.parametrize("sr_seed", [None, 4321])
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [80, 128, 1])
def test_scatter_reference_equals_the_old_inline_scatter(kind, sr_seed, acc,
                                                         L):
    rng = np.random.default_rng(L)
    V, d, g, lr = 300, 18, 6, 0.05
    tabs = [torch.tensor(rng.normal(size=(V, d)).astype(np.float32) * .1
                         ).to(torch.bfloat16) for _ in range(2)]
    ids = _group(kind, rng, V, L)
    dphi, dctx = (torch.tensor(rng.normal(size=(8, LP, d))).to(acc)
                  for _ in range(2))
    want = _old_scatter(*[t.clone() for t in tabs], ids, dphi, dctx, lr, L,
                        g, sr_seed)
    got = walk_scatter_bf16_reference(*[t.clone() for t in tabs], ids, dphi,
                                      dctx, lr, L, g, sr_seed)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("sr_seed", [None, 99])
def test_step_reference_equals_the_old_inline_step(sr_seed, monkeypatch):
    """A whole K3 step (three groups of walks that revisit rows, R 2) through
    the factored scatter equals the step through the old inline code, bit
    for bit."""
    rng = np.random.default_rng(7)
    V, d, L, KP, B = 40, 16, 30, 40, 24
    ei, eo = (torch.tensor(rng.normal(size=(V, d)).astype(np.float32) * .1
                           ).to(torch.bfloat16) for _ in range(2))
    walks = torch.tensor(_walks("cycle", rng, V, B, L))
    pools = torch.tensor(rng.integers(0, V, (2, KP)), dtype=torch.int32)
    wrow = torch.tensor(rng.integers(1, 4, 3 * NWL), dtype=torch.int32)

    def step():
        return ws.walk_sgns_step_reference(
            ei.clone(), eo.clone(), walks, wrow, pools, 0.05, 5.0 / KP,
            window=3, pool_refresh=2, sr_seed=sr_seed)

    new = step()
    monkeypatch.setattr(ws, "walk_scatter_bf16_reference", _old_scatter)
    old = step()
    for a, b in zip(new[:2], old[:2]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert float(new[2]) == float(old[2]) and float(new[3]) == float(old[3])


def test_the_scatter_adds_the_negative_part_first():
    """dphin (the kernel's separate negative part) is added to dphi in f32
    before the product, as the kernel's __fadd_rn does."""
    rng = np.random.default_rng(3)
    V, d, L = 50, 10, 20
    tabs = [torch.tensor(rng.normal(size=(V, d)).astype(np.float32)
                         ).to(torch.bfloat16) for _ in range(2)]
    ids = _group("hub", rng, V, L)
    dphi, dphin, dctx = (torch.tensor(rng.normal(size=(NWL, d)).astype(
        np.float32)) for _ in range(3))
    got = walk_scatter_bf16(*[t.clone() for t in tabs], ids, dphi, dphin,
                            dctx, 0.1, L=L, group=2, sr_seed=5)
    want = walk_scatter_bf16_reference(*[t.clone() for t in tabs], ids,
                                       dphi + dphin, dctx, 0.1, L, 2, 5)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    # the rows moved, and only rows the real slots hold
    real = (torch.arange(NWL) % LP) < L
    moved = (got[0].view(torch.int16) != tabs[0].view(torch.int16)).any(1)
    assert moved.any()
    assert set(torch.nonzero(moved)[:, 0].tolist()) <= set(
        ids[real].tolist())


# --------------------------------------------- the scatter's chains


@pytest.mark.parametrize("kind", ["uniform", "hub", "cycle"])
@pytest.mark.parametrize("L", [80, 1, 128, 37])
def test_the_slot_chains_give_every_real_slot_once_to_its_rows_owner(kind,
                                                                     L):
    """Each distinct row of a group has one owner, its first real slot,
    whose chain holds every real slot of the row, each once, in slot
    order; no padding slot is in any chain or owns one."""
    rng = np.random.default_rng(L + 3)
    slots = torch.cat([_group(kind, rng, 500, L) for _ in range(3)])
    info, order = slot_chains(slots, L)
    n = 8 * L
    for g in range(3):
        ids = slots[g * NWL:(g + 1) * NWL].tolist()
        inf, ordg = info[g].tolist(), order[g].tolist()
        real = [t for t in range(NWL) if t % LP < L]
        chains = {t: ordg[i:i + c] for t, (i, c) in enumerate(inf) if c}
        assert sorted(s for c in chains.values() for s in c) == real
        assert ordg[n:] == [-1] * (NWL - n)
        assert len(chains) == len({ids[t] for t in real})
        for t, c in chains.items():
            assert c[0] == t == min(s for s in real if ids[s] == ids[t])
            assert c == sorted(c) and all(ids[s] == ids[t] for s in c)
            assert len(c) == sum(ids[s] == ids[t] for s in real)
        for t in range(NWL):
            if t % LP >= L:
                assert inf[t] == [0, 0]
        if kind == "hub" and L == 80:
            assert max(len(c) for c in chains.values()) >= 100


@pytest.mark.parametrize("L", [80, 128, 5])
def test_the_plain_slot_chains_sort_each_group_stably(L):
    """order[g] holds the group's real slots in the order of a stable sort
    of their ids, and info[g, t, 0] is t's place in it."""
    rng = np.random.default_rng(L)
    slots = torch.cat([_group("cycle", rng, 90, L) for _ in range(2)])
    info, order = slot_chains_reference(slots, L)
    assert info.dtype == order.dtype == torch.int32
    assert info.shape == (2, NWL, 2) and order.shape == (2, NWL)
    real = np.flatnonzero(np.arange(NWL) % LP < L)
    for g in range(2):
        ids = slots[g * NWL:(g + 1) * NWL].numpy()[real]
        want = real[np.argsort(ids, kind="stable")]
        assert order[g, :real.size].tolist() == want.tolist()
        assert info[g, order[g, :real.size].long(), 0].tolist() == \
            list(range(real.size))


# --------------------------------- hub-heavy walks against the TPU kernel


@pytest.mark.parametrize("d", [32, 128])
def test_k3_step_on_hub_heavy_walks_matches_pallas_interpret(d,
                                                             monkeypatch):
    """The plain K3 step (truncation) on walks that four rows fill, against
    the Pallas bf16-table kernel in interpret mode, whose slot fori_loop
    writes a row's repeats in slot order: bit for bit but for one bf16 ulp
    on at most 0.1% of the elements (at d 128 none, at d 32 one of 1920:
    the two sum their f32 products in another order, and the float64 plain
    step writes the plain f32 step's bits there).  The same plain step with
    each group's writes in another order lands at least 50x as many
    elements elsewhere: on these walks the write order shows."""
    rng = np.random.default_rng(13)
    V, L, W, KP, R, B = 60, 40, 4, 64, 2, 24  # 3 groups, 2 pools

    def bf16(a):
        return torch.tensor(a).to(torch.bfloat16)

    def to_jax(t):
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)

    ei = bf16((rng.normal(size=(V, d)) * 0.1).astype(np.float32))
    eo = bf16((rng.normal(size=(V, d)) * 0.1).astype(np.float32))
    walks = _walks("hub", rng, V, B, L)
    G = -(-B // 8)
    pools = rng.integers(0, V, (-(-G // R), KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    ji, jo, jl, jn = fused_walk_sgns_step(
        to_jax(ei), to_jax(eo), jnp.asarray(walks), jnp.asarray(pools),
        lr, negw, seed=0, window=W, interpret=True, reduced_window=False,
        pool_refresh=R,
    )
    want = [np.asarray(t.view(jnp.int16)).astype(np.int32) for t in (ji, jo)]

    def step():
        return walk_sgns_step(
            ei.clone(), eo.clone(), torch.tensor(walks),
            torch.full((G * NWL,), W, dtype=torch.int32),
            torch.tensor(pools), lr, negw, window=W, pool_refresh=R,
            sr_seed=None)

    ti, to, tl, tn = step()
    assert float(tn) == float(jn)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    off = 0
    for a, b in zip((ti, to), want):
        diff = np.abs(_bits16(a) - b)
        assert diff.max() <= 1
        assert (diff != 0).mean() <= 1e-3
        off += int((diff != 0).sum())
    assert (_bits16(ti) != _bits16(ei)).any()  # the hubs' rows did move
    # the same step writing each group's rows in another order
    in_order = ws.rmw_rows
    gen = torch.Generator().manual_seed(0)

    def any_order(table, ids, upd, rnd):
        p = torch.randperm(ids.numel(), generator=gen)
        in_order(table, ids[p], upd[p], None if rnd is None else rnd[p])

    monkeypatch.setattr(ws, "rmw_rows", any_order)
    shuffled = step()
    moved = sum(int((_bits16(a) != b).sum())
                for a, b in zip(shuffled[:2], want))
    assert moved >= 50 * max(off, 1)


# ------------------------------------------------------------- wrappers


def test_the_wrappers_run_their_plain_versions_on_the_cpu():
    rng = np.random.default_rng(8)
    V, d, L = 70, 12, 50
    tabs = [torch.tensor(rng.normal(size=(V, d)).astype(np.float32)
                         ).to(torch.bfloat16) for _ in range(2)]
    ids = _group("cycle", rng, V, L).to(torch.int32)
    dphi, dphin, dctx = (torch.tensor(rng.normal(size=(NWL, d)).astype(
        np.float32)) for _ in range(3))
    got = walk_scatter_bf16(*[t.clone() for t in tabs], ids, dphi, dphin,
                            dctx, 0.02, L=L, group=1)
    want = walk_scatter_bf16_reference(*[t.clone() for t in tabs], ids,
                                       dphi, dctx, 0.02, L, 1, dphin=dphin)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    info, order = slot_chains(ids, L)
    ref = slot_chains_reference(ids, L)
    assert torch.equal(info, ref[0]) and torch.equal(order, ref[1])
    with pytest.raises(ValueError):  # f32 tables
        walk_scatter_bf16(*[t.float() for t in tabs], ids, dphi, dphin,
                          dctx, 0.02, L=L, group=1)
    with pytest.raises(ValueError):  # an odd width
        walk_scatter_bf16(*[t[:, :11].contiguous() for t in tabs], ids,
                          dphi[:, :11], dphin[:, :11], dctx[:, :11], 0.02,
                          L=L, group=1)
    with pytest.raises(ValueError):  # not whole groups
        slot_chains(ids[:1000], L)
    with pytest.raises(ValueError):  # L past a walk's 128 positions
        slot_chains(ids, LP + 1)


# ----------------------------- the f32 owner scatter and the folded pool write


def _f32_loop(emb_in, emb_out, ids, dphi, dphin, dctx, lr, L, pool=None,
              dneg=None):
    """The f32 slot and pool writes element by element in numpy, in the
    plain step's order: each row's terms f32((dphi + dphin) * -lr) and
    f32(dctx * -lr) summed in float64 over its slots in slot order and
    added once, then each pool draw in draw order, f32(row + f32(dneg *
    -lr))."""
    ei, eo = emb_in.numpy().copy(), emb_out.numpy().copy()
    nlr = np.float32(-lr)
    a = (dphi.numpy() + dphin.numpy()) * nlr
    c = dctx.numpy() * nlr
    sx, sy = {}, {}
    for t in range(NWL):
        if t % LP < L:
            v = int(ids[t])
            sx[v] = sx.get(v, 0.0) + a[t].astype(np.float64)
            sy[v] = sy.get(v, 0.0) + c[t].astype(np.float64)
    for v in sx:
        ei[v] = (ei[v].astype(np.float64) + sx[v]).astype(np.float32)
        eo[v] = (eo[v].astype(np.float64) + sy[v]).astype(np.float32)
    if pool is not None:
        u = dneg.numpy() * nlr
        for k, v in enumerate(pool.tolist()):
            eo[v] = eo[v] + u[k]
    return ei, eo


def _f32_pool(kind, rng, ids, V, KP, L):
    """A pool of KP draws over V rows: uniform ("uniform"), or drawing the
    group's real slots' rows and a few others over and over ("shared": a
    row in both the slots and the pool, drawn many times)."""
    if kind == "uniform":
        return torch.tensor(rng.integers(0, V, KP), dtype=torch.int32)
    real = ids[(torch.arange(NWL) % LP) < L].unique().numpy()
    rows = np.r_[rng.choice(real, size=min(3, real.size), replace=False),
                 rng.integers(0, V, 3)]
    return torch.tensor(rows[rng.integers(0, rows.size, KP)],
                        dtype=torch.int32)


@pytest.mark.parametrize("kind", ["uniform", "hub", "cycle"])
@pytest.mark.parametrize("L", [80, 128, 37, 1])
@pytest.mark.parametrize("pool", [None, "uniform", "shared"])
def test_f32_scatter_reference_equals_a_slot_by_slot_loop(kind, L, pool):
    """walk_scatter_f32_reference (and the wrapper on the CPU) writes the
    bits of the plain step's order, element by element: one float64 sum a
    row over its slots in slot order, then the block end's draws in draw
    order (KP 100), on hub-heavy groups, ragged L and a pool that draws
    the slots' rows many times."""
    rng = np.random.default_rng(L + len(kind))
    V, d, lr, KP = 300, 20, 0.05, 100
    tabs = [torch.tensor(rng.normal(size=(V, d)).astype(np.float32) * .1)
            for _ in range(2)]
    ids = _group(kind, rng, V, L).to(torch.int32)
    dphi, dphin, dctx = (torch.tensor(rng.normal(size=(NWL, d)).astype(
        np.float32)) for _ in range(3))
    p = None if pool is None else _f32_pool(pool, rng, ids, V, KP, L)
    dneg = torch.tensor(rng.normal(size=(KP, d)).astype(np.float32))
    want = _f32_loop(*tabs, ids, dphi, dphin, dctx, lr, L, p, dneg)
    got = walk_scatter_f32_reference(*[t.clone() for t in tabs], ids, dphi,
                                     dctx, lr, L, dphin=dphin, pool=p,
                                     dneg=dneg)
    wrapped = walk_scatter_f32(*[t.clone() for t in tabs], ids, dphi, dphin,
                               dctx, lr, L=L, pool=p,
                               dneg=None if p is None else dneg)
    for a, b, w in zip(got, wrapped, want):
        assert np.array_equal(a.numpy().view(np.int32), w.view(np.int32))
        assert torch.equal(a, b)
    moved = (got[1] != tabs[1]).any(1)
    if pool == "shared":  # rows in both: their slots' sum, then their draws
        both = set(ids[(torch.arange(NWL) % LP) < L].tolist()) & set(
            p.tolist())
        assert both and all(bool(moved[v]) for v in both)


def test_f32_scatter_sums_a_row_once_and_draws_in_order():
    """On a row that a hub's 800 slots and 100 draws write, the float64 sum
    added once and the draws applied one by one in draw order land
    elsewhere than f32 adds slot by slot (index_add_ in f32) or the draws
    in another order: the write order shows."""
    rng = np.random.default_rng(4)
    V, d, L, lr, KP = 40, 16, 100, 0.5, 100
    tabs = [torch.tensor(rng.normal(size=(V, d)).astype(np.float32))
            for _ in range(2)]
    ids = torch.full((NWL,), 7, dtype=torch.int32)
    dphi, dphin, dctx = (torch.tensor(rng.normal(size=(NWL, d)).astype(
        np.float32)) for _ in range(3))
    pool = torch.full((KP,), 7, dtype=torch.int32)
    dneg = torch.tensor(rng.normal(size=(KP, d)).astype(np.float32) * 1e3)
    ei, eo = walk_scatter_f32_reference(
        *[t.clone() for t in tabs], ids, dphi, dctx, lr, L, dphin=dphin,
        pool=pool, dneg=dneg)
    real = (torch.arange(NWL) % LP) < L
    f32 = tabs[0].clone().index_add_(0, ids[real].long(),
                                     ((dphi + dphin)[real] * -lr))
    assert not torch.equal(ei[7], f32[7])
    perm = torch.randperm(KP, generator=torch.Generator().manual_seed(0))
    _, eo2 = walk_scatter_f32_reference(
        *[t.clone() for t in tabs], ids, dphi, dctx, lr, L, dphin=dphin,
        pool=pool[perm], dneg=dneg[perm])
    assert not torch.equal(eo[7], eo2[7])
    assert torch.equal(ei[:7], tabs[0][:7])  # no other row moved


@pytest.mark.parametrize("kind", ["uniform", "hub", "cycle"])
@pytest.mark.parametrize("L", [80, 1, 128, 37])
@pytest.mark.parametrize("KP", [100, 2048])
def test_the_fold_chains_look_each_chain_up_in_the_other(kind, L, KP):
    """fold_chains' plain version (and the wrapper on the CPU), entry by
    entry: a real slot's place of its row's first draw in the pool's chain
    (a stable sort of the pool), -1 where the pool does not draw it and at
    padding slots; a draw's 1 where its row is a real slot's."""
    rng = np.random.default_rng(L + KP + len(kind))
    V = 500
    ids = _group(kind, rng, V, L).to(torch.int32)
    pool = _f32_pool("shared", rng, ids, V, KP, L)
    fold_slot, fold_draw = fold_chains(ids, L, pool)
    ref = fold_chains_reference(ids, L, pool)
    assert torch.equal(fold_slot, ref[0]) and torch.equal(fold_draw, ref[1])
    assert fold_slot.dtype == fold_draw.dtype == torch.int32
    chain = sorted(range(KP), key=lambda k: (int(pool[k]), k))
    rows = {int(ids[t]) for t in range(NWL) if t % LP < L}
    for t in range(NWL):
        v = int(ids[t])
        first = next((i for i, k in enumerate(chain) if int(pool[k]) == v),
                     -1)
        assert int(fold_slot[t]) == (first if t % LP < L else -1)
    assert fold_draw.tolist() == [int(int(v) in rows) for v in pool]
    assert (fold_slot >= 0).any() and fold_draw.any()


def _f32_owners(ids, L, pool):
    """Each team's row in a block end's f32 scatter, as walk_sgns.cu's
    f32_owner decides it on the chains: real slot team i owns its row where
    it is the row's first slot, with the row's draws from its fold_slot
    place where the pool draws it; pool team k where it is the row's first
    draw and fold_draw[k] is 0.  Returns {row: [(team kind, slot or draw,
    slots, draws)]}."""
    info, order = slot_chains_reference(ids, L)
    pinfo, porder = pool_chains_reference(pool)
    fold_slot, fold_draw = fold_chains_reference(ids, L, pool)
    info, order, pinfo, porder = (x[0].tolist() for x in
                                  (info, order, pinfo, porder))
    fold_slot, fold_draw = fold_slot.tolist(), fold_draw.tolist()
    ids = ids.tolist()
    n_real, KP = 8 * L, len(pool)
    out = {}
    for i in range(n_real + KP):
        if i < n_real:
            t = i // L * LP + i % L
            place, n = info[t]
            if n == 0:
                continue
            at = fold_slot[t]
            pn = pinfo[porder[at]][1] if at >= 0 else 0
            out.setdefault(ids[t], []).append(
                ("slot", t, order[place:place + n],
                 [porder[at + j] for j in range(pn)]))
        else:
            k = i - n_real
            place, pn = pinfo[k]
            if pn > 0 and not fold_draw[k]:
                out.setdefault(int(pool[k]), []).append(
                    ("pool", k, [], porder[place:place + pn]))
    return out


@pytest.mark.parametrize("kind", ["uniform", "hub", "cycle"])
@pytest.mark.parametrize("L", [80, 1, 128, 37])
@pytest.mark.parametrize("KP", [100, 2048])
def test_every_touched_row_has_one_owner_and_slots_outrank_draws(kind, L,
                                                                 KP):
    rng = np.random.default_rng(L + KP)
    V = 500
    ids = _group(kind, rng, V, L).to(torch.int32)
    pool = _f32_pool("shared", rng, ids, V, KP, L) if kind != "uniform" \
        else torch.tensor(rng.integers(0, V, KP), dtype=torch.int32)
    owners = _f32_owners(ids, L, pool)
    real = [t for t in range(NWL) if t % LP < L]
    slot_rows = {int(ids[t]) for t in real}
    assert set(owners) == slot_rows | set(pool.tolist())
    for v, own in owners.items():
        assert len(own) == 1, (v, own)
        who, at, slots, draws = own[0]
        assert who == ("slot" if v in slot_rows else "pool")
        assert slots == [t for t in real if int(ids[t]) == v]
        assert draws == [k for k in range(KP) if int(pool[k]) == v]
        assert at == (slots or draws)[0]
    if kind != "uniform":
        assert any(o[0][2] and o[0][3] for o in owners.values())


def _hub_walks(rng, V, B, L):
    """[B, L] walks that four rows fill: every group repeats them."""
    return _walks("hub", rng, V, B, L)


@pytest.mark.parametrize("mode", ["K1", "K1b", "K5"])
def test_f32_steps_with_hub_rows_in_slots_and_pools_match_pallas(mode):
    """A whole K1, K1b and K5 step on walks (K5: edge rows) that four hub
    rows fill, a ragged L, KP 100 with R 3 (a last block of one group) and
    pools that draw the hubs over and over, against the Pallas kernel in
    interpret mode: K1 and K5 at the kernel tests' f32 tolerance (rtol
    1e-3, atol 3e-5, loss rtol 1e-4, exact pair counts), K1b under
    ops/tolerance.py's bf16 check (its f32 step's updates must fail it)."""
    from come_tpu_torch.ops.tolerance import check_bf16

    rng = np.random.default_rng(len(mode))
    V, d, KP, R, B = 70, 32, 100, 3, 32  # 4 groups, 2 blocks
    paired = mode == "K5"
    L, W = (40, 1) if paired else (37, 3)
    ei, eo = ((rng.normal(size=(V, d)) * 0.1).astype(np.float32)
              for _ in range(2))
    walks = _hub_walks(rng, V, B, L)
    if paired:  # edges between a hub and another row
        walks[:, 1::2] = (walks[:, 0::2] + 1 + rng.integers(
            0, V - 1, (B, L // 2))) % V
    hubs = np.unique(walks)[:4] if paired else np.unique(walks)
    pools = np.r_[hubs, rng.integers(0, V, 4)][
        rng.integers(0, hubs.size + 4, (2, KP))].astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    bf16 = mode == "K1b"
    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(ei), jnp.asarray(eo), jnp.asarray(walks),
        jnp.asarray(pools), lr, negw, seed=0, window=W, interpret=True,
        reduced_window=False, pool_refresh=R, paired=paired, mxu_bf16=bf16)

    def port(rnd):
        return walk_sgns_step(
            torch.tensor(ei), torch.tensor(eo), torch.tensor(walks),
            None if paired else torch.full((4 * NWL,), W, dtype=torch.int32),
            torch.tensor(pools), lr, negw, window=W, pool_refresh=R,
            paired=paired, mxu_bf16=rnd)

    ti, to, tl, tn = port(bf16)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    if bf16:
        fi, fo, _, _ = port(False)
        check_bf16("K1b", (ei, eo), (ti, to),
                   (np.array(ji), np.array(jo)), (fi, fo))
    else:
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-3,
                                   atol=3e-5)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-3,
                                   atol=3e-5)
    assert (to.numpy()[hubs] != eo[hubs]).all(1).any()


# -------------------------------- the star scatter, its chains and fold


STAR_LAYOUTS = ("random", "hub", "fat", "pads", "ragged")


def _star(layout, seed, V=400, E=None):
    """A star layout (chip_smoke.star_edge_layout: "hub" a node of degree
    300 split into segments over several rows of a group, "fat" one
    segment filling a row, "pads" pads mid-row, "ragged" a ragged last
    group) on E random edges, padded to whole groups: (slots, meta) int32
    [G * 1024]."""
    if E is None:
        E = {"fat": 0, "ragged": 3000}.get(layout, 1500)
    s, m = star_edge_layout(V, E, layout, seed)
    G = -(-s.size // NWL)
    s = np.pad(s, (0, G * NWL - s.size))
    m = np.pad(m, (0, G * NWL - m.size), constant_values=PAD_META)
    return torch.tensor(s, dtype=torch.int32), torch.tensor(
        m, dtype=torch.int32)


def _star_pool(kind, rng, ids, meta, V, KP):
    """A pool of KP draws over V rows: uniform, or ("hub") drawing node 0
    (the layouts' hub), a few of the group's real rows and two others over
    and over."""
    if kind == "uniform":
        return torch.tensor(rng.integers(0, V, KP), dtype=torch.int32)
    real = ids[meta != PAD_META].unique().numpy()
    rows = np.r_[0, rng.choice(real, size=min(3, real.size), replace=False),
                 rng.integers(0, V, 2)]
    return torch.tensor(rows[rng.integers(0, rows.size, KP)],
                        dtype=torch.int32)


@pytest.mark.parametrize("layout", STAR_LAYOUTS)
def test_the_star_chains_give_every_real_slot_once_to_its_rows_owner(layout):
    """Each distinct row of a star group has one owner, its first real
    slot, whose chain holds every real slot of the row, each once, in slot
    order; pads (meta -2, node 0) are in no chain and own none, so node 0
    chains only its real slots."""
    slots, meta = _star(layout, 5)
    info, order = star_chains(slots, meta)
    ref = star_chains_reference(slots, meta)
    assert torch.equal(info, ref[0]) and torch.equal(order, ref[1])
    assert info.dtype == order.dtype == torch.int32
    G = slots.numel() // NWL
    assert info.shape == (G, NWL, 2) and order.shape == (G, NWL)
    for g in range(G):
        ids = slots[g * NWL:(g + 1) * NWL].tolist()
        mt = meta[g * NWL:(g + 1) * NWL].tolist()
        inf, ordg = info[g].tolist(), order[g].tolist()
        real = [t for t in range(NWL) if mt[t] != PAD_META]
        chains = {t: ordg[i:i + c] for t, (i, c) in enumerate(inf) if c}
        assert sorted(x for c in chains.values() for x in c) == real
        assert ordg[len(real):] == [-1] * (NWL - len(real))
        assert len(chains) == len({ids[t] for t in real})
        for t, c in chains.items():
            assert c[0] == t == min(x for x in real if ids[x] == ids[t])
            assert c == sorted(c) and all(ids[x] == ids[t] for x in c)
        for t in range(NWL):
            if mt[t] == PAD_META:
                assert inf[t] == [0, 0]
        assert sorted(ordg[:len(real)]) == real
    first = info[0, :, 1].tolist()  # group 0's chain lengths by owner
    hub = [c for t, c in enumerate(first) if c and int(slots[t]) == 0]
    if layout == "hub":  # the hub's segments: one chain over several rows
        ts = order[0, info[0, slots[:NWL].tolist().index(0), 0]:][:hub[0]]
        assert hub[0] >= 8 and len({int(t) // 128 for t in ts}) >= 2
    if layout == "pads":
        assert int(((meta == PAD_META) & (slots == 0)).sum()) > 100
        assert len(hub) <= 1


def _star_loop(emb, ids, meta, dphi, dphin, lr, pool=None, dneg=None):
    """The star writes element by element in numpy, in the TPU's order:
    each real slot in slot order, row = f32(row + f32(f32(dphi + dphin) *
    -lr)), then each draw in draw order, row = f32(row + f32(dneg *
    -lr))."""
    e = emb.numpy().copy()
    nlr = np.float32(-lr)
    a = (dphi.numpy() + dphin.numpy()) * nlr
    for t in range(NWL):
        if int(meta[t]) != PAD_META:
            v = int(ids[t])
            e[v] = e[v] + a[t]
    if pool is not None:
        u = dneg.numpy() * nlr
        for k, v in enumerate(pool.tolist()):
            e[v] = e[v] + u[k]
    return e


@pytest.mark.parametrize("layout", STAR_LAYOUTS)
@pytest.mark.parametrize("pool", [None, "uniform", "hub"])
@pytest.mark.parametrize("d", [20, 13])
def test_star_scatter_reference_equals_a_slot_by_slot_loop(layout, pool, d):
    """star_scatter_reference (and the wrapper on the CPU) writes the bits
    of the TPU's order, element by element: every real slot's update
    rounded into its row in slot order, pads skipped, then the block end's
    draws in draw order (KP 100), on split and fat hubs, pads mid-row, a
    ragged d and a pool that draws the hub and the group's rows many
    times."""
    rng = np.random.default_rng(d + len(layout) + len(str(pool)))
    V, lr, KP = 400, 0.05, 100
    emb = torch.tensor(rng.normal(size=(V, d)).astype(np.float32) * .1)
    slots, meta = _star(layout, d)
    ids, mt = slots[:NWL], meta[:NWL]
    dphi, dphin = (torch.tensor(rng.normal(size=(NWL, d)).astype(
        np.float32)) for _ in range(2))
    p = None if pool is None else _star_pool(pool, rng, ids, mt, V, KP)
    dneg = None if p is None else torch.tensor(
        rng.normal(size=(KP, d)).astype(np.float32))
    want = _star_loop(emb, ids, mt, dphi, dphin, lr, p, dneg)
    got = star_scatter_reference(emb.clone(), ids, mt, dphi, dphin, lr,
                                 pool=p, dneg=dneg)
    wrapped = star_scatter(emb.clone(), ids, mt, dphi, dphin, lr, pool=p,
                           dneg=dneg)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert torch.equal(got, wrapped)
    if pool == "hub":  # node 0's slots, then its draws
        assert not torch.equal(got[0], emb[0])


def test_star_scatter_applies_slots_before_draws_each_in_order():
    """On a row that 300 slots and 100 draws write, the slot-by-slot f32
    writes differ from one f32 sum of the row's slots, from the draws in
    another order and from the draws before the slots: the write order
    shows, and nothing else moves."""
    rng = np.random.default_rng(11)
    V, d, lr, KP = 40, 16, 0.5, 100
    emb = torch.tensor(rng.normal(size=(V, d)).astype(np.float32))
    ids = torch.full((NWL,), 7, dtype=torch.int32)
    meta = torch.full((NWL,), PAD_META, dtype=torch.int32)
    meta[:300] = 0
    dphi, dphin = (torch.tensor(rng.normal(size=(NWL, d)).astype(
        np.float32) * 1e2) for _ in range(2))
    pool = torch.full((KP,), 7, dtype=torch.int32)
    dneg = torch.tensor(rng.normal(size=(KP, d)).astype(np.float32) * 1e3)
    got = star_scatter_reference(emb.clone(), ids, meta, dphi, dphin, lr,
                                 pool=pool, dneg=dneg)
    slots_only = star_scatter_reference(emb.clone(), ids, meta, dphi, dphin,
                                        lr)
    once = emb[7].double() + ((dphi + dphin)[:300] * -lr).double().sum(0)
    assert not torch.equal(slots_only[7], once.float())
    perm = torch.randperm(KP, generator=torch.Generator().manual_seed(0))
    other = star_scatter_reference(emb.clone(), ids, meta, dphi, dphin, lr,
                                   pool=pool[perm], dneg=dneg[perm])
    assert not torch.equal(got[7], other[7])
    no_slots = torch.full((NWL,), PAD_META, dtype=torch.int32)
    draws = star_scatter_reference(emb.clone(), ids, no_slots, dphi, dphin,
                                   lr, pool=pool, dneg=dneg)
    draws_first = star_scatter_reference(draws, ids, meta, dphi, dphin, lr)
    assert not torch.equal(got[7], draws_first[7])
    assert torch.equal(got[:7], emb[:7]) and torch.equal(got[8:], emb[8:])


@pytest.mark.parametrize("layout", STAR_LAYOUTS)
@pytest.mark.parametrize("KP", [100, 2048])
def test_the_star_fold_chains_look_each_chain_up_in_the_other(layout, KP):
    """star_fold_chains' plain version (and the wrapper on the CPU), entry
    by entry, on hub-heavy layouts and pools that draw the hub over and
    over: a real slot's place of its row's first draw in the pool's chain,
    -1 where the pool does not draw it and at pads (node 0 too); a draw's
    1 where its row is a real slot's."""
    rng = np.random.default_rng(KP + len(layout))
    V = 400
    slots, meta = _star(layout, KP)
    ids, mt = slots[:NWL], meta[:NWL]
    pool = _star_pool("hub", rng, ids, mt, V, KP)
    fold_slot, fold_draw = star_fold_chains(ids, mt, pool)
    ref = star_fold_chains_reference(ids, mt, pool)
    assert torch.equal(fold_slot, ref[0]) and torch.equal(fold_draw, ref[1])
    assert fold_slot.dtype == fold_draw.dtype == torch.int32
    chain = sorted(range(KP), key=lambda k: (int(pool[k]), k))
    firsts = {}
    for i, k in enumerate(chain):
        firsts.setdefault(int(pool[k]), i)
    real = mt != PAD_META
    rows = set(ids[real].tolist())
    for t in range(NWL):
        want = firsts.get(int(ids[t]), -1) if bool(real[t]) else -1
        assert int(fold_slot[t]) == want
    assert fold_draw.tolist() == [int(int(v) in rows) for v in pool]
    assert (fold_slot >= 0).any() and fold_draw.any()
    pads0 = (~real) & (ids == 0)
    assert (fold_slot[pads0] == -1).all()


@pytest.mark.parametrize("layout", ["hub", "ragged"])
@pytest.mark.parametrize("R,KP", [(3, 100), (3, 2048), (1, 100), (2, 64)])
def test_the_star_fold_chains_of_a_step_take_each_blocks_last_group(
        layout, R, KP):
    """Over a whole step (every group, R a block, a last block of fewer
    groups where R does not divide G), block b's fold chains are those of
    its last group min(b R + R - 1, G - 1) and its pool, whose draws repeat
    the hub."""
    rng = np.random.default_rng(R * KP)
    slots, meta = _star(layout, R + KP, E=4500 if layout == "ragged" else None)
    G = slots.numel() // NWL
    nb = -(-G // R)
    pools = torch.stack([_star_pool("hub", rng, slots[:NWL], meta[:NWL], 400,
                                    KP) for _ in range(nb)])
    fold_slot, fold_draw = star_fold_chains(slots, meta, pools, R=R)
    assert fold_slot.shape == (nb, NWL) and fold_draw.shape == (nb, KP)
    for b in range(nb):
        g = min(b * R + R - 1, G - 1)
        one = star_fold_chains(slots[g * NWL:(g + 1) * NWL],
                               meta[g * NWL:(g + 1) * NWL], pools[b])
        assert torch.equal(fold_slot[b], one[0])
        assert torch.equal(fold_draw[b], one[1])
    assert (fold_slot >= 0).any()
    if layout == "ragged" and R > 1:
        assert G % R  # a last block of fewer groups


def _star_owners(ids, meta, pool):
    """Each team's row in a star block end's scatter, as star_sgns.cu's
    teams decide it (owned_writes.cuh: f32_owner with a team a slot): slot
    team t owns its row where it is the row's first real slot, with the
    row's draws where the pool draws it; pool team k where it is the row's
    first draw and fold_draw[k] is 0.  Returns {row: [(team kind, slot or
    draw, slots, draws)]}."""
    info, order = star_chains_reference(ids, meta)
    pinfo, porder = pool_chains_reference(pool)
    fold_slot, fold_draw = star_fold_chains_reference(ids, meta, pool)
    info, order, pinfo, porder = (x[0].tolist() for x in
                                  (info, order, pinfo, porder))
    fold_slot, fold_draw = fold_slot.tolist(), fold_draw.tolist()
    ids = ids.tolist()
    out = {}
    for i in range(NWL + len(pool)):
        if i < NWL:
            place, n = info[i]
            if n == 0:
                continue
            at = fold_slot[i]
            pn = pinfo[porder[at]][1] if at >= 0 else 0
            out.setdefault(ids[i], []).append(
                ("slot", i, order[place:place + n],
                 [porder[at + j] for j in range(pn)]))
        else:
            k = i - NWL
            place, pn = pinfo[k]
            if pn > 0 and not fold_draw[k]:
                out.setdefault(int(pool[k]), []).append(
                    ("pool", k, [], porder[place:place + pn]))
    return out


@pytest.mark.parametrize("layout", STAR_LAYOUTS)
@pytest.mark.parametrize("KP", [100, 2048])
def test_every_touched_star_row_has_one_owner_and_slots_outrank_draws(
        layout, KP):
    rng = np.random.default_rng(KP + 2 * len(layout))
    V = 400
    slots, meta = _star(layout, KP + 1)
    ids, mt = slots[:NWL], meta[:NWL]
    pool = _star_pool("hub", rng, ids, mt, V, KP)
    owners = _star_owners(ids, mt, pool)
    real = [t for t in range(NWL) if int(mt[t]) != PAD_META]
    slot_rows = {int(ids[t]) for t in real}
    assert set(owners) == slot_rows | set(pool.tolist())
    for v, own in owners.items():
        assert len(own) == 1, (v, own)
        who, at, sl, draws = own[0]
        assert who == ("slot" if v in slot_rows else "pool")
        assert sl == [t for t in real if int(ids[t]) == v]
        assert draws == [k for k in range(KP) if int(pool[k]) == v]
        assert at == (sl or draws)[0]
    assert len(owners[0][0][3]) > 1  # the hub: its slots and many draws
    assert any(o[0][2] and o[0][3] for o in owners.values())


def _owned_star_step(emb, slots, meta, pools, lr, negw, R):
    """The star step as the card's loop writes it: star_group_grads a
    group, then its slot writes in slot order and, at a block end, the
    pool's draws in draw order (star_scatter_reference), in place of the
    plain step's index_add_.  Returns (emb, loss, pairs)."""
    d = emb.shape[1]
    G = slots.numel() // NWL
    loss = pairs = 0.0
    for g in range(G):
        pool = pools[g // R].long()
        if g % R == 0:
            cneg, dneg = emb[pool].clone(), torch.zeros((len(pool), d))
        sl, mt = slots[g * NWL:(g + 1) * NWL], meta[g * NWL:(g + 1) * NWL]
        dphi, ddneg, lpos, lneg, n = star_group_grads(
            emb[sl.long()], mt, cneg, negw, False)
        loss -= float(lpos) + float(lneg)
        pairs += float(n)
        dneg = dneg + ddneg
        end = g % R == R - 1 or g == G - 1
        star_scatter_reference(emb, sl, mt, dphi, torch.zeros_like(dphi),
                               lr, pool=pools[g // R] if end else None,
                               dneg=dneg if end else None)
    return emb, loss, pairs


@pytest.mark.parametrize("layout,R,KP", [("hub", 1, 100), ("hub", 3, 100),
                                         ("fat", 1, 64), ("ragged", 3, 32)])
def test_star_step_with_split_hubs_and_repeated_draws_matches_pallas(
        layout, R, KP):
    """The star step on split and fat hubs and pools that draw the hub over
    and over, at R 1 and 3 (a last block of fewer groups), against the
    Pallas star kernel in interpret mode: the plain step (star_sgns_step on
    the CPU) and the step written as the card's loop writes it (slot order,
    then the draws) both within the kernel tests' f32 tolerance (rtol
    1e-3, atol 3e-5 on the table, loss rtol 1e-4, pair counts exact)."""
    rng = np.random.default_rng(KP + R)
    V, d = 400, 128
    slots, meta = _star(layout, 3)
    G = slots.numel() // NWL
    emb = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    pools = torch.stack([_star_pool("hub", rng, slots[:NWL], meta[:NWL], V,
                                    KP) for _ in range(-(-G // R))])
    lr, negw = 0.05, 5.0 / KP
    je, jl, jn = fused_star_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots.numpy()),
        jnp.asarray(meta.numpy()), jnp.asarray(pools.numpy()), lr, negw,
        seed=0, interpret=True, pool_refresh=R)
    te, tl, tn = star_sgns_step(torch.tensor(emb), slots, meta, pools, lr,
                                negw, pool_refresh=R)
    oe, ol, on = _owned_star_step(torch.tensor(emb), slots, meta, pools, lr,
                                  negw, R)
    arcs = int(((meta != PAD_META) & (meta % 2 == 0)).sum())
    assert float(tn) == float(jn) == on == 2.0 * arcs
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(ol, float(jl), rtol=1e-4)
    for got in (te, oe):
        np.testing.assert_allclose(got.numpy(), np.asarray(je), rtol=1e-3,
                                   atol=3e-5)
    moved = (te.numpy() != emb).any(1)
    assert moved[0] and moved[pools.unique().numpy()].all()


def test_the_star_wrappers_run_their_plain_versions_on_the_cpu():
    rng = np.random.default_rng(9)
    V, d, KP = 400, 12, 50
    slots, meta = _star("pads", 2)
    ids, mt = slots[:NWL], meta[:NWL]
    emb = torch.tensor(rng.normal(size=(V, d)).astype(np.float32))
    dphi, dphin = (torch.tensor(rng.normal(size=(NWL, d)).astype(
        np.float32)) for _ in range(2))
    pool = _star_pool("hub", rng, ids, mt, V, KP)
    dneg = torch.tensor(rng.normal(size=(KP, d)).astype(np.float32))
    got = star_scatter(emb.clone(), ids, mt, dphi, dphin, 0.02, pool=pool,
                       dneg=dneg)
    want = star_scatter_reference(emb.clone(), ids, mt, dphi, dphin, 0.02,
                                  pool=pool, dneg=dneg)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):  # a bf16 table
        star_scatter(emb.to(torch.bfloat16), ids, mt, dphi, dphin, 0.02)
    with pytest.raises(ValueError):  # updates of another width
        star_scatter(emb.clone(), ids, mt, dphi[:, :5], dphin[:, :5], 0.02)
    with pytest.raises(ValueError):  # a pool without its dneg
        star_scatter(emb.clone(), ids, mt, dphi, dphin, 0.02, pool=pool)
    with pytest.raises(ValueError):  # not one group
        star_scatter(emb.clone(), slots, meta, dphi, dphin, 0.02)
    with pytest.raises(ValueError):  # not whole groups
        star_chains(slots[:1000], meta[:1000])
    with pytest.raises(ValueError):  # meta of another length
        star_chains(slots, meta[:NWL])
    with pytest.raises(ValueError):  # not one group
        star_fold_chains(slots, meta, pool)
    info, order = star_chains(slots, meta)
    ref = star_chains_reference(slots, meta)
    assert torch.equal(info, ref[0]) and torch.equal(order, ref[1])
