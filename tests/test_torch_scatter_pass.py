"""K3's slot scatter and slot chains (``ops/scatter_pass.py``): the
scatter's plain version against the code it was factored out of, the plain
version of the chains that the scatter follows, the plain K3 step on
hub-heavy walks against the JAX package's Pallas kernel, and the wrappers
on the CPU.  The CUDA kernels themselves are held against these plain
versions, bit for bit, by ``tests/test_torch_cuda.py`` (``-m cuda``) and
``chip_smoke.py``'s phase 4m.

Tolerances: the factored plain functions equal the old code bit for bit;
the plain K3 step (truncation) on walks that a few rows fill equals the
Pallas bf16-table kernel in interpret mode bit for bit but for one bf16 ulp
on at most 0.1% of the elements (both write a row's repeated slots in slot
order; the two sum their f32 products in another order, which moves one
element of 1920 at d 32 and none at d 128), loss within 1e-5 relative,
pair counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.ops.pallas_walk_sgns import fused_walk_sgns_step
from come_tpu_torch.ops import walk_sgns as ws
from come_tpu_torch.ops.scatter_pass import (
    slot_chains,
    slot_chains_reference,
    walk_scatter_bf16,
)
from come_tpu_torch.ops.walk_sgns import (
    LP,
    NWL,
    pad_walks,
    rmw_rows,
    sr_bits,
    sr_key,
    walk_scatter_bf16_reference,
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
