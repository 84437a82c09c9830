"""The pool stage and K3's pool write (``ops/pool_pass.py``): their plain
versions against the code they were factored out of, the plain K3 step on a
hub-heavy pool against the JAX package's Pallas kernel, the plain version
of the chains that K3's pool write follows, the wrappers on the CPU, and
how the step wrappers count the pool passes that the C group loops launch.
The CUDA kernels themselves are held against these plain versions, bit for
bit, by ``tests/test_torch_cuda.py`` (``-m cuda``) and ``chip_smoke.py``'s
phase 4m.

Tolerances: the factored plain functions equal the old code bit for bit;
the K3 step on a hub-heavy pool takes
``tests/test_torch_large_v.py``'s rule against the Pallas kernel in
interpret mode (at least 99% of table elements bit-identical, none more
than one bf16 ulp off, loss within 1e-5 relative, pair counts exact).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.ops.pallas_walk_sgns import fused_walk_sgns_step
from come_tpu_torch.ops import build, launch_plan
from come_tpu_torch.ops import walk_sgns as ws
from come_tpu_torch.ops.pool_pass import (
    NEG_KC,
    NEG_WHOLE,
    core_off,
    pool_apply_bf16,
    pool_chains,
    pool_stage,
    pool_stage_wide_bf16,
    pool_stage_wide_bf16_reference,
    wide_row,
)
from come_tpu_torch.ops.walk_sgns import (
    NWL,
    POOL_LAUNCHES,
    POOL_PASSES,
    count_pool_passes,
    mxu,
    new_pools,
    pool_apply_bf16_reference,
    pool_sr_bits,
    pool_stage_reference,
    rmw_rows,
    sr_bits,
    sr_key,
    walk_sgns_step,
)

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parents[1] / "come_tpu_torch" / "csrc"


def _bits16(t):
    return t.view(torch.int16).numpy().astype(np.int32)


def _hub_pool(rng, V, KP, hubs):
    """KP draws over ``hubs`` distinct rows: every row drawn many times."""
    rows = rng.choice(V, size=hubs, replace=False)
    return rows[rng.integers(0, hubs, KP)].astype(np.int32)


def _pool(kind, rng, V, KP):
    if kind == "hub":
        return _hub_pool(rng, V, KP, 16)
    if kind == "unigram":  # a power-law of draws, as unigram^0.75 pools
        w = 1.0 / np.arange(1, V + 1) ** 0.9
        return rng.choice(V, size=KP, p=w / w.sum()).astype(np.int32)
    return rng.integers(0, V, KP).astype(np.int32)


# --------------------------------------- the factored plain functions


def _old_stage(emb_out, pool, acc, mxu_bf16):
    """walk_sgns_step_reference's inline stage before it was factored."""
    cneg = mxu(emb_out[pool].to(acc), mxu_bf16)
    dneg = torch.zeros_like(cneg)
    return cneg, dneg


def _old_pool_write(emb_out, pool, dneg, lr, sr_seed, g):
    """walk_sgns_step_reference's inline K3 pool write before it was
    factored (its SR counters: slot t's element k at t * d + k, pool row k
    at slot 1024 + k)."""
    d = emb_out.shape[1]
    counter = torch.arange((NWL + pool.numel()) * d).view(-1, d)
    pbits = None
    if sr_seed is not None:
        pbits = sr_bits(sr_key(sr_seed, g), counter[NWL:]) & 0xFFFF
    rmw_rows(emb_out, pool, (dneg * (-lr)).float(), pbits)
    return emb_out


@pytest.mark.parametrize("dtype,acc,mxu_bf16", [
    (torch.float32, torch.float32, False),
    (torch.float32, torch.float32, True),
    (torch.bfloat16, torch.float32, True),
    (torch.float32, torch.float64, False),
    (torch.bfloat16, torch.float64, True),
])
def test_stage_reference_equals_the_old_inline_stage(dtype, acc, mxu_bf16):
    rng = np.random.default_rng(1)
    table = torch.tensor(rng.normal(size=(300, 24)).astype(np.float32) * .1
                         ).to(dtype)
    pool = torch.tensor(_pool("hub", rng, 300, 200)).long()
    old_c, old_d = _old_stage(table, pool, acc, mxu_bf16)
    cneg, dneg = pool_stage_reference(table, pool, acc)
    cneg = mxu(cneg, mxu_bf16)
    assert cneg.dtype == old_c.dtype == acc and dneg.dtype == acc
    assert torch.equal(cneg, old_c) and torch.equal(dneg, old_d)


@pytest.mark.parametrize("kind", ["uniform", "unigram", "hub"])
@pytest.mark.parametrize("sr_seed", [None, 12345])
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
def test_pool_write_reference_equals_the_old_inline_write(kind, sr_seed,
                                                          acc):
    rng = np.random.default_rng(2)
    V, d, KP, g, lr = 400, 20, 300, 7, 0.05
    table = torch.tensor(rng.normal(size=(V, d)).astype(np.float32) * .1
                         ).to(torch.bfloat16)
    pool = torch.tensor(_pool(kind, rng, V, KP)).long()
    dneg = torch.tensor(rng.normal(size=(KP, d))).to(acc)
    want = _old_pool_write(table.clone(), pool, dneg, lr, sr_seed, g)
    got = pool_apply_bf16_reference(table.clone(), pool, dneg, lr,
                                    pool_sr_bits(sr_seed, g, KP, d, "cpu"))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("sr_seed", [None, 99])
def test_step_reference_equals_the_old_inline_step(sr_seed, monkeypatch):
    """A whole K3 step (two blocks of R 2, hub-heavy pools) through the
    factored functions equals the step through the old inline code, bit
    for bit."""
    rng = np.random.default_rng(3)
    V, d, L, KP, B = 50, 16, 30, 40, 24
    ei = torch.tensor(rng.normal(size=(V, d)).astype(np.float32) * .1
                      ).to(torch.bfloat16)
    eo = torch.tensor(rng.normal(size=(V, d)).astype(np.float32) * .1
                      ).to(torch.bfloat16)
    walks = torch.tensor(rng.integers(0, V, (B, L)), dtype=torch.int32)
    pools = torch.tensor(np.stack([_hub_pool(rng, V, KP, 5)
                                   for _ in range(2)]))
    wrow = torch.tensor(rng.integers(1, 4, 3 * NWL), dtype=torch.int32)

    def step():
        return ws.walk_sgns_step_reference(
            ei.clone(), eo.clone(), walks, wrow, pools, 0.05, 5.0 / KP,
            window=3, pool_refresh=2, sr_seed=sr_seed)

    new = step()
    groups = iter(g for g in (1, 2))  # the blocks end at groups 1 and 2

    def old_apply(table, pool, dneg, lr, rnd):
        return _old_pool_write(table, pool, dneg, lr, sr_seed, next(groups))

    monkeypatch.setattr(ws, "pool_apply_bf16_reference", old_apply)
    monkeypatch.setattr(ws, "pool_stage_reference",
                        lambda t, p, acc: _old_stage(t, p, acc, False))
    old = step()
    for a, b in zip(new[:2], old[:2]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert float(new[2]) == float(old[2]) and float(new[3]) == float(old[3])


# ------------------------------------- a hub-heavy pool against the TPU


@pytest.mark.parametrize("d", [32, 128])
def test_k3_step_on_a_hub_heavy_pool_matches_pallas_interpret(d):
    """The plain K3 step (truncation) on pools that draw 4 rows over and
    over against the Pallas bf16-table kernel in interpret mode, whose
    _apply_pool applies the repeats in draw order: the rule of
    tests/test_torch_large_v.py's K3 check."""
    rng = np.random.default_rng(11)
    V, L, W, KP, R, B = 60, 40, 4, 64, 2, 24  # 3 groups, 2 pools

    def bf16(a):
        return torch.tensor(a).to(torch.bfloat16)

    def to_jax(t):
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)

    ei = bf16((rng.normal(size=(V, d)) * 0.1).astype(np.float32))
    eo = bf16((rng.normal(size=(V, d)) * 0.1).astype(np.float32))
    walks = rng.integers(0, V, (B, L)).astype(np.int32)
    G = -(-B // 8)
    pools = np.stack([_hub_pool(rng, V, KP, 4) for _ in range(-(-G // R))])
    lr, negw = 0.05, 5.0 / KP
    ji, jo, jl, jn = fused_walk_sgns_step(
        to_jax(ei), to_jax(eo), jnp.asarray(walks), jnp.asarray(pools),
        lr, negw, seed=0, window=W, interpret=True, reduced_window=False,
        pool_refresh=R,
    )
    ti, to, tl, tn = walk_sgns_step(
        ei.clone(), eo.clone(), torch.tensor(walks),
        torch.full((G * NWL,), W, dtype=torch.int32), torch.tensor(pools),
        lr, negw, window=W, pool_refresh=R, sr_seed=None)
    assert float(tn) == float(jn)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for a, b in ((ti, ji), (to, jo)):
        diff = np.abs(_bits16(a) - np.asarray(b.view(jnp.int16)).astype(
            np.int32))
        assert (diff == 0).mean() >= 0.99
        assert diff.max() <= 1
    # the hubs' rows did move: the pool write is not a no-op
    assert (_bits16(to) != _bits16(eo)).any()


# ------------------------------------ the bf16 stage past d 192 (wide)


def unpack_wide_bf16(cnegb, KP: int, d: int) -> torch.Tensor:
    """The rows [KP, wide_row(d)] bf16 of a stage in the wide pass's
    layout, element by element through core_off: whole chunks of NEG_KC
    rows as blocks by chunk and slab, a last partial chunk's rows plain."""
    wd = wide_row(d)
    k = torch.arange(KP)[:, None]
    c = torch.arange(wd)[None, :]
    whole = KP // NEG_KC * NEG_KC
    blk = ((k // NEG_KC) * (wd // NEG_WHOLE) + c // NEG_WHOLE) * \
        (NEG_KC * NEG_WHOLE) + core_off(NEG_KC, k % NEG_KC, c % NEG_WHOLE)
    return cnegb[torch.where(k < whole, blk, k * wd + c)]


def test_core_off_places_each_element_once_with_8_columns_together():
    """core_off over a block of R rows and NEG_WHOLE columns is a bijection
    onto [0, R * NEG_WHOLE), 8 consecutive columns from a multiple of 8 lie
    in 8 consecutive elements (one 16-byte piece), and 8 consecutive rows
    of such a piece one 128-byte core matrix."""
    R = NEG_KC
    r = torch.arange(R)[:, None]
    c = torch.arange(NEG_WHOLE)[None, :]
    off = core_off(R, r, c)
    assert sorted(off.reshape(-1).tolist()) == list(range(R * NEG_WHOLE))
    pieces = off.view(R, NEG_WHOLE // 8, 8)
    assert torch.equal(pieces - pieces[..., :1],
                       torch.arange(8).expand(R, NEG_WHOLE // 8, 8))
    piece = off[:, ::8]
    assert (piece % 8 == 0).all()
    assert torch.equal(piece.view(R // 8, 8, -1)[:, 1:] -
                       piece.view(R // 8, 8, -1)[:, :-1],
                       torch.full((R // 8, 7, NEG_WHOLE // 8), 8))
    assert core_off(R, 9, 17) == ((2 * 4 + 1) * 64 + 1 * 8 + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KP,d", [(96, 256), (64, 264), (100, 256),
                                  (37, 300), (5, 193), (32, 512)])
def test_the_wide_stage_unpacks_to_the_pool_rows_rounded_to_bf16(dtype, KP,
                                                                  d):
    """pool_stage_wide_bf16's plain version: unpacking its buffer through
    core_off gives table[pool] rounded to bf16 (nearest even), zeros past
    d, at widths of one and two slabs, with and without a partial last
    chunk; dneg is zeros [KP, d]."""
    rng = np.random.default_rng(KP + d)
    table = torch.tensor(rng.normal(size=(120, d)).astype(np.float32)
                         ).to(dtype)
    pool = torch.tensor(_pool("hub", rng, 120, KP))
    cnegb, dneg = pool_stage_wide_bf16(table, pool)
    assert cnegb.dtype == torch.bfloat16
    assert cnegb.shape == (KP * wide_row(d),)
    rows = unpack_wide_bf16(cnegb, KP, d)
    want = torch.zeros((KP, wide_row(d)), dtype=torch.bfloat16)
    want[:, :d] = table[pool.long()].to(torch.bfloat16)
    assert torch.equal(rows.view(torch.int16), want.view(torch.int16))
    assert dneg.dtype == torch.float32 and dneg.shape == (KP, d)
    assert not dneg.any()
    # a whole chunk's first slab is one block of NEG_KC x NEG_WHOLE
    if KP >= NEG_KC:
        blk = cnegb[:NEG_KC * NEG_WHOLE]
        assert torch.equal(blk[core_off(NEG_KC, 3, 17)].view(torch.int16),
                           want[3, 17].view(torch.int16))


def test_the_wide_stage_rounds_f32_rows_to_nearest_even():
    """An f32 row halfway between two bf16 values stages as the even one,
    as __float2bfloat16_rn rounds it."""
    table = torch.zeros((2, 256))
    table[0, 0] = 1.0 + 2.0 ** -8  # halfway: rounds down to even 1.0
    table[0, 1] = 1.0 + 3 * 2.0 ** -8  # halfway: rounds up to 1 + 2^-6
    cnegb, _ = pool_stage_wide_bf16_reference(table, torch.tensor([0, 1]))
    rows = unpack_wide_bf16(cnegb, 2, 256).float()
    assert float(rows[0, 0]) == 1.0 and float(rows[0, 1]) == 1.0 + 2.0 ** -6


# ----------------------------------------------- the pool write's chains


@pytest.mark.parametrize("kind,KP", [("uniform", 2048), ("unigram", 2048),
                                     ("hub", 2048), ("hub", 100),
                                     ("unigram", 131), ("hub", 7), ("hub", 1)])
def test_the_chains_give_every_draw_once_to_its_rows_owner_in_order(kind,
                                                                    KP):
    """pool_chains (its plain version, the kernel's yardstick): each
    distinct row has one owner, its first draw, whose chain holds every
    draw of its row, each once, in increasing k."""
    rng = np.random.default_rng(KP)
    pool = _pool(kind, rng, 5000, KP)
    info, order = pool_chains(torch.tensor(pool))
    info, order = info[0].tolist(), order[0].tolist()
    chains = {k: order[i:i + n] for k, (i, n) in enumerate(info) if n}
    seen = sorted(k for c in chains.values() for k in c)
    assert seen == list(range(KP))
    assert len(chains) == len(set(pool.tolist()))
    for k, c in chains.items():
        assert c[0] == k == min(np.flatnonzero(pool == pool[k]))
        assert c == sorted(c) and all(pool[x] == pool[k] for x in c)
        assert len(c) == int((pool == pool[k]).sum())
    if kind == "hub" and KP == 2048:
        assert max(len(c) for c in chains.values()) >= 100


@pytest.mark.parametrize("kind,KP", [("unigram", 2048), ("hub", 300),
                                     ("uniform", 1), ("hub", 129)])
def test_the_plain_chains_sort_each_pool_stably(kind, KP):
    """pool_chains on a batch of pools: order[b] is a stable sort of pool
    b's ids and info[b, k, 0] is k's place in it."""
    rng = np.random.default_rng(KP + 7)
    pools = np.stack([_pool(kind, rng, 3000, KP) for _ in range(3)])
    info, order = pool_chains(torch.tensor(pools))
    assert info.dtype == order.dtype == torch.int32
    assert info.shape == (3, KP, 2) and order.shape == (3, KP)
    for b in range(3):
        assert order[b].tolist() == np.argsort(pools[b],
                                               kind="stable").tolist()
        assert info[b, order[b].long(), 0].tolist() == list(range(KP))


# ------------------------------------------------- wrappers and counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_stage_runs_its_plain_version_on_the_cpu(dtype):
    rng = np.random.default_rng(5)
    table = torch.tensor(rng.normal(size=(90, 10)).astype(np.float32)
                         ).to(dtype)
    pool = torch.tensor(_pool("hub", rng, 90, 33))
    cneg, dneg = pool_stage(table, pool)
    assert cneg.dtype == dneg.dtype == torch.float32
    assert torch.equal(cneg, table[pool.long()].float())
    assert not dneg.any() and dneg.shape == (33, 10)


def test_pool_apply_runs_its_plain_version_on_the_cpu():
    rng = np.random.default_rng(6)
    table = torch.tensor(rng.normal(size=(90, 10)).astype(np.float32)
                         ).to(torch.bfloat16)
    pool = torch.tensor(_pool("hub", rng, 90, 33))
    dneg = torch.tensor(rng.normal(size=(33, 10)).astype(np.float32))
    got = pool_apply_bf16(table.clone(), pool, dneg, 0.1, group=2,
                          sr_seed=77)
    want = pool_apply_bf16_reference(table.clone(), pool.long(), dneg, 0.1,
                                     pool_sr_bits(77, 2, 33, 10, "cpu"))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    with pytest.raises(ValueError):
        pool_apply_bf16(table.float(), pool, dneg, 0.1, group=2)
    with pytest.raises(ValueError):
        pool_apply_bf16(table[:, :9].contiguous(), pool, dneg[:, :9], 0.1,
                        group=2)


def test_pool_sr_bits_are_the_pool_rows_counters():
    bits = pool_sr_bits(5, 3, 4, 6, "cpu")
    k, j = 2, 5
    want = sr_bits(sr_key(5, 3), torch.tensor((NWL + k) * 6 + j)) & 0xFFFF
    assert int(bits[k, j]) == int(want)
    assert pool_sr_bits(None, 3, 4, 6, "cpu") is None


class _Lib:
    """come_step_graph_pool of a slot whose recording launched `pool`."""

    def __init__(self, pool):
        self.pool, self.reads = pool, 0

    def come_step_graph_pool(self, slot, i):
        self.reads += 1
        return self.pool[i] if slot == "slot" else -1


class _Plan:
    slot, pool = "slot", None


def test_steps_count_the_pool_passes_their_recording_launched():
    """count_pool_passes reads the slot's counts when the step records and
    adds the recorded counts again at each replay."""
    for k in POOL_LAUNCHES:
        POOL_LAUNCHES[k] = 0
    plan, lib = _Plan(), _Lib((0, 3, 1, 3, 0, 1, 5, 4, 2, 1, 1, 1, 3, 2))
    count_pool_passes(plan, launch_plan.RECORD_INSTANTIATE, lib)
    count_pool_passes(plan, launch_plan.RECORD_NONE, lib)
    assert lib.reads == len(POOL_PASSES)  # a replay reads nothing
    assert POOL_LAUNCHES == {"stage_pool": 0, "stage_pool_bf16_tables": 6,
                             "pool_chains": 2, "apply_pool_bf16": 6,
                             "stage_pool_bf16": 0, "slot_chains": 2,
                             "walk_scatter_bf16": 10, "walk_scatter": 8,
                             "block_end_scatter": 4, "apply_pool": 2,
                             "fold_chains": 2, "star_chains": 2,
                             "star_scatter": 6, "star_block_end_scatter": 4}
    # a new recording (a table moved)
    lib.pool = (2, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    count_pool_passes(plan, launch_plan.RECORD_UPDATE, lib)
    assert POOL_LAUNCHES["stage_pool"] == 2
    assert POOL_LAUNCHES["stage_pool_bf16"] == 3
    plan.slot = "gone"
    with pytest.raises(RuntimeError):
        count_pool_passes(plan, launch_plan.RECORD_UPDATE, lib)
    for k in POOL_LAUNCHES:
        POOL_LAUNCHES[k] = 0


def test_steps_count_their_own_pool_passes_beside_the_total():
    """With a step wrapper, count_pool_passes also adds the step's passes
    to that wrapper's ``pools``, so a run tells the walk steps' pool
    writes from the star steps'."""
    for k in POOL_LAUNCHES:
        POOL_LAUNCHES[k] = 0

    def walk():
        pass

    def star():
        pass

    walk.pools, star.pools = new_pools(), new_pools()
    plan_w, plan_s = _Plan(), _Plan()
    # K1b: R 2, 5 groups; K2: R 2, 3 groups (2 blocks)
    lib_w = _Lib((1, 0, 1, 0, 0, 1, 0, 3, 2, 0, 1, 0, 0, 0))
    lib_s = _Lib((2, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2))
    for _ in range(2):
        count_pool_passes(plan_w, launch_plan.RECORD_NONE, lib_w, walk)
        count_pool_passes(plan_s, launch_plan.RECORD_NONE, lib_s, star)
    count_pool_passes(plan_s, launch_plan.RECORD_NONE, lib_s)
    assert walk.pools["block_end_scatter"] == 4
    assert walk.pools["walk_scatter"] == 6 and walk.pools["apply_pool"] == 0
    assert walk.pools["star_block_end_scatter"] == 0
    assert star.pools["star_block_end_scatter"] == 4
    assert star.pools["star_scatter"] == 2 and star.pools["star_chains"] == 2
    assert star.pools["apply_pool"] == 0 and star.pools["walk_scatter"] == 0
    assert POOL_LAUNCHES["star_block_end_scatter"] == 6
    assert POOL_LAUNCHES["fold_chains"] == 2 + 3
    assert POOL_LAUNCHES["stage_pool"] == 2 + 6
    for k in POOL_LAUNCHES:
        POOL_LAUNCHES[k] = 0


def test_the_pool_passes_are_named_in_the_c_order():
    """POOL_PASSES follows sgns_common.cuh's PoolPass, which indexes the
    slot's counts."""
    src = (CSRC / "sgns_common.cuh").read_text()
    body = re.search(r"enum PoolPass \{([^}]*)\}", src).group(1)
    names = re.findall(r"PASS_(\w+) = (\d+)", body)
    assert [(n.lower(), int(i)) for n, i in names] == [
        (p, i) for i, p in enumerate(POOL_PASSES)]
    assert re.search(rf"POOL_PASSES = {len(POOL_PASSES)}\b", body)


@pytest.mark.parametrize("name,source", [
    ("come_pool_stage", "pool_pass.cu"),
    ("come_pool_apply_bf16", "pool_pass.cu"),
    ("come_pool_chains", "pool_pass.cu"),
    ("come_pool_stage_wide_bf16", "pool_pass.cu"),
    ("come_slot_chains", "walk_sgns.cu"),
    ("come_walk_scatter_bf16", "walk_sgns.cu"),
    ("come_walk_scatter_f32", "walk_sgns.cu"),
    ("come_fold_chains", "walk_sgns.cu"),
    ("come_star_chains", "star_sgns.cu"),
    ("come_star_fold_chains", "star_sgns.cu"),
    ("come_star_scatter", "star_sgns.cu"),
    ("come_star_sgns_step", "star_sgns.cu"),
    ("come_walk_sgns_step", "walk_sgns.cu"),
    ("come_walk_sgns_gen_step", "walk_sgns.cu"),
    ("come_step_graph_pool", "step_graph.cu"),
])
def test_the_c_entries_take_the_signatures_build_declares(name, source):
    src = (CSRC / source).read_text()
    for name in (name,):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        sig = build.SIGNATURES[name]
        assert len(params) == len(sig), name
        for p, t in zip(params, sig):
            if "*" in p:
                assert t is build._P, (name, p)
            elif p.startswith("float"):
                assert t is build._F, (name, p)
            elif p.startswith("unsigned"):
                assert t is build._U, (name, p)
            else:
                assert t is build._I, (name, p)
