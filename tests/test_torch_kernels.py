"""The port's O1/O2 kernel plain versions vs the JAX Pallas kernels.

The Pallas kernels run in interpret mode on the CPU (as the JAX package's
own kernel tests run them) and the numpy oracles give the group-sequential
semantics.  Both sides get the same tables, walks, window draws and pools,
made with numpy from a seed.  CPU tensors route the port's wrappers to
their plain versions, so these tests exercise ``walk_sgns_step`` /
``star_sgns_step`` as the CPU trainer calls them.  The CUDA kernels are
held against the same plain versions on the card by ``chip_smoke.py``.

Tolerance: rtol 1e-3, atol 3e-5 on the tables (the JAX package's own
kernel-test tolerance: f32 sums taken in another order), rtol 1e-4 on the
loss, exact pair counts.

The bf16 modes (``mxu_bf16``: K1b, K2b, K4 and K5 with bf16) are compared
on the table updates (after minus before) under ``ops/tolerance.py``'s
check: relative L2 error <= 4e-4, every element within 2^-8 of the largest
update (one bf16 ulp of a rounded g flips where two f32 sum orders
straddle a rounding boundary, and flips compound over a step's groups).
Each test also requires the f32 step's updates to lie at least 5x farther
away than the port's and 2x past the bound, so it sees the flag.  On the
CPU, XLA rounds where the Pallas source casts to bf16 and sums in f32 as
torch does: the two agree to ~6e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.evaluation import oracle
from come_tpu.ops.pallas_star_sgns import fused_star_sgns_step
from come_tpu.ops.pallas_walk_sgns import (
    fused_walk_sgns_gen_step,
    fused_walk_sgns_step,
    pack_csr_gen,
)
from come_tpu_torch.graphs import CSRGraph
from come_tpu_torch.ops.star_sgns import star_sgns_step
from come_tpu_torch.ops.tolerance import check_bf16
from come_tpu_torch.ops.walk_sgns import (
    NWL,
    pad_walks,
    walk_sgns_gen_step,
    walk_sgns_step,
    walks_from_bits,
)
from come_tpu_torch.sampling.stars import PAD_META, build_star_layout

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 3e-5


def assert_bf16_close(init, got, want, f32):
    """``got`` within the bf16 check of ``want``, which the f32 updates
    ``f32`` fail (``ops/tolerance.py``)."""
    want = [np.array(w) for w in want]  # writable copies of JAX outputs
    check_bf16("bf16 mode", init, got, want, f32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _tables(rng, V, d=128):
    emb_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    emb_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    return emb_in, emb_out


@pytest.mark.parametrize(
    "V,L,W,KP,R",
    [(60, 20, 2, 16, 1), (120, 24, 3, 8, 1), (200, 20, 3, 16, 2),
     (90, 24, 2, 8, 2),
     # the card's band strips are 8 centres: the whole walk in the band
     # (W >= L - 1), an odd L, and a W wider than a strip
     (100, 20, 19, 16, 1), (80, 17, 3, 8, 2), (120, 27, 11, 16, 1)],
)
def test_walk_plain_matches_pallas_kernel(V, L, W, KP, R):
    rng = np.random.default_rng(V + L)
    emb_in, emb_out = _tables(rng, V)
    walks = rng.integers(0, V, (16, L)).astype(np.int32)  # 2 groups
    pools = rng.integers(0, V, (-(-2 // R), KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP

    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(walks),
        jnp.asarray(pools), lr, negw, seed=0, window=W, interpret=True,
        reduced_window=False, pool_refresh=R,
    )
    wrow = torch.full((2 * NWL,), W, dtype=torch.int32)  # full window
    ti, to, tl, tn = walk_sgns_step(
        _t(emb_in), _t(emb_out), _t(walks), wrow, _t(pools), lr, negw,
        window=W, pool_refresh=R,
    )
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("R,L,W", [
    pytest.param(1, 20, 3, id="1"), pytest.param(2, 20, 3, id="2"),
    # the card's band-strip edges: W >= L - 1, odd L, W wider than a strip
    pytest.param(1, 20, 19, id="1-L20-W19"),
    pytest.param(2, 17, 3, id="2-L17-W3"),
    pytest.param(1, 27, 11, id="1-L27-W11"),
])
def test_walk_plain_reduced_window_matches_oracle(R, L, W):
    """Reduced windows (the TPU draws them in-kernel; the interpreter can
    only train the full window) against the numpy oracle, same draws."""
    rng = np.random.default_rng(7 + R if (L, W) == (20, 3) else 100 + L + W)
    V, KP = 150, 16
    emb_in, emb_out = _tables(rng, V)
    walks = rng.integers(0, V, (24, L)).astype(np.int32)  # 3 groups
    G = 3
    pools = rng.integers(0, V, (-(-G // R), KP)).astype(np.int32)
    wslots = rng.integers(1, W + 1, (G * NWL,)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP

    ri, ro, rl, rn = oracle.walk_banded_kernel_sequential(
        emb_in, emb_out, walks, pools, wslots.reshape(G * 8, 128)[:, :L],
        negw, lr, walks_per_group=8, pool_refresh=R,
    )
    ti, to, tl, tn = walk_sgns_step(
        _t(emb_in), _t(emb_out), _t(walks), _t(wslots), _t(pools), lr, negw,
        window=W, pool_refresh=R,
    )
    assert float(tn) == rn
    np.testing.assert_allclose(float(tl), rl, rtol=1e-4)
    np.testing.assert_allclose(ti.numpy(), ri, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to.numpy(), ro, rtol=RTOL, atol=ATOL)


def test_pad_walks_wraps_and_pads():
    walks = torch.arange(3 * 5, dtype=torch.int32).reshape(3, 5)
    slots = pad_walks(walks).reshape(8, 128)
    assert slots.shape == (8, 128)
    np.testing.assert_array_equal(slots[:, :5].numpy(),
                                  walks[np.arange(8) % 3].numpy())
    assert int(slots[:, 5:].abs().sum()) == 0


def _star_stream(rng, V, edges_per_group, n_groups):
    """A star slot stream of n_groups 1024-slot groups, each the port's
    layout of its own random edge list."""
    ss, ms = [], []
    for e in range(n_groups):
        u = rng.integers(0, V, edges_per_group + 10 * e)
        v = rng.integers(0, V, edges_per_group + 10 * e)
        keep = u != v
        s, m = build_star_layout(u[keep], v[keep], V)
        assert s.shape[0] <= NWL
        ss.append(np.pad(s, (0, NWL - s.shape[0])))
        ms.append(np.pad(m, (0, NWL - m.shape[0]), constant_values=PAD_META))
    return np.concatenate(ss), np.concatenate(ms)


@pytest.mark.parametrize("V,KP,R,n_groups", [(60, 16, 1, 1), (90, 8, 1, 2),
                                             (120, 8, 2, 3)])
def test_star_plain_matches_pallas_kernel_and_oracle(V, KP, R, n_groups):
    rng = np.random.default_rng(V)
    emb = (rng.normal(size=(V, 128)) * 0.1).astype(np.float32)
    slots, meta = _star_stream(rng, V, 280, n_groups)
    pools = rng.integers(0, V, (-(-n_groups // R), KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP

    je, jl, jn = fused_star_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(pools), lr, negw, seed=0, interpret=True,
        pool_refresh=R,
    )
    oe, ol, on = oracle.star_kernel_sequential(
        emb, slots, meta, pools, negw, lr, pool_refresh=R
    )
    te, tl, tn = star_sgns_step(
        _t(emb), _t(slots), _t(meta), _t(pools), lr, negw, pool_refresh=R
    )
    arcs = int(np.sum((meta != PAD_META) & (meta % 2 == 0)))
    assert float(tn) == float(jn) == on == 2.0 * arcs
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tl), ol, rtol=1e-4)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(te.numpy(), oe, rtol=RTOL, atol=ATOL)


def test_star_plain_pads_tail_with_self_masking_slots():
    """A stream shorter than a group pads with meta -2 slots that add
    exactly nothing (same result as padding by hand)."""
    rng = np.random.default_rng(3)
    V, KP = 70, 8
    emb = (rng.normal(size=(V, 128)) * 0.1).astype(np.float32)
    u = rng.integers(0, V, 200)
    v = (u + 1 + rng.integers(0, V - 1, 200)) % V
    slots, meta = build_star_layout(u, v, V)
    pools = rng.integers(0, V, (1, KP)).astype(np.int32)
    a = star_sgns_step(_t(emb), _t(slots), _t(meta), _t(pools), 0.05, 0.5)
    full_s = np.pad(slots, (0, NWL - slots.shape[0]))
    full_m = np.pad(meta, (0, NWL - meta.shape[0]), constant_values=PAD_META)
    b = star_sgns_step(_t(emb), _t(full_s), _t(full_m), _t(pools), 0.05, 0.5)
    assert torch.equal(a[0], b[0]) and float(a[2]) == float(b[2])


def test_wrappers_reject_other_devices():
    emb = torch.zeros((8, 128), device="meta")
    with pytest.raises(ValueError, match="no walk_sgns kernel"):
        walk_sgns_step(emb, emb, torch.zeros((8, 4), dtype=torch.int32),
                       None, None, 0.1, 0.1, window=2)
    with pytest.raises(ValueError, match="no star_sgns kernel"):
        star_sgns_step(emb, None, None, None, 0.1, 0.1)


# ------------------------------------------------- K1b, K2b: mxu_bf16=True


@pytest.mark.parametrize("V,L,W,KP,R", [(60, 20, 2, 16, 1),
                                        (200, 20, 3, 16, 2),
                                        (120, 24, 3, 8, 1),
                                        (100, 20, 19, 16, 1),
                                        (80, 17, 3, 8, 2),
                                        (120, 27, 11, 16, 1)])
def test_walk_bf16_plain_matches_pallas_kernel(V, L, W, KP, R):
    rng = np.random.default_rng(V + L + 1)
    emb_in, emb_out = _tables(rng, V)
    walks = rng.integers(0, V, (16, L)).astype(np.int32)  # 2 groups
    pools = rng.integers(0, V, (-(-2 // R), KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP

    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(walks),
        jnp.asarray(pools), lr, negw, seed=0, window=W, interpret=True,
        reduced_window=False, pool_refresh=R, mxu_bf16=True,
    )
    wrow = torch.full((2 * NWL,), W, dtype=torch.int32)

    def port(bf16):
        return walk_sgns_step(
            _t(emb_in), _t(emb_out), _t(walks), wrow, _t(pools), lr, negw,
            window=W, pool_refresh=R, mxu_bf16=bf16,
        )

    ti, to, tl, tn = port(True)
    fi, fo, _, _ = port(False)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    assert_bf16_close((emb_in, emb_out), (ti, to),
                      (np.asarray(ji), np.asarray(jo)), (fi, fo))


@pytest.mark.parametrize("V,KP,R,n_groups", [(60, 16, 1, 1), (120, 8, 2, 3)])
def test_star_bf16_plain_matches_pallas_kernel(V, KP, R, n_groups):
    rng = np.random.default_rng(V + 5)
    emb = (rng.normal(size=(V, 128)) * 0.1).astype(np.float32)
    slots, meta = _star_stream(rng, V, 280, n_groups)
    pools = rng.integers(0, V, (-(-n_groups // R), KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP

    je, jl, jn = fused_star_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(pools), lr, negw, seed=0, interpret=True,
        pool_refresh=R, mxu_bf16=True,
    )

    def port(bf16):
        return star_sgns_step(_t(emb), _t(slots), _t(meta), _t(pools), lr,
                              negw, pool_refresh=R, mxu_bf16=bf16)

    te, tl, tn = port(True)
    fe, _, _ = port(False)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    assert_bf16_close((emb,), (te,), (np.asarray(je),), (fe,))


# ------------------------------------------------------ K5: paired=True


def _edge_rows(rng, V, n_rows, L=128):
    """[n_rows, L] rows of L/2 random edges [u0, v0, u1, v1, ...]."""
    u = rng.integers(0, V, n_rows * L // 2)
    v = (u + 1 + rng.integers(0, V - 1, u.shape[0])) % V
    return np.stack([u, v], 1).reshape(n_rows, L).astype(np.int32)


@pytest.mark.parametrize("V,KP,R,n_groups,L", [(90, 16, 1, 1, 128),
                                               (150, 8, 2, 3, 128),
                                               (120, 8, 2, 2, 40)])
def test_paired_plain_matches_pallas_kernel_and_oracle(V, KP, R, n_groups,
                                                       L):
    rng = np.random.default_rng(V + n_groups)
    emb_in, emb_out = _tables(rng, V)
    rows = _edge_rows(rng, V, 8 * n_groups, L)
    pools = rng.integers(0, V, (-(-n_groups // R), KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP

    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(rows),
        jnp.asarray(pools), lr, negw, seed=0, window=1, interpret=True,
        reduced_window=False, pool_refresh=R, paired=True,
    )
    oi, oo, ol, on = oracle.walk_banded_kernel_sequential(
        emb_in, emb_out, rows, pools, np.zeros_like(rows), negw, lr,
        walks_per_group=8, pool_refresh=R, paired=True,
    )
    ti, to, tl, tn = walk_sgns_step(
        _t(emb_in), _t(emb_out), _t(rows), None, _t(pools), lr, negw,
        window=1, pool_refresh=R, paired=True,
    )
    assert float(tn) == float(jn) == on == rows.size
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tl), ol, rtol=1e-4)
    for t, j, o in ((ti, ji, oi), (to, jo, oo)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(t.numpy(), o, rtol=RTOL, atol=ATOL)


def test_paired_bf16_rounds_only_the_negative_pass():
    """K5 with mxu_bf16: the plain version against the Pallas kernel in the
    same mode, and with negw = 0 (no negative pass) bit for bit the f32
    step: the TPU's paired positive pass is f32 even with mxu_bf16."""
    rng = np.random.default_rng(11)
    V, KP, R = 150, 16, 2
    emb_in, emb_out = _tables(rng, V)
    rows = _edge_rows(rng, V, 24)  # 3 groups
    pools = rng.integers(0, V, (2, KP)).astype(np.int32)
    lr = 0.05

    def port(bf16, negw):
        return walk_sgns_step(
            _t(emb_in), _t(emb_out), _t(rows), None, _t(pools), lr, negw,
            window=1, pool_refresh=R, mxu_bf16=bf16, paired=True,
        )

    ji, jo, jl, _ = fused_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(rows),
        jnp.asarray(pools), lr, 5.0 / KP, seed=0, window=1, interpret=True,
        reduced_window=False, pool_refresh=R, paired=True, mxu_bf16=True,
    )
    ti, to, tl, _ = port(True, 5.0 / KP)
    fi, fo, _, _ = port(False, 5.0 / KP)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    assert_bf16_close((emb_in, emb_out), (ti, to),
                      (np.asarray(ji), np.asarray(jo)), (fi, fo))
    a, b = port(True, 0.0), port(False, 0.0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------- K4: in-kernel walks


def _np_walks_from_bits(indptr, indices, starts, bits, L, Lp=128):
    """numpy replica of the TPU kernel's walk generation (the same f32
    draw arithmetic and bit use as tests/test_pallas_walk_sgns.py)."""
    n = -(-len(starts) // 8) * 8
    bits = np.asarray(bits).reshape(n, Lp).view(np.uint32)
    walks = np.zeros((n, L), np.int32)
    inv24 = np.float32(1.0 / (1 << 24))
    for j in range(n):
        v = int(starts[j % len(starts)])
        walks[j, 0] = v
        for t in range(1, L):
            b = int(bits[j, t])
            lo, hi = int(indptr[v]), int(indptr[v + 1])
            deg = hi - lo
            if deg > 0:
                u = np.float32((b >> 8) & 0xFFFFFF) * inv24
                r = min(int(np.float32(u * np.float32(deg))), deg - 1)
                v = int(indices[lo + r])
            walks[j, t] = v
    return walks


def _gen_graph(rng, V):
    """A random graph with node V-1 isolated and node 0 of degree 2."""
    u = rng.integers(1, V - 1, 6 * V)
    v = rng.integers(1, V - 1, 6 * V)
    g = CSRGraph.from_arcs(np.r_[u, 0, 0], np.r_[v, 1, 2], num_nodes=V)
    assert g.degrees[V - 1] == 0 and g.degrees[0] == 2
    return g


def test_walks_from_bits_matches_numpy_replica():
    rng = np.random.default_rng(4)
    V, L = 70, 30
    g = _gen_graph(rng, V)
    starts = np.r_[V - 1, 0, 0, rng.integers(0, V, 10)].astype(np.int32)
    bits = rng.integers(0, 2**32, (2 * NWL,), dtype=np.uint32)
    bits[NWL // 8 + 1] = 0x80000000  # walk 1, hop 1: u = 0.5 from bit 31
    bits[2 * NWL // 8 + 1] = 0x7FFFFFFF  # walk 2, hop 1: u just below 0.5
    bits = bits.view(np.int32)
    got = walks_from_bits(_t(starts), _t(bits), _t(g.indptr), _t(g.indices),
                          L).numpy()
    want = _np_walks_from_bits(g.indptr, g.indices, starts, bits, L)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (16, L)
    assert (got[0] == V - 1).all()  # an isolated start stays where it is
    assert got[1, 1] == 2 and got[2, 1] == 1  # bit 31 picks the 2nd half
    assert (bits < 0).mean() > 0.4
    adj = {v: set(g.indices[g.indptr[v]:g.indptr[v + 1]]) for v in range(V)}
    for w in got:  # every hop is an edge, or an isolated node stays
        for a, b in zip(w[:-1], w[1:]):
            assert b in adj[a] or (b == a and not adj[a])


def test_gen_plain_matches_pallas_gen_kernel():
    """One group (G = 1) from the same starts, bits and pool through
    fused_walk_sgns_gen_step (interpret) and the port's gen step (the
    interpreter unrolls the TPU's 8 x 127 hop slots: ~15 s)."""
    rng = np.random.default_rng(9)
    V, L, W, KP = 80, 12, 3, 16
    g = _gen_graph(rng, V)
    emb_in, emb_out = _tables(rng, V)
    starts = np.r_[V - 1, rng.integers(0, V, 7)].astype(np.int32)
    bits = rng.integers(0, 2**32, (1, NWL), dtype=np.uint32)
    pools = rng.integers(0, V, (1, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    ip1, dg1, ix2 = pack_csr_gen(g.indptr, g.indices)

    ji, jo, jl, jn = fused_walk_sgns_gen_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(starts),
        jnp.asarray(bits), jnp.asarray(ip1), jnp.asarray(dg1),
        jnp.asarray(ix2), jnp.asarray(pools), lr, negw, 0, walk_length=L,
        window=W, interpret=True, reduced_window=False,
    )
    ti, to, tl, tn, walks = walk_sgns_gen_step(
        _t(emb_in), _t(emb_out), _t(starts), _t(bits.view(np.int32)),
        _t(g.indptr), _t(g.indices), torch.full((NWL,), W, dtype=torch.int32),
        _t(pools), lr, negw, walk_length=L, window=W, return_walks=True,
    )
    np.testing.assert_array_equal(
        walks.numpy(),
        _np_walks_from_bits(g.indptr, g.indices, starts, bits, L))
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)


def test_gen_bf16_plain_matches_pallas_kernel_on_its_walks():
    """K4 with mxu_bf16, two groups with R = 2: the port's gen step against
    the Pallas kernel (bf16) on the walks the numpy replica draws from the
    same bits (the JAX package's own gen-mode check)."""
    rng = np.random.default_rng(10)
    V, L, W, KP, R = 90, 20, 3, 16, 2
    g = _gen_graph(rng, V)
    emb_in, emb_out = _tables(rng, V)
    starts = np.r_[V - 1, rng.integers(0, V, 13)].astype(np.int32)
    bits = rng.integers(0, 2**32, (2 * NWL,), dtype=np.uint32)
    pools = rng.integers(0, V, (1, KP)).astype(np.int32)
    wrow = rng.integers(1, W + 1, (2 * NWL,)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    walks = _np_walks_from_bits(g.indptr, g.indices, starts, bits, L)

    oi, oo, ol, on = oracle.walk_banded_kernel_sequential(
        emb_in, emb_out, walks, pools, wrow.reshape(16, 128)[:, :L], negw,
        lr, walks_per_group=8, pool_refresh=R,
    )
    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(walks),
        jnp.asarray(pools), lr, negw, seed=0, window=W, interpret=True,
        reduced_window=False, pool_refresh=R, mxu_bf16=True,
    )

    def port(b16, draws):
        return walk_sgns_gen_step(
            _t(emb_in), _t(emb_out), _t(starts), _t(bits.view(np.int32)),
            _t(g.indptr), _t(g.indices), _t(draws), _t(pools), lr, negw,
            walk_length=L, window=W, pool_refresh=R, mxu_bf16=b16,
        )

    full = np.full_like(wrow, W)
    ti, to, tl, tn = port(True, full)
    fi, fo, _, _ = port(False, full)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    assert_bf16_close((emb_in, emb_out), (ti, to),
                      (np.asarray(ji), np.asarray(jo)), (fi, fo))
    # reduced windows (f32) against the oracle on the same walks
    ri, ro, rl, rn = port(False, wrow)
    assert float(rn) == on
    np.testing.assert_allclose(float(rl), ol, rtol=1e-4)
    np.testing.assert_allclose(ri.numpy(), oi, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ro.numpy(), oo, rtol=RTOL, atol=ATOL)
