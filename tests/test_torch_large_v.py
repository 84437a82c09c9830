"""The large-V path of the port against the JAX package: the generators and
the synthetic-10m stand-in, K3 (the walk kernel on bf16 tables with rounded
writes), the O1 table-dtype rule, chunked GMM/O3 and P1's plain versions.

K3's plain version runs in truncation mode against the Pallas kernel with
bf16 tables in interpret mode (the JAX package's own CPU path: no on-chip
PRNG, so no stochastic rounding), tables carried across bit for bit through
a uint16 view.  Tolerance: at least 99% of table elements bit-identical and
the rest within one bf16 ulp (the two sum their f32 products in another
order, which moves a write across a truncation boundary now and then; a
wrong rounding rule flips about half of them), loss within 1e-5 relative,
pair counts exact.  Everything numpy can compute exactly (graphs, hash,
rounding) is compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.graphs import datasets as jdatasets
from come_tpu.graphs.generators import dc_sbm_graph as j_dc_sbm
from come_tpu.graphs.generators import powerlaw_graph as j_powerlaw
from come_tpu.ops.pallas_walk_sgns import _pack_row, fused_walk_sgns_step
from come_tpu_torch.config import PRESETS
from come_tpu_torch.graphs import (
    dc_sbm_graph,
    get_dataset,
    powerlaw_graph,
    sbm_graph,
)
from come_tpu_torch.losses import community as tcom
from come_tpu_torch.losses import gmm as tgmm
from come_tpu_torch.ops.row_probe import row_gather_probe, row_scatter_probe
from come_tpu_torch.ops.walk_sgns import (
    NWL,
    mix32,
    rmw_rows,
    round_bf16,
    sr_bits,
    sr_key,
    walk_sgns_gen_step,
    walk_sgns_step,
)
from come_tpu_torch.trainer import come as tcome

torch.set_num_threads(2)


def _same_graph(g, jg):
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)


# ------------------------------------------------------------ generators


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dc_sbm_graph_identical(seed):
    kw = dict(avg_degree=12.0, exponent=2.3, assortativity=15.0, seed=seed)
    g, lab = dc_sbm_graph(2000, 8, **kw)
    jg, jlab = j_dc_sbm(2000, 8, **kw)
    _same_graph(g, jg)
    np.testing.assert_array_equal(lab, jlab)
    assert g.degrees.min() > 0  # every node walkable


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_powerlaw_graph_identical(seed):
    g = powerlaw_graph(2000, avg_degree=10.0, exponent=2.2, seed=seed)
    _same_graph(g, j_powerlaw(2000, avg_degree=10.0, exponent=2.2, seed=seed))


def test_synthetic_10m_identical():
    ds = get_dataset("synthetic-10m")
    jds = jdatasets.get_dataset("synthetic-10m")
    assert (ds.name, ds.num_communities) == (jds.name, jds.num_communities)
    assert ds.graph.num_nodes == 500_000 and ds.graph.num_edges > 9_900_000
    _same_graph(ds.graph, jds.graph)
    np.testing.assert_array_equal(ds.labels, jds.labels)


# ------------------------------------------------------------------ K3


def _bf16(a):
    return torch.tensor(a).to(torch.bfloat16)


def _to_jax(t):
    return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)


def _bits(x):
    """int32 bit patterns of a bf16 table (torch or JAX)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x.view(jnp.int16)).astype(np.int32)


def test_k3_truncation_matches_pallas_interpret():
    _k3_truncation_check(128)


@pytest.mark.parametrize("d", [194, 258])
def test_k3_truncation_matches_pallas_interpret_past_192(d):
    """K3 at widths whose last column slab is ragged (66 and 2 columns):
    the card stages them in slabs of 128 past 192."""
    _k3_truncation_check(d)


def _k3_truncation_check(d):
    """K3's plain version in truncation mode against the Pallas bf16-table
    kernel in interpret mode at width d: >= 99% of elements bit-identical,
    none more than one bf16 ulp off; stochastic rounding moves about half
    the touched elements off the truncated result."""
    rng = np.random.default_rng(4 if d == 128 else d)
    V, L, W, KP, R, B = 60, 40, 4, 16, 2, 24  # 3 groups, 2 pools
    ei = _bf16((rng.normal(size=(V, d)) * 0.1).astype(np.float32))
    eo = _bf16((rng.normal(size=(V, d)) * 0.1).astype(np.float32))
    walks = rng.integers(0, V, (B, L)).astype(np.int32)
    G = -(-B // 8)
    pools = rng.integers(0, V, (-(-G // R), KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP

    ji, jo, jl, jn = fused_walk_sgns_step(
        _to_jax(ei), _to_jax(eo), jnp.asarray(walks), jnp.asarray(pools),
        lr, negw, seed=0, window=W, interpret=True, reduced_window=False,
        pool_refresh=R,
    )
    wrow = torch.full((G * NWL,), W, dtype=torch.int32)

    def port(sr_seed):
        return walk_sgns_step(
            ei.clone(), eo.clone(), torch.tensor(walks), wrow,
            torch.tensor(pools), lr, negw, window=W, pool_refresh=R,
            sr_seed=sr_seed,
        )

    ti, to, tl, tn = port(None)
    assert ti.dtype == to.dtype == torch.bfloat16
    assert float(tn) == float(jn)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for a, b in ((ti, ji), (to, jo)):
        diff = np.abs(_bits(a) - _bits(b))
        assert (diff == 0).mean() >= 0.99
        assert diff.max() <= 1
    # the rounding rule is seen: stochastic rounding moves about half the
    # elements the step touched off the truncated result
    si, so, _, _ = port(12345)
    moved = (_bits(si) != _bits(ti)).mean()
    touched = (_bits(ti) != _bits(ei)).mean()
    assert moved > 0.3 * touched


def test_k3_gen_mode_equals_step_on_its_walks():
    """K3 through the gen entry point is K4's walks then K3's step."""
    g, _ = sbm_graph(200, 4, seed=3, avg_degree=8.0)
    rng = np.random.default_rng(5)
    V, d, L, W, KP = 200, 64, 30, 3, 32
    ei = _bf16((rng.normal(size=(V, d)) * 0.1).astype(np.float32))
    eo = _bf16((rng.normal(size=(V, d)) * 0.1).astype(np.float32))
    starts = torch.as_tensor(rng.integers(0, V, 16).astype(np.int32))
    bits = torch.as_tensor(rng.integers(-2**31, 2**31, 2 * NWL,
                                        dtype=np.int64).astype(np.int32))
    wrow = torch.as_tensor(rng.integers(1, W + 1, 2 * NWL).astype(np.int32))
    pools = torch.as_tensor(rng.integers(0, V, (2, KP)).astype(np.int32))
    csr = g.to_device("cpu")
    gi, go, gl, gn, walks = walk_sgns_gen_step(
        ei.clone(), eo.clone(), starts, bits, csr.indptr, csr.indices, wrow,
        pools, 0.05, 5.0 / KP, walk_length=L, window=W, return_walks=True,
        sr_seed=7,
    )
    si, so, sl, sn = walk_sgns_step(ei.clone(), eo.clone(), walks, wrow,
                                    pools, 0.05, 5.0 / KP, window=W,
                                    sr_seed=7)
    assert torch.equal(gi, si) and torch.equal(go, so)
    assert float(gl) == float(sl) and float(gn) == float(sn)


def _np_mix32(x):
    x = np.asarray(x, np.uint32).copy()
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def test_sr_hash_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 100_000, dtype=np.uint64)
    got = mix32(torch.as_tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  _np_mix32(x.astype(np.uint32)))
    for seed, g in ((0, 0), (2**32 - 1, 5), (123456789, 4000)):
        key = int(_np_mix32(np.uint32(seed) ^ _np_mix32(np.uint32(g))))
        assert sr_key(seed, g) == key
        c = np.arange(0, 3 * NWL * 128, 7, dtype=np.uint32)
        np.testing.assert_array_equal(
            sr_bits(key, torch.as_tensor(c.astype(np.int64))).numpy(),
            _np_mix32(c ^ np.uint32(key)))


def test_sr_write_matches_pack_row():
    """round_bf16 against the TPU's _pack_row (interpret path) and a numpy
    emulation of it, bit for bit, with the same 16 random bits."""
    rng = np.random.default_rng(1)
    d = 128
    new = (rng.normal(size=(64, d)) * rng.choice([1e-3, 1.0, 300.0],
                                                 (64, 1))).astype(np.float32)
    rnd = rng.integers(0, 2**32, (64, d), dtype=np.uint64).astype(np.uint32)
    got = round_bf16(torch.tensor(new),
                     torch.as_tensor((rnd & 0xFFFF).astype(np.int64)))
    got = got.view(torch.int16).numpy().view(np.uint16)
    emul = ((new.view(np.uint32) + (rnd & np.uint32(0xFFFF)))
            >> np.uint32(16)).astype(np.uint16)
    np.testing.assert_array_equal(got, emul)
    partner = rng.integers(0, 2**32, d, dtype=np.uint64).astype(np.uint32)
    for i in range(4):
        for sh in (0, 16):
            packed = np.asarray(_pack_row(
                jnp.asarray(partner), jnp.asarray(new[i]), jnp.uint32(sh),
                jnp.asarray(rnd[i]), True))
            np.testing.assert_array_equal(
                (packed >> np.uint32(sh)) & np.uint32(0xFFFF), got[i])
    trunc = round_bf16(torch.tensor(new), None).view(torch.int16).numpy()
    np.testing.assert_array_equal(trunc.view(np.uint16),
                                  (new.view(np.uint32) >> 16).astype(np.uint16))


def test_sr_is_unbiased():
    """Over 4096 draws, the mean stochastically rounded value lies within
    3 sigma of the value."""
    for x in (1.0 + 0.3 * 2**-7, -0.0123, 7.77e-5):
        xs = torch.full((4096,), x, dtype=torch.float32)
        r = sr_bits(sr_key(99, 3), torch.arange(4096)) & 0xFFFF
        out = round_bf16(xs, r).double()
        lo, hi = float(out.min()), float(out.max())
        assert lo != hi  # x lies between two bf16 values
        p = (float(torch.tensor(x, dtype=torch.float64)) - lo) / (hi - lo)
        sigma = (hi - lo) * (p * (1 - p) / 4096) ** 0.5
        assert abs(float(out.mean()) - x) <= 3 * sigma


def test_rmw_rounds_equal_slot_loop():
    """rmw_rows (rounds by occurrence rank) equals one read-modify-write
    per slot in slot order, on a group with repeated rows."""
    rng = np.random.default_rng(2)
    V, d, n = 20, 16, 300
    table = _bf16(rng.normal(size=(V, d)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, V, n))
    upd = torch.as_tensor((rng.normal(size=(n, d)) * 0.01).astype(np.float32))
    for rnd in (None, torch.as_tensor(rng.integers(0, 2**16, (n, d)))):
        want = table.clone()
        for i in range(n):
            r = None if rnd is None else rnd[i:i + 1]
            want[ids[i]] = round_bf16(want[ids[i]][None].float()
                                      + upd[i:i + 1], r)[0]
        got = table.clone()
        rmw_rows(got, ids, upd, rnd)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_paired_mode_refuses_bf16_tables():
    t = torch.zeros((8, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="paired"):
        walk_sgns_step(t, t.clone(), torch.zeros((8, 4), dtype=torch.int32),
                       None, torch.zeros((1, 4), dtype=torch.int32), 0.1,
                       0.1, window=1, paired=True)


# ------------------------------------------------------- table-dtype rule


@pytest.mark.parametrize("V,override,dtype", [
    (98_304, {}, torch.float32),  # exactly 48 MiB of f32
    (98_305, {}, torch.bfloat16),
    (500_000, {}, torch.bfloat16),
    (500_000, dict(walk_kernel_bf16_tables=False), torch.float32),
    (500_000, dict(negative_mode="per_pair"), torch.float32),  # off K1
    (500_000, dict(walk_length=200), torch.float32),
])
def test_o1_table_dtype_rule(V, override, dtype):
    cfg = PRESETS["synthetic-10m"].replace(**override)
    assert tcome.o1_table_dtype(V, 128, cfg) == dtype


def test_trainer_bf16_tables_on_cpu(monkeypatch):
    """bf16 working tables (K3's plain version) through the CPU trainer,
    with the 48 MiB line lowered: the loss falls, the params stay f32, and
    the communities are found."""
    monkeypatch.setattr(tcome, "WALK_F32_TABLE_BYTES", 1024)
    g, labels = sbm_graph(512, 4, p_in=0.1, p_out=0.002, seed=0,
                          avg_degree=20)
    cfg = PRESETS["blogcatalog"].replace(
        num_communities=4, walk_length=20, window=3, walks_per_node=4,
        shared_negatives=64, pretrain_epochs=1, outer_iters=2, dim=32,
    )
    t = tcome.ComETrainer(g, cfg, "cpu")
    assert t.o1_table_dtype == torch.bfloat16
    hist = t.train(labels)
    assert hist[-1]["o1_loss"] < hist[0]["o1_loss"]
    assert t.params.node_emb.dtype == t.params.ctx_emb.dtype == torch.float32
    assert np.isfinite(t.embeddings()).all()
    assert hist[-1]["nmi"] > 0.5


# ------------------------------------------------------ chunked GMM and O3


def test_chunked_gmm_and_o3_match_unchunked(monkeypatch):
    rng = np.random.default_rng(6)
    N, d, K = 1000, 8, 5
    X = torch.tensor(rng.normal(size=(N, d)).astype(np.float32))
    means = torch.tensor(rng.normal(size=(2, K, d)).astype(np.float32))
    A = rng.normal(size=(2, K, d, d)) * 0.3
    chol = torch.tensor(np.linalg.cholesky(
        A @ A.transpose(0, 1, 3, 2) + np.eye(d)).astype(np.float32))
    resp = torch.softmax(torch.tensor(rng.normal(size=(2, N, K))
                                      .astype(np.float32)), -1)
    pi = resp[0]
    inv = torch.cholesky_inverse(chol[0])

    def run():
        return (tgmm._log_prob(X, means, chol),
                *tgmm._m_step(X, resp, 1e-5),
                tcom.community_grad(X, pi, means[0], inv, 0.1),
                tcom.community_loss(X, pi, means[0], chol[0], inv, 0.1))

    whole = run()
    monkeypatch.setattr(tgmm, "ROW_CHUNK", 96)
    monkeypatch.setattr(tcom, "ROW_CHUNK", 96)
    for a, b in zip(run(), whole):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- P1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_probe_plain_versions(dtype):
    g = torch.Generator().manual_seed(0)
    V, d, N = 5000, 128, 2048
    table = torch.randn((V, d), generator=g).to(dtype)
    idx = torch.randperm(V, generator=g)[:N]
    rows, checksum = row_gather_probe(table, idx)
    assert rows.dtype == dtype and torch.equal(rows, table[idx])
    assert checksum.dtype == torch.float64
    assert float(checksum) == pytest.approx(
        float(table[idx, 0].double().sum()), rel=1e-12)
    upd = torch.randn((N, d), generator=g).to(dtype)
    out = row_scatter_probe(table.clone(), idx, upd)
    want = table.clone()
    want[idx] = (table[idx].float() + upd.float()).to(dtype)
    assert torch.equal(out, want)
