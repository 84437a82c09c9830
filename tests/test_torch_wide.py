"""The port past d = 128 on the CPU: the plain walk, paired and star steps
at d 256 and 300 against the JAX Pallas kernels in interpret mode, in f32
and in the bf16 modes (K1b, K5 with bf16 products, K2b), K4's step in both
on the walks its generator draws, the EM at d 160 and 256 against the JAX
package's, and the rule by which the card's wrappers, and a trainer
through its tiers' kernels, take a width.

The JAX package trains any ``dim`` (its walk kernel never checks d,
``come_tpu/ops/pallas_walk_sgns.py:490-533``; its micro-batched and star
kernels take d from the table's shape; its GMM factors with XLA's
Cholesky).  On the card, past 192 every walk and star pass stages its rows
in column slabs of 128 (``csrc/sgns_common.cuh``: SLAB), the negative
passes hold rows whole up to 256 and take slabs of 256 past it
(``NEG_WHOLE``; ``WIDE`` holds both edges, 256 and 257, and 257 and 300
take the passes' ragged and 16-byte routes), K6/K7's positive pass loops
over a lane's columns past 256 and G1 holds its matrices in device memory
past 128; ``chip_smoke.py`` (phases 4j, 4k, 5c,
15, 15b and 21) and ``tests/test_torch_cuda.py`` hold those kernels
against the plain versions tested here.  No mode raises on width; bf16
tables keep their even-width rule (``ops/walk_sgns.py::
check_cuda_inputs``).

Tolerance: the kernel tests' (``tests/test_torch_kernels.py``: rtol 1e-3,
atol 3e-5 on the tables, rtol 1e-4 on the loss, exact pair counts; the
bf16 modes under ``ops/tolerance.py``'s check, with the f32 step at least
5x farther); the EM: equal hard assignments and the mean log-likelihood
within 1e-5 relative (f32 sums over d terms a point, in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.evaluation import oracle
from come_tpu.losses import gmm as jgmm
from come_tpu.ops.pallas_star_sgns import fused_star_sgns_step
from come_tpu.ops.pallas_walk_sgns import fused_walk_sgns_step
from come_tpu_torch.graphs import sbm_graph
from come_tpu_torch.losses import gmm as tgmm
from come_tpu_torch.ops.star_sgns import star_sgns_step
from come_tpu_torch.ops.tolerance import check_bf16
from come_tpu_torch.ops.walk_sgns import (
    NWL,
    _walk_kernel,
    check_cuda_inputs,
    walk_sgns_gen_step,
    walk_sgns_step,
    walks_from_bits,
)
from come_tpu_torch.sampling.stars import PAD_META, build_star_layout

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 3e-5
WIDE = (256, 257, 300)


def _t(a):
    return torch.tensor(np.asarray(a))


def _table(rng, V, d):
    return (rng.normal(size=(V, d)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("d", WIDE)
def test_walk_plain_matches_pallas_kernel_past_192(d):
    rng = np.random.default_rng(d)
    V, L, W, KP = 100, 20, 3, 16
    emb_in, emb_out = _table(rng, V, d), _table(rng, V, d)
    walks = rng.integers(0, V, (16, L)).astype(np.int32)  # 2 groups
    pools = rng.integers(0, V, (2, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(walks),
        jnp.asarray(pools), lr, negw, seed=0, window=W, interpret=True,
        reduced_window=False, pool_refresh=1,
    )
    wrow = torch.full((2 * NWL,), W, dtype=torch.int32)  # full window
    ti, to, tl, tn = walk_sgns_step(
        _t(emb_in), _t(emb_out), _t(walks), wrow, _t(pools), lr, negw,
        window=W, pool_refresh=1,
    )
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", WIDE)
def test_paired_plain_matches_pallas_kernel_past_192(d):
    rng = np.random.default_rng(d + 1)
    V, KP = 90, 16
    emb_in, emb_out = _table(rng, V, d), _table(rng, V, d)
    u = rng.integers(0, V, 8 * 64)
    v = (u + 1 + rng.integers(0, V - 1, u.shape[0])) % V
    rows = np.stack([u, v], 1).reshape(8, 128).astype(np.int32)  # 1 group
    pools = rng.integers(0, V, (1, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(rows),
        jnp.asarray(pools), lr, negw, seed=0, window=1, interpret=True,
        reduced_window=False, pool_refresh=1, paired=True,
    )
    ti, to, tl, tn = walk_sgns_step(
        _t(emb_in), _t(emb_out), _t(rows), None, _t(pools), lr, negw,
        window=1, pool_refresh=1, paired=True,
    )
    assert float(tn) == float(jn) == rows.size
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", WIDE)
def test_star_plain_matches_pallas_kernel_and_oracle_past_192(d):
    rng = np.random.default_rng(d + 2)
    V, KP = 90, 8
    emb = _table(rng, V, d)
    slots, meta = _star_stream(rng, V, 2)  # 2 groups
    pools = rng.integers(0, V, (2, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    je, jl, jn = fused_star_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(pools), lr, negw, seed=0, interpret=True, pool_refresh=1,
    )
    oe, ol, on = oracle.star_kernel_sequential(
        emb, slots, meta, pools, negw, lr, pool_refresh=1)
    te, tl, tn = star_sgns_step(_t(emb), _t(slots), _t(meta), _t(pools), lr,
                                negw, pool_refresh=1)
    assert float(tn) == float(jn) == on
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(te.numpy(), oe, rtol=RTOL, atol=ATOL)


def _star_stream(rng, V, n_groups, E=300):
    ss, ms = [], []
    for _ in range(n_groups):
        u = rng.integers(0, V, E)
        v = rng.integers(0, V, E)
        keep = u != v
        s, m = build_star_layout(u[keep], v[keep], V)
        ss.append(np.pad(s, (0, NWL - s.shape[0])))
        ms.append(np.pad(m, (0, NWL - m.shape[0]), constant_values=PAD_META))
    return np.concatenate(ss), np.concatenate(ms)


def _bf16_close(init, got, want, f32):
    """``got`` within the bf16 check of ``want`` (writable copies of the
    JAX outputs), which the f32 updates ``f32`` fail."""
    check_bf16("bf16 mode", init, got, [np.array(w) for w in want], f32)


@pytest.mark.parametrize("d", WIDE)
def test_walk_bf16_plain_matches_pallas_kernel_past_192(d):
    """K1b: bf16 product operands, f32 sums, at d past 192."""
    rng = np.random.default_rng(d + 3)
    V, L, W, KP, R = 120, 24, 3, 16, 2
    emb_in, emb_out = _table(rng, V, d), _table(rng, V, d)
    walks = rng.integers(0, V, (16, L)).astype(np.int32)  # 2 groups
    pools = rng.integers(0, V, (1, KP)).astype(np.int32)
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
            window=W, pool_refresh=R, mxu_bf16=bf16)

    ti, to, tl, tn = port(True)
    fi, fo, _, _ = port(False)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    _bf16_close((emb_in, emb_out), (ti, to), (ji, jo), (fi, fo))


@pytest.mark.parametrize("d", WIDE)
def test_paired_bf16_plain_matches_pallas_kernel_past_192(d):
    """K5 with bf16 products past 192: only its negative pass rounds, so
    the f32 step it must stand apart from is taken with that pass off."""
    rng = np.random.default_rng(d + 4)
    V, KP = 150, 16
    emb_in, emb_out = _table(rng, V, d), _table(rng, V, d)
    u = rng.integers(0, V, 16 * 64)
    v = (u + 1 + rng.integers(0, V - 1, u.shape[0])) % V
    rows = np.stack([u, v], 1).reshape(16, 128).astype(np.int32)  # 2 groups
    pools = rng.integers(0, V, (1, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(rows),
        jnp.asarray(pools), lr, negw, seed=0, window=1, interpret=True,
        reduced_window=False, pool_refresh=2, paired=True, mxu_bf16=True,
    )

    def port(bf16, w):
        return walk_sgns_step(
            _t(emb_in), _t(emb_out), _t(rows), None, _t(pools), lr, w,
            window=1, pool_refresh=2, paired=True, mxu_bf16=bf16)

    ti, to, tl, tn = port(True, negw)
    fi, fo, _, _ = port(False, negw)
    assert float(tn) == float(jn) == rows.size
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    _bf16_close((emb_in, emb_out), (ti, to), (ji, jo), (fi, fo))
    a, b = port(True, 0.0), port(False, 0.0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("d", WIDE)
def test_star_bf16_plain_matches_pallas_kernel_past_192(d):
    """K2b past 192."""
    rng = np.random.default_rng(d + 5)
    V, KP, R = 120, 8, 2
    emb = _table(rng, V, d)
    slots, meta = _star_stream(rng, V, 3, 280)
    pools = rng.integers(0, V, (2, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    je, jl, jn = fused_star_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(pools), lr, negw, seed=0, interpret=True, pool_refresh=R,
        mxu_bf16=True,
    )

    def port(bf16):
        return star_sgns_step(_t(emb), _t(slots), _t(meta), _t(pools), lr,
                              negw, pool_refresh=R, mxu_bf16=bf16)

    te, tl, tn = port(True)
    fe, _, _ = port(False)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    _bf16_close((emb,), (te,), (je,), (fe,))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", WIDE)
def test_gen_plain_matches_pallas_kernel_on_its_walks_past_192(d, bf16):
    """K4 past 192, in f32 and with bf16 products: the port's gen step
    makes the walks ``walks_from_bits`` makes (the numpy replica's, bit for
    bit in tests/test_torch_kernels.py) and trains them as the Pallas
    kernel trains the same walks (the JAX package's own gen-mode check;
    the Pallas gen kernel itself takes ~15 s in interpret mode)."""
    g, _ = sbm_graph(160, 4, seed=d, avg_degree=8.0)
    rng = np.random.default_rng(d + 6)
    V, L, W, KP, R = 160, 20, 3, 16, 2
    emb_in, emb_out = _table(rng, V, d), _table(rng, V, d)
    starts = rng.integers(0, V, 14).astype(np.int32)  # 2 groups, wrapped
    bits = rng.integers(-2**31, 2**31, (2 * NWL,),
                        dtype=np.int64).astype(np.int32)
    pools = rng.integers(0, V, (1, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    walks = walks_from_bits(_t(starts), _t(bits), _t(g.indptr),
                            _t(g.indices), L)
    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(walks.numpy()),
        jnp.asarray(pools), lr, negw, seed=0, window=W, interpret=True,
        reduced_window=False, pool_refresh=R, mxu_bf16=bf16,
    )

    def port(b16):
        return walk_sgns_gen_step(
            _t(emb_in), _t(emb_out), _t(starts), _t(bits), _t(g.indptr),
            _t(g.indices), torch.full((2 * NWL,), W, dtype=torch.int32),
            _t(pools), lr, negw, walk_length=L, window=W, pool_refresh=R,
            mxu_bf16=b16, return_walks=True)

    ti, to, tl, tn, tw = port(bf16)
    assert torch.equal(tw, walks)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    if bf16:
        fi, fo, *_ = port(False)
        _bf16_close((emb_in, emb_out), (ti, to), (ji, jo), (fi, fo))
    else:
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("d", [160, 256])
def test_em_matches_jax_past_128(d):
    """The port's EM (G1's plain path on the CPU) against the JAX
    package's ``_em_while_loop`` from the same responsibilities, at widths
    where the card's G1 keeps its matrices in device memory."""
    rng = np.random.default_rng(d)
    K, N = 3, 6 * d
    centers = rng.normal(size=(K, d)) * 1.5
    lab = rng.integers(0, K, N)
    X = (centers[lab] + rng.normal(size=(N, d))).astype(np.float32)
    noisy = np.where(rng.random(N) < 0.3, rng.integers(0, K, N), lab)
    resp0 = np.eye(K, dtype=np.float32)[noisy]
    Xj = jnp.asarray(X)
    m, c, w = jgmm._m_step(Xj, jnp.asarray(resp0), 1e-5)
    m, c, w = jgmm._em_while_loop(
        m, c, w, lambda a, b, e: jgmm._e_step(Xj, a, b, e),
        lambda r: jgmm._m_step(Xj, r, 1e-5), 20, 1e-3)
    jr, jll = jgmm._e_step(Xj, m, c, w)
    out = tgmm.gmm_em_from_resp(torch.tensor(X), torch.tensor(resp0),
                                reg_covar=1e-5, max_iter=20, tol=1e-3,
                                graph=False)
    np.testing.assert_array_equal(out["resp"].argmax(1).numpy(),
                                  np.asarray(jr).argmax(1))
    np.testing.assert_allclose(float(out["log_likelihood"]), float(jll),
                               rtol=1e-5)
    eye = np.eye(d, dtype=np.float32)
    np.testing.assert_allclose(
        (out["inv_cov"] @ (out["chol"] @ out["chol"].transpose(1, 2))).numpy(),
        np.broadcast_to(eye, (K,) + eye.shape), atol=1e-3)


# every mode's name, as the trainer and the wrappers give it to the check
MODES = ["K1", "K5", "K2", "K1b", "K3", "K4", "K2b", "P3", "K6", "K7"]


@pytest.mark.parametrize("kernel", MODES)
@pytest.mark.parametrize("d", [1, 192, 193, 512])
def test_card_check_takes_the_f32_modes_at_any_dim(kernel, d):
    """Every mode takes any d >= 1 on the card; K3's bf16 tables any even
    d (1 and 193 become 2 and 194)."""
    dtype = torch.bfloat16 if kernel == "K3" else torch.float32
    t = torch.zeros(4, d + d % 2 if kernel == "K3" else d, dtype=dtype)
    check_cuda_inputs(t, t, kernel=kernel, table_dtypes=(dtype,))


def test_card_check_keeps_the_even_rule_of_bf16_tables():
    odd = torch.zeros(4, 129, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="even dim"):
        check_cuda_inputs(odd, odd, kernel="K3",
                          table_dtypes=(torch.bfloat16,))


def test_walk_modes_are_named_as_the_card_check_reads_them():
    assert _walk_kernel(False, False, False) == "K1"
    assert _walk_kernel(False, True, False) == "K5"
    assert _walk_kernel(True, True, False) == "K1b"  # bf16 negative pass
    assert _walk_kernel(True, False, False) == "K1b"
    assert _walk_kernel(False, False, True) == "K3"


# (config fields, the O1 and O2 tiers' kernels on the card): the trainer
# names them by the card check's names, at dim 256 as at any other
TIERS = [
    ({}, ("K1", "K2")),
    ({"o2_mode": "paired"}, ("K1", "K5")),
    ({"walk_kernel_bf16": True}, ("K1b", "K2b")),
    ({"walk_gen": "kernel"}, ("K4", "K2")),
    ({"bf16_tables": True}, ("K3", "K2")),
    ({"down_sample": 1e-3}, ("K6", "K2")),
    ({"o2_mode": "xla"}, ("K1", "K7")),
    ({"negative_mode": "per_pair"}, (None, None)),
]


@pytest.mark.parametrize("fields, kernels", TIERS)
def test_trainer_names_its_tiers_kernels_and_caps_past_192(
        fields, kernels, monkeypatch):
    from come_tpu_torch.config import ComEConfig
    from come_tpu_torch.graphs import sbm_graph
    from come_tpu_torch.trainer import come

    fields = dict(fields)
    if fields.pop("bf16_tables", False):  # any f32 table passes the line
        monkeypatch.setattr(come, "WALK_F32_TABLE_BYTES", 0)
    g, _ = sbm_graph(512, 4, seed=0, avg_degree=10)
    cfg = ComEConfig(dim=256, num_communities=4, negative_mode="shared")
    t = come.ComETrainer(g, cfg.replace(**fields), "cpu")
    assert t.tier_kernels() == kernels
