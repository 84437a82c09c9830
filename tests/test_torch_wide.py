"""The port past d = 128 on the CPU: the plain walk, paired and star steps
at d 256 and 300 against the JAX Pallas kernels in interpret mode, the EM
at d 160 and 256 against the JAX package's, and the rule by which the
card's wrappers, and a trainer through its tiers' kernels, take or refuse
a width.

The JAX package trains any ``dim`` (its walk kernel never checks d,
``come_tpu/ops/pallas_walk_sgns.py:490-533``; its GMM factors with XLA's
Cholesky).  On the card, past 192 the f32 passes of K1, K5 and K2 stage
their rows in column slabs of 128 (``csrc/sgns_common.cuh``: SLAB) and G1
holds its matrices in device memory past 128; ``chip_smoke.py`` (phase 4j,
phase 21) and ``tests/test_torch_cuda.py`` hold those kernels against the
plain versions tested here.  The bf16 modes and K6/K7 stop at 192 and
raise before any launch (``ops/walk_sgns.py::check_cuda_inputs``).

Tolerance: the kernel tests' (``tests/test_torch_kernels.py``: rtol 1e-3,
atol 3e-5 on the tables, rtol 1e-4 on the loss, exact pair counts); the EM:
equal hard assignments and the mean log-likelihood within 1e-5 relative
(f32 sums over d terms a point, in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.evaluation import oracle
from come_tpu.losses import gmm as jgmm
from come_tpu.ops.pallas_star_sgns import fused_star_sgns_step
from come_tpu.ops.pallas_walk_sgns import fused_walk_sgns_step
from come_tpu_torch.losses import gmm as tgmm
from come_tpu_torch.ops.star_sgns import star_sgns_step
from come_tpu_torch.ops.walk_sgns import (
    MAX_DIM,
    NWL,
    WIDE_ROW,
    _walk_kernel,
    check_cuda_inputs,
    walk_sgns_step,
)
from come_tpu_torch.sampling.stars import PAD_META, build_star_layout

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 3e-5
WIDE = (256, 300)


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
    ss, ms = [], []
    for _ in range(2):  # 2 groups
        u = rng.integers(0, V, 300)
        v = rng.integers(0, V, 300)
        keep = u != v
        s, m = build_star_layout(u[keep], v[keep], V)
        ss.append(np.pad(s, (0, NWL - s.shape[0])))
        ms.append(np.pad(m, (0, NWL - m.shape[0]), constant_values=PAD_META))
    slots, meta = np.concatenate(ss), np.concatenate(ms)
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


@pytest.mark.parametrize("kernel", ["K1", "K5", "K2"])
@pytest.mark.parametrize("d", [1, 192, 193, 512])
def test_card_check_takes_the_f32_modes_at_any_dim(kernel, d):
    t = torch.zeros(4, d)
    check_cuda_inputs(t, t, kernel=kernel)


@pytest.mark.parametrize("kernel", ["K1b", "K3", "K4", "K2b", "P3", "K6",
                                    "K7"])
def test_card_check_refuses_the_other_modes_past_192(kernel):
    dtype = torch.bfloat16 if kernel == "K3" else torch.float32
    check_cuda_inputs(*[torch.zeros(4, MAX_DIM, dtype=dtype)] * 2,
                      kernel=kernel, table_dtypes=(dtype,))
    wide = torch.zeros(4, MAX_DIM + 2, dtype=dtype)
    with pytest.raises(ValueError, match=f"{kernel} at dim {MAX_DIM + 2}.*"
                       f"{WIDE_ROW}"):
        check_cuda_inputs(wide, wide, kernel=kernel, table_dtypes=(dtype,))


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
# names them by the card check's names, and on the card refuses a dim past
# 192 at its construction when one of them stops there
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
    capped = [k for k in kernels if k not in (None, "K1", "K5", "K2")]
    assert come.capped_kernels(kernels, MAX_DIM + 1) == capped
    assert come.capped_kernels(kernels, MAX_DIM) == []
