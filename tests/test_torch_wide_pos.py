"""The band and star passes past d = 192 on the CPU: the plain steps at the
shapes where the card's route changes, against the JAX Pallas kernels in
interpret mode.

Past d 192 the card's band pass holds a strip's whole rows in shared
memory (``walk_pos_wide_kernel``) where they fit, bf16 rows where the band
rounds them, and takes column slabs of 128 (``walk_pos_slab_kernel``)
where they do not; the star pass does the same for a whole 128-slot row
(``star_pos_wide_kernel``, ``star_pos_slab_kernel``).  The rule is the
kernel library's (``csrc/walk_sgns.cu``, ``csrc/star_pos.cuh``), and
``chip_smoke.py`` fails a card step whose recording launched another route
than the one its phase names.  Here the plain steps are held against the
TPU kernel at the shapes the card's route checks use: W 10 at d 256, the
last window whose f32 rows fit at d 256 on walks of 128 (47) and the first
that does not (48), K3's bf16 tables at d 258 with the whole walk in the
window (bf16 rows held whole), K1b with the whole walk at d 512 (bf16 rows
in slabs), and star rows whose owned range is a whole row (a fat hub) at
d 256 and, for K2b, at 884 (bf16 rows in slabs).  ``tests/
test_torch_cuda.py`` holds the card's kernels against the same plain
steps.

Tolerance: the kernel tests' (``tests/test_torch_kernels.py``: rtol 1e-3,
atol 3e-5 on the tables, rtol 1e-4 on the loss, exact pair counts; the
bf16 modes under ``ops/tolerance.py``'s check, with the f32 step at least
5x farther; K3 in truncation mode >= 99% of elements bit-identical and
none more than one bf16 ulp off, as ``tests/test_torch_large_v.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.ops.pallas_star_sgns import fused_star_sgns_step
from come_tpu.ops.pallas_walk_sgns import fused_walk_sgns_step
from come_tpu_torch.ops.star_sgns import star_sgns_step
from come_tpu_torch.ops.tolerance import check_bf16
from come_tpu_torch.ops.walk_sgns import NWL, walk_sgns_step
from come_tpu_torch.sampling import build_star_layout

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 3e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _table(rng, V, d):
    return (rng.normal(size=(V, d)) * 0.1).astype(np.float32)


# (L, W, mxu_bf16): W 10 on walks of 80 in f32 and with bf16 products, and
# the f32 route boundary at d 256 on walks of 128
WALK_CASES = [(80, 10, False), (80, 10, True), (128, 47, False),
              (128, 48, False)]


@pytest.mark.parametrize("L,W,bf16", WALK_CASES)
def test_walk_plain_matches_pallas_at_the_band_routes_at_256(L, W, bf16):
    _walk_case(256, L, W, bf16)


def test_walk_plain_matches_pallas_with_bf16_rows_in_slabs_at_512():
    """K1b with the whole walk of 128 in the window at d 512: the card's
    bf16 band rows take column slabs there."""
    _walk_case(512, 128, 127, True)


def _walk_case(d, L, W, bf16):
    rng = np.random.default_rng(L + W)
    V, KP = 120, 16
    emb_in, emb_out = _table(rng, V, d), _table(rng, V, d)
    walks = rng.integers(0, V, (8, L)).astype(np.int32)  # 1 group
    pools = rng.integers(0, V, (1, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(emb_in), jnp.asarray(emb_out), jnp.asarray(walks),
        jnp.asarray(pools), lr, negw, seed=0, window=W, interpret=True,
        reduced_window=False, pool_refresh=1, mxu_bf16=bf16,
    )
    wrow = torch.full((NWL,), W, dtype=torch.int32)  # full window

    def port(b16):
        return walk_sgns_step(
            _t(emb_in), _t(emb_out), _t(walks), wrow, _t(pools), lr, negw,
            window=W, pool_refresh=1, mxu_bf16=b16)

    ti, to, tl, tn = port(bf16)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    if bf16:
        fi, fo, _, _ = port(False)
        check_bf16(f"K1b d {d}", (emb_in, emb_out), (ti, to),
                   [np.array(ji), np.array(jo)], (fi, fo))
    else:
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=ATOL)


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x.view(jnp.int16)).astype(np.int32)


def test_k3_plain_matches_pallas_with_the_whole_walk_at_258():
    """K3 (bf16 tables, truncation) at d 258, whose rows take 4-byte
    copies on the card, with the whole walk of 128 in the window: the
    card's bf16 rows fit whole there."""
    d, L, W = 258, 128, 127
    rng = np.random.default_rng(d)
    V, KP = 60, 16
    ei = torch.tensor(_table(rng, V, d)).to(torch.bfloat16)
    eo = torch.tensor(_table(rng, V, d)).to(torch.bfloat16)
    walks = rng.integers(0, V, (8, L)).astype(np.int32)
    pools = rng.integers(0, V, (1, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    ji, jo, jl, jn = fused_walk_sgns_step(
        jnp.asarray(ei.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(eo.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(walks), jnp.asarray(pools), lr, negw, seed=0, window=W,
        interpret=True, reduced_window=False, pool_refresh=1,
    )
    ti, to, tl, tn = walk_sgns_step(
        ei.clone(), eo.clone(), torch.tensor(walks),
        torch.full((NWL,), W, dtype=torch.int32), torch.tensor(pools), lr,
        negw, window=W, pool_refresh=1)
    assert ti.dtype == to.dtype == torch.bfloat16
    assert float(tn) == float(jn)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for a, b in ((ti, ji), (to, jo)):
        diff = np.abs(_bf16_bits(a) - _bf16_bits(b))
        assert (diff == 0).mean() >= 0.99
        assert diff.max() <= 1


def _fat_row(V=400):
    """One star group whose first row is one hub and 127 leaves (its strip
    0 owns the whole row), then a row of the rest of the hub's fan-out."""
    slots, meta = build_star_layout(np.zeros(150, np.int64),
                                    np.arange(1, 151), V, max_fanout=127)
    n = -(-slots.size // NWL) * NWL
    return (np.pad(slots, (0, n - slots.size)).astype(np.int32),
            np.pad(meta, (0, n - meta.size),
                   constant_values=-2).astype(np.int32))


@pytest.mark.parametrize("bf16", [False, True])
def test_star_plain_matches_pallas_on_a_whole_row_range_at_256(bf16):
    _star_case(256, bf16)


def test_k2b_plain_matches_pallas_with_bf16_rows_in_slabs_at_884():
    """K2b on the fat hub's row at d 884: the card's bf16 star rows take
    column slabs past d 880."""
    _star_case(884, True)


def _star_case(d, bf16):
    rng = np.random.default_rng(d + bf16)
    V, KP = 400, 16
    emb = _table(rng, V, d)
    slots, meta = _fat_row(V)
    assert (meta[:128] >= 0).all() and (meta[0] & 1) == 1
    assert ((meta[1:128] & 1) == 0).all()  # one segment fills row 0
    pools = rng.integers(0, V, (1, KP)).astype(np.int32)
    lr, negw = 0.05, 5.0 / KP
    je, jl, jn = fused_star_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(pools), lr, negw, seed=0, interpret=True, pool_refresh=1,
        mxu_bf16=bf16,
    )

    def port(b16):
        return star_sgns_step(_t(emb), _t(slots), _t(meta), _t(pools), lr,
                              negw, pool_refresh=1, mxu_bf16=b16)

    te, tl, tn = port(bf16)
    assert float(tn) == float(jn) == 300
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    if bf16:
        fe, _, _ = port(False)
        check_bf16(f"K2b d {d}", (emb,), (te,), [np.array(je)], (fe,))
    else:
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=RTOL,
                                   atol=ATOL)
