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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.evaluation import oracle
from come_tpu.ops.pallas_star_sgns import fused_star_sgns_step
from come_tpu.ops.pallas_walk_sgns import fused_walk_sgns_step
from come_tpu_torch.ops.star_sgns import star_sgns_step
from come_tpu_torch.ops.walk_sgns import NWL, pad_walks, walk_sgns_step
from come_tpu_torch.sampling.stars import PAD_META, build_star_layout

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 3e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _tables(rng, V, d=128):
    emb_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    emb_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    return emb_in, emb_out


@pytest.mark.parametrize(
    "V,L,W,KP,R",
    [(60, 20, 2, 16, 1), (120, 24, 3, 8, 1), (200, 20, 3, 16, 2),
     (90, 24, 2, 8, 2)],
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


@pytest.mark.parametrize("R", [1, 2])
def test_walk_plain_reduced_window_matches_oracle(R):
    """Reduced windows (the TPU draws them in-kernel; the interpreter can
    only train the full window) against the numpy oracle, same draws."""
    rng = np.random.default_rng(7 + R)
    V, L, W, KP = 150, 20, 3, 16
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
