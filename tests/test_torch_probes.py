"""The probes P2-P4's plain versions against the JAX package's probes.

P3 (``ops/star_probe.py``) is held against ``scripts/probe_star.py::step``
in interpret mode: the test puts ``scripts/`` on ``sys.path`` and replaces
that module's ``pl`` with a namespace whose ``pallas_call`` runs in
interpret mode without TPU compiler parameters, so nothing in the JAX code
changes.  Interpret mode fills scratch that nothing wrote with NaN, so only
the variants that read no unwritten scratch compare (full, no scatter, no
neg, gather only, empty).  The full variant is also held against
``fused_star_sgns_step(mxu_bf16=True, interpret=True)``.  Tolerance: the
bf16 check of ``ops/tolerance.py`` on the table updates (the f32 step of
the same variant at least 5x farther away), loss rtol 1e-4, exact pair
counts; tables the probe leaves alone must come back bit for bit.

P4's and P2's plain versions return the values that
``scripts/probe_star_floor.py`` and ``scripts/probe_vmem.py`` define,
computed here in numpy.  The CUDA kernels are held against these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from come_tpu.ops.pallas_star_sgns import fused_star_sgns_step
from come_tpu_torch.ops.floor_probe import VARIANTS, floor_probe
from come_tpu_torch.ops.smem_probe import smem_probe
from come_tpu_torch.ops.star_probe import star_probe_step
from come_tpu_torch.ops.tolerance import check_bf16
from come_tpu_torch.sampling.stars import build_star_layout
from come_tpu_torch.tools import probe_smem, probe_star, probe_star_floor

torch.set_num_threads(2)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
V, D, KP, R, NG = 300, 16, 16, 2, 3
LR, NEGW = 0.01, 5.0 / KP


@pytest.fixture(scope="module")
def jax_probe():
    """scripts/probe_star.py with its pallas_call in interpret mode."""
    sys.path.insert(0, str(SCRIPTS))
    try:
        import probe_star as mod
    finally:
        sys.path.remove(str(SCRIPTS))

    def interpret_call(*args, **kw):
        kw.pop("compiler_params", None)
        kw["interpret"] = True
        return pl.pallas_call(*args, **kw)

    real = mod.pl
    mod.pl = types.SimpleNamespace(
        **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    mod.pl.pallas_call = interpret_call
    yield mod
    mod.pl = real


@pytest.fixture(scope="module")
def stream():
    """NG whole groups of a star layout over random edges, a table and one
    pool, from a seed (probe_star.py:238-248 at a small size)."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, V, 3000)
    v = (u + 1 + rng.integers(0, V - 1, 3000)) % V
    slots, meta = build_star_layout(u, v, V)
    assert slots.shape[0] >= NG * 1024
    slots = slots[:NG * 1024].astype(np.int32)
    meta = meta[:NG * 1024].astype(np.int32)
    emb = rng.normal(size=(V, D)).astype(np.float32) * 0.1
    sneg = rng.integers(0, V, KP).astype(np.int32)
    return emb, slots, meta, sneg


def _port(emb, slots, meta, sneg, **kw):
    return star_probe_step(torch.tensor(emb), torch.tensor(slots),
                           torch.tensor(meta), torch.tensor(sneg), LR, NEGW,
                           pool_refresh=R, **kw)


@pytest.mark.parametrize("off", [
    {}, dict(scatter=False), dict(neg=False),
    dict(math=False, scatter=False, pool=False),
    dict(math=False, gather=False, scatter=False, pool=False),
], ids=["full", "no_scatter", "no_neg", "gather_only", "empty"])
def test_star_probe_plain_matches_jax_probe(jax_probe, stream, off):
    emb, slots, meta, sneg = stream
    je, st = jax_probe.step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(sneg), LR, NEGW, pool_refresh=R, unroll=8, **off)
    je, st = np.array(je), np.asarray(st)
    te, tl, tn = _port(*stream, **off)
    assert float(tn) == float(st[0, 1])
    np.testing.assert_allclose(float(tl), float(st[0, 0]), rtol=1e-4)
    if not off.get("math", True):
        # nothing trains: the table comes back as it was, and stats are 0
        assert np.array_equal(je, emb) and torch.equal(te, torch.tensor(emb))
        assert float(tl) == 0.0 and float(tn) == 0.0
        return
    fe, _, _ = _port(*stream, mxu_bf16=False, **off)
    check_bf16("P3", (emb,), (te,), (je,), (fe,))


def test_star_probe_full_is_the_star_kernel(stream):
    """All sections on: the JAX star kernel in its bf16 mode."""
    emb, slots, meta, sneg = stream
    je, jl, jn = fused_star_sgns_step(
        jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(meta),
        jnp.asarray(sneg), LR, NEGW, 0, pool_refresh=R, mxu_bf16=True,
        interpret=True)
    te, tl, tn = _port(*stream)
    fe, _, _ = _port(*stream, mxu_bf16=False)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    check_bf16("P3 full", (emb,), (te,), (np.array(je),), (fe,))


def test_star_probe_unroll_does_not_change_the_step(stream):
    a = _port(*stream, unroll=8)
    b = _port(*stream, unroll=128)
    assert torch.equal(a[0], b[0]) and float(a[1]) == float(b[1])


def test_floor_probe_plain_values():
    """The seven values of probe_star_floor.py's kernels, from its inputs."""
    slots, pool, scal, meta, emb = probe_star_floor.inputs("cpu")
    G = probe_star_floor.G
    s, e = slots.numpy(), emb.numpy()
    m = meta.numpy()
    sneg0 = pool.numpy()[0]
    s0 = int(s[(G - 1) * 1024])
    want = {
        "bare": 1.0,
        "slots": float(s0),
        "slots_tile": float(s0),
        "smem_streams": float(s0 + sneg0),
        "meta": float(s0 + m[(G - 1) * 8, 0]),
        "table": float(s0),
        "gather": float(e[s0, 0]),
    }
    assert set(want) == set(VARIANTS)
    for name, value in want.items():
        got, table = floor_probe(name, slots, pool, scal, meta, emb)
        assert float(got) == np.float32(value), name
        if name in ("table", "gather"):
            assert torch.equal(table, emb)
        else:
            assert table is None


def test_smem_probe_plain_sums_row_zero():
    x = torch.ones((8, 128))
    assert float(smem_probe(x, 232448)) == 128.0
    with pytest.raises(RuntimeError, match="nothing to probe"):
        probe_smem.capacity_search("cpu")


def test_probe_tools_need_a_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        probe_star.run("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        probe_star_floor.run("cpu")


def test_probe_wrappers_reject_other_devices():
    emb = torch.zeros((8, 128), device="meta")
    i = torch.zeros(1024, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no star probe kernel"):
        star_probe_step(emb, i, i, i[:16], 0.1, 0.1)
    with pytest.raises(ValueError, match="no floor probe kernel"):
        floor_probe("bare", i, i, None, None, emb)
    with pytest.raises(ValueError, match="no smem probe kernel"):
        smem_probe(emb, 1024)
