"""The port's data-parallel layer (``come_tpu_torch/parallel/``) against
the JAX package's ``parallel/``: the batch placement against
``jax.device_put``'s shards on the 8-device CPU mesh, the update rules of
``collectives.py`` at world 2, and one data-parallel step of K1, K2, K5
and K6 at world 2 through the trainer's step methods against the JAX
kernels in interpret mode run per shard on the same inputs, their deltas
summed as ``come_tpu/parallel/sharded.py:805-806`` does.

Ranks are gloo processes started by ``tests/_torch_dp.py::spawn`` (one
thread each, a ``file://`` rendezvous in the test's directory); they
import no jax.  Tolerance of the kernel steps: rtol 1e-3, atol 3e-5 on
the tables, rtol 1e-4 on each rank's loss, exact pair counts
(``tests/test_torch_kernels.py``'s); the f32 and tied rules must give the
numpy sum within one f32 rounding of each addend (rtol 1e-6), the bf16
rule the value rounded once, bit for bit, on both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_dp import collectives, kernel_steps, spawn
from _torch_rs import mesh_groups
from come_tpu.ops.pallas_sgns import fused_sgns_step as j_fused_sgns_step
from come_tpu.ops.pallas_star_sgns import fused_star_sgns_step
from come_tpu.ops.pallas_walk_sgns import fused_walk_sgns_step
from come_tpu.parallel import make_mesh as j_make_mesh
from come_tpu_torch.ops.walk_sgns import NWL
from come_tpu_torch.parallel import Mesh, MeshLayout, make_mesh
from come_tpu_torch.sampling.stars import PAD_META, build_star_layout

RTOL, ATOL = 1e-3, 3e-5
WORLD = 2


def test_make_mesh_shapes(tmp_path):
    """The one-process mesh; and at world 4, ``make_mesh(2, 2)``: rank r is
    (r // 2, r % 2), as ``np.asarray(devices).reshape(data, model)``
    orders the JAX mesh, with data groups {0, 2}, {1, 3} and model groups
    {0, 1}, {2, 3}; each rank's batch block by its data index and its row
    block by its model index."""
    m = make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.rank == 0
    with pytest.raises(ValueError):
        make_mesh(data=2)  # one process, no group
    with pytest.raises(ValueError):
        make_mesh(data=2, model=2)
    lay = MeshLayout(Mesh(data=4, rank=1))
    assert (lay.data_size, lay.model_size, lay.rank) == (4, 1, 1)
    assert lay.rows_per_shard(10) == 10
    with pytest.raises(ValueError):
        lay.local(torch.zeros(2, 6), 1)
    with pytest.raises(ValueError):
        MeshLayout(Mesh(data=1, model=4)).rows_per_shard(10)
    jm = j_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    for r, got in enumerate(spawn(mesh_groups, 4, tmp_path, 2, 2)):
        di, mi = divmod(r, 2)
        assert jm.devices[di, mi] == jax.devices()[r]
        assert got["shape"] == {"data": 2, "model": 2}
        assert got["index"] == (di, mi) and got["rank"] == r
        assert (got["data_size"], got["model_size"]) == (2, 2)
        assert (got["data_rank"], got["model_rank"]) == (di, mi)
        assert got["data_sum"] == 2.0
        assert got["model_sum"] == float(2 * di * 2 + 1)  # r0 + r1
        assert got["row_block"] == (mi * 12, (mi + 1) * 12)
        np.testing.assert_array_equal(got["local"],
                                      [[4 * di, 4 * di + 1, 4 * di + 2,
                                        4 * di + 3]])


@pytest.mark.parametrize("D", [2, 4, 8])
def test_batch_placement_matches_jax_device_put(D):
    """Rank r keeps column block r: the shard ``jax.device_put`` places on
    the r-th device of the data axis, for [S, B] starts (``P(None,
    'data')``) and [S, B, 128] edge rows (``P(None, 'data', None)``)."""
    mesh = j_make_mesh(data=D, model=1, devices=jax.devices()[:D])
    rng = np.random.default_rng(D)
    for x, spec in [(rng.integers(0, 99, (3, 8 * D)), P(None, "data")),
                    (rng.integers(0, 99, (2, 2 * D, 128)),
                     P(None, "data", None))]:
        arr = jax.device_put(jnp.asarray(x, jnp.int32),
                             NamedSharding(mesh, spec))
        by_dev = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for r in range(D):
            got = MeshLayout(Mesh(data=D, rank=r)).local(torch.as_tensor(x))
            np.testing.assert_array_equal(
                got.numpy(), by_dev[mesh.devices[r, 0]])


# ------------------------------------------------------------ the rules


@pytest.fixture(scope="module")
def rules(tmp_path_factory):
    rng = np.random.default_rng(0)
    before = rng.normal(size=(40, 16)).astype(np.float32)
    after = np.stack([before + rng.normal(size=before.shape).astype(
        np.float32) * 1e-2 for _ in range(WORLD)])
    out = np.stack([before + rng.normal(size=before.shape).astype(
        np.float32) * 1e-2 for _ in range(WORLD)])
    data = {"before": before, "after": after, "out": out}
    return data, spawn(collectives, WORLD, tmp_path_factory.mktemp("rules"),
                       data)


def test_f32_delta_rule(rules):
    data, res = rules
    b = data["before"]
    want = b + (data["after"] - b).sum(0)
    for r in res:
        np.testing.assert_allclose(r["f32"], want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            r["ctx"], 0.5 * b + (0.5 * data["after"] - 0.5 * b).sum(0),
            rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(r["f32"], res[0]["f32"])
        assert r["calls"] == 1  # both tables in one all-reduce


def test_bf16_delta_rule_rounds_once(rules):
    """bf16 working tables (K3): deltas summed in f32, then one rounding
    to nearest even onto ``before``; the replicas are bit-identical."""
    data, res = rules
    b16 = torch.as_tensor(data["before"]).to(torch.bfloat16).float()
    a16 = torch.as_tensor(data["after"]).to(torch.bfloat16).float()
    want = (b16 + (a16 - b16).sum(0)).to(torch.bfloat16).float().numpy()
    for r in res:
        np.testing.assert_array_equal(r["bf16"], want)
    # the rounding happened once: the f32 sum is not a bf16 value
    assert not np.array_equal((b16 + (a16 - b16).sum(0)).numpy(), want)


def test_tied_delta_rule(rules):
    data, res = rules
    b = data["before"]
    want = b + (data["after"] + data["out"] - 2.0 * b).sum(0)
    for r in res:
        np.testing.assert_allclose(r["tied"], want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(r["tied"], res[0]["tied"])


# ------------------------------------------------- one dp step a kernel

V, L, W, KP = 120, 20, 3, 16
CFG = dict(num_communities=4, dim=128, walk_length=L, window=W,
           shared_negatives=KP, walk_pool_refresh=1, lr=0.05, min_lr=0.05,
           alpha=0.5, batch_pairs=128, pallas_tile_pairs=64)


def _star_group(rng):
    u = rng.integers(0, V, 290)
    v = rng.integers(0, V, 290)
    keep = u != v
    s, m = build_star_layout(u[keep], v[keep], V)
    assert s.shape[0] <= NWL
    return (np.pad(s, (0, NWL - s.shape[0])).astype(np.int32),
            np.pad(m, (0, NWL - m.shape[0]),
                   constant_values=PAD_META).astype(np.int32))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    rng = np.random.default_rng(11)
    d = CFG["dim"]
    ne = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    ce = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    inputs = {k: [] for k in ("walks", "wrow", "pools", "slots", "meta",
                              "star_pools", "rows", "paired_pools", "c",
                              "x", "m", "k6_pools")}
    for _ in range(WORLD):
        inputs["walks"].append(rng.integers(0, V, (16, L)).astype(np.int32))
        inputs["wrow"].append(np.full(2 * NWL, W, np.int32))
        inputs["pools"].append(rng.integers(0, V, (2, KP)).astype(np.int32))
        s, m = _star_group(rng)
        inputs["slots"].append(s)
        inputs["meta"].append(m)
        inputs["star_pools"].append(
            rng.integers(0, V, (1, KP)).astype(np.int32))
        inputs["rows"].append(rng.integers(0, V, (8, 128)).astype(np.int32))
        inputs["paired_pools"].append(
            rng.integers(0, V, (1, KP)).astype(np.int32))
        inputs["c"].append(rng.integers(0, V, 128).astype(np.int32))
        inputs["x"].append(rng.integers(0, V, 128).astype(np.int32))
        inputs["m"].append((rng.random(128) < 0.8).astype(np.float32))
        inputs["k6_pools"].append(rng.integers(0, V, (2, KP)).astype(np.int32))
    data = {"V": V, "cfg": CFG, "ne": ne, "ce": ce,
            "inputs": {k: np.stack(v) for k, v in inputs.items()}}
    res = spawn(kernel_steps, WORLD, tmp_path_factory.mktemp("steps"), data)
    return data, res


def _sum(before, outs):
    """before + the sum of every shard's delta, in f32."""
    return before + sum(np.asarray(o) - before for o in outs)


def test_dp_k1_step_matches_jax_per_shard(steps):
    data, res = steps
    ne, ce, inp = data["ne"], data["ce"], data["inputs"]
    lr, negw = res[0]["lr"], res[0]["negw"]
    outs = [fused_walk_sgns_step(
        jnp.asarray(ne), jnp.asarray(ce), jnp.asarray(inp["walks"][r]),
        jnp.asarray(inp["pools"][r]), lr, negw, seed=0, window=W,
        interpret=True, reduced_window=False, pool_refresh=1)
        for r in range(WORLD)]
    want_ne = _sum(ne, [o[0] for o in outs])
    want_ce = _sum(ce, [o[1] for o in outs])
    for r, got in enumerate(res):
        tn, tc, loss, n = got["k1"]
        assert n == float(outs[r][3])
        np.testing.assert_allclose(loss, float(outs[r][2]), rtol=1e-4)
        np.testing.assert_allclose(tn, want_ne, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tc, want_ce, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(tn, res[0]["k1"][0])


def test_dp_k2_step_matches_jax_per_shard(steps):
    data, res = steps
    ne, inp = data["ne"], data["inputs"]
    lr = res[0]["lr"] * CFG["alpha"]
    outs = [fused_star_sgns_step(
        jnp.asarray(ne), jnp.asarray(inp["slots"][r]),
        jnp.asarray(inp["meta"][r]), jnp.asarray(inp["star_pools"][r]), lr,
        res[0]["negw"], seed=0, interpret=True, pool_refresh=1)
        for r in range(WORLD)]
    want = _sum(ne, [o[0] for o in outs])
    for r, got in enumerate(res):
        te, loss, n = got["k2"]
        assert n == float(outs[r][2])
        np.testing.assert_allclose(loss, float(outs[r][1]), rtol=1e-4)
        np.testing.assert_allclose(te, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(te, res[0]["k2"][0])


def test_dp_k5_step_matches_jax_per_shard(steps):
    """The paired step's tied rule: ``ne0 + psum(new_in + new_out - 2 *
    ne0)`` (``come_tpu/parallel/sharded.py:1154``)."""
    data, res = steps
    ne, inp = data["ne"], data["inputs"]
    lr = res[0]["lr"] * CFG["alpha"]
    want = ne.copy()
    outs = []
    for r in range(WORLD):
        ni, no, jl, jn = fused_walk_sgns_step(
            jnp.asarray(ne), jnp.asarray(ne), jnp.asarray(inp["rows"][r]),
            jnp.asarray(inp["paired_pools"][r]), lr, res[0]["negw"], 0,
            window=1, interpret=True, reduced_window=False,
            pool_refresh=1, paired=True)
        want = want + (np.asarray(ni) + np.asarray(no) - 2.0 * ne)
        outs.append((float(jl), float(jn)))
    for r, got in enumerate(res):
        te, loss, n = got["k5"]
        assert n == outs[r][1] == 8 * 128
        np.testing.assert_allclose(loss, outs[r][0], rtol=1e-4)
        np.testing.assert_allclose(te, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(te, res[0]["k5"][0])


def test_dp_k6_microsteps_match_jax_per_shard(steps):
    """The micro-batched tier: ``batch_pairs // D`` = 64 pairs a rank a
    micro-step, the deltas summed after each of the two micro-steps
    (``_sgns_microbatched_sharded``, ``:156-235``)."""
    data, res = steps
    inp = data["inputs"]
    ne, ce = data["ne"], data["ce"]
    mb = CFG["batch_pairs"] // WORLD
    for i in range(2):
        s = slice(i * mb, (i + 1) * mb)
        outs = [j_fused_sgns_step(
            jnp.asarray(ne), jnp.asarray(ce), jnp.asarray(inp["c"][r][s]),
            jnp.asarray(inp["x"][r][s]), jnp.asarray(inp["k6_pools"][r][i]),
            jnp.asarray(inp["m"][r][s]), res[0]["lr"], res[0]["negw"],
            tile_pairs=64, interpret=True) for r in range(WORLD)]
        ne = _sum(ne, [o[0] for o in outs])
        ce = _sum(ce, [o[1] for o in outs])
    for r, got in enumerate(res):
        tn, tc, _, n = got["k6"]
        assert n == float(inp["m"][r].sum())
        np.testing.assert_allclose(tn, ne, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tc, ce, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(tn, res[0]["k6"][0])
