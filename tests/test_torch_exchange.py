"""The port's row exchange (``come_tpu_torch/parallel/exchange.py``,
``walk_exchange.py``) against the JAX package's, on the 8-device CPU mesh
under ``shard_map`` on the JAX side and gloo ranks on the port's
(``tests/_torch_rs.py``):

* at meshes (2, 4) and (2, 2), on the inputs of
  ``tests/test_exchange.py:15-110`` (24 ids of 32 rows, exact capacity;
  16 ids all on shard 0 at capacity 2) and on ids that hold the fill id
  ``v_pad``: every plan array (``order``, ``sowner``, ``pos``, ``ok``,
  ``served``, ``got``), the gathered rows and the scattered delta EQUAL to
  JAX's, per worker; the batched planner and ``plan_walk_macro_steps``
  (compact walks and pools, served fractions) likewise;
* ``interleave_permutation`` and ``CSRGraph.permute`` equal to JAX's;
* at (2, 2), one ``fused_walk_step_rowsharded`` step of K1, K1b and the
  paired K5 against JAX's (Pallas in interpret mode, full windows), and
  three O1 steps through the one-step row prefetch against JAX's
  ``prefetch_scan(overlap=True)``: tables within rtol 1e-3 and atol 3e-5,
  loss within 1e-4 relative, pair counts exact, served 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _torch_dp import spawn
from _torch_rs import exchange, steps
from come_tpu.graphs import sbm_graph as j_sbm_graph
from come_tpu.parallel import make_mesh as j_make_mesh
from come_tpu.parallel import walk_exchange as jwe
from come_tpu.parallel.exchange import (
    interleave_permutation as j_interleave,
    make_exchange_plan as j_plan,
    make_exchange_plans_batched as j_plans,
)
from come_tpu_torch.graphs import sbm_graph
from come_tpu_torch.parallel.exchange import interleave_permutation

RTOL, ATOL = 1e-3, 3e-5
FIELDS = ("order", "sowner", "pos", "ok", "served", "got")


def _jmesh(D, M):
    return j_make_mesh(data=D, model=M, devices=jax.devices()[:D * M])


def _cases(D, M):
    rng = np.random.default_rng(D * 10 + M)
    V, d = 32, 8
    table = rng.normal(size=(V, d)).astype(np.float32)
    exact = rng.integers(0, V, (D, M, 24)).astype(np.int32)
    over = rng.integers(0, V // 4, (D, M, 16)).astype(np.int32)
    fill = rng.integers(0, V, (D, M, 24)).astype(np.int32)
    fill[..., -5:] = V  # the planner's fill id: no owner
    cases = []
    for idx, C in ((exact, 24), (over, 2), (fill, 7)):
        upd = rng.normal(size=idx.shape + (d,)).astype(np.float32)
        cases.append({"idx": idx, "table": table, "upd": upd, "C": C})
    batched = rng.integers(0, V, (D, M, 3, 20)).astype(np.int32)
    cases.append({"idx": batched, "table": table, "C": 6})
    walks = rng.integers(0, V, (D, M, 2, 4, 6)).astype(np.int32)
    sneg = rng.integers(0, V, (D, M, 2, 1, 5)).astype(np.int32)
    cases.append({"walks": walks, "sneg": sneg, "table": table,
                  "slack": 1.0})
    return cases


def _jax_case(D, M, c):
    """The JAX package's arrays for case ``c``, [D, M, ...] each."""
    mesh = _jmesh(D, M)
    V = c["table"].shape[0]
    rp = V // M
    spec = P("data", "model")

    def lead(x):
        return x[None, None]

    if "walks" in c:
        def body(w, s):
            plans, rw, rn, served = jwe.plan_walk_macro_steps(
                w[0, 0], s[0, 0], rp, c["slack"])
            return ({k: lead(getattr(plans, k)) for k in FIELDS},
                    lead(rw), lead(rn), lead(served))
        args = (c["walks"], c["sneg"])
        names = ("plan", "rwalks", "rneg", "served")
    elif c["idx"].ndim == 4:
        def body(ix):
            plan = j_plans(ix[0, 0], rp, c["C"])
            return ({k: lead(getattr(plan, k)) for k in FIELDS},)
        args = (c["idx"],)
        names = ("plan",)
    else:
        def body(tab, ix, up):
            plan = j_plan(ix[0, 0], rp, c["C"])
            rows = plan.gather(tab)
            delta = plan.scatter_add(jnp.zeros_like(tab), up[0, 0])
            return ({k: lead(getattr(plan, k)) for k in FIELDS},
                    lead(rows), lead(delta))
        args = (c["table"], c["idx"], c["upd"])
        names = ("plan", "rows", "delta")
    in_specs = tuple(P("model", None) if a is c.get("table") else spec
                     for a in args)
    out = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=spec,
        check_vma=False))(*(jnp.asarray(a) for a in args))
    return dict(zip(names, jax.tree.map(np.asarray, out)))


@pytest.fixture(scope="module", params=[(2, 4), (2, 2)], ids=str)
def plans(request, tmp_path_factory):
    D, M = request.param
    cases = _cases(D, M)
    res = spawn(exchange, D * M, tmp_path_factory.mktemp("exchange"), D, M,
                cases)
    return D, M, cases, res


@pytest.mark.parametrize("case", ["exact", "overflow", "fill"])
def test_plan_gather_scatter_equal_jax(plans, case):
    D, M, cases, res = plans
    i = ["exact", "overflow", "fill"].index(case)
    want = _jax_case(D, M, cases[i])
    for r, got in enumerate(res):
        di, mi = divmod(r, M)
        g = got[i]
        for k in FIELDS:
            np.testing.assert_array_equal(g["plan"][k],
                                          want["plan"][k][di, mi], k)
        np.testing.assert_array_equal(g["rows"], want["rows"][di, mi])
        np.testing.assert_array_equal(g["delta"], want["delta"][di, mi])
    if case == "overflow":  # exactly capacity ids served per worker
        assert sum(g[i]["plan"]["served"].sum() for g in res) == D * M * 2


def test_batched_plans_equal_jax(plans):
    D, M, cases, res = plans
    want = _jax_case(D, M, cases[3])
    for r, got in enumerate(res):
        for k in FIELDS:
            np.testing.assert_array_equal(got[3]["plan"][k],
                                          want["plan"][k][divmod(r, M)], k)


def test_plan_walk_macro_steps_equal_jax(plans):
    D, M, cases, res = plans
    want = _jax_case(D, M, cases[4])
    for r, got in enumerate(res):
        w = {k: v[divmod(r, M)] for k, v in want.items() if k != "plan"}
        for k in ("rwalks", "rneg"):
            np.testing.assert_array_equal(got[4][k], w[k], k)
        np.testing.assert_allclose(got[4]["served"], w["served"], rtol=1e-7)
        for k in FIELDS:
            np.testing.assert_array_equal(
                got[4]["plan"][k], want["plan"][k][divmod(r, M)], k)


@pytest.mark.parametrize("n,m", [(10, 4), (34, 2), (513, 3), (7, 8)])
def test_interleave_permutation_equals_jax(n, m):
    got = interleave_permutation(n, m)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(j_interleave(n, m)))


def test_csr_permute_equals_jax():
    perm = interleave_permutation(48, 4)
    g, _ = sbm_graph(48, 4, p_in=0.3, p_out=0.05, seed=0)
    jg, _ = j_sbm_graph(48, 4, p_in=0.3, p_out=0.05, seed=0)
    gp, jp = g.permute(perm), jg.permute(perm)
    np.testing.assert_array_equal(gp.indptr, jp.indptr)
    np.testing.assert_array_equal(gp.indices, jp.indices)
    np.testing.assert_array_equal(gp.degrees[perm], g.degrees)


# ---------------------------------------------- steps on compact tables

V, L, W, KP, d = 120, 20, 3, 16, 128
LR, NEGW = 0.05, 5.0 / 16


@pytest.fixture(scope="module")
def rs_steps(tmp_path_factory):
    rng = np.random.default_rng(5)
    data = {"ne": (rng.normal(size=(V, d)) * 0.1).astype(np.float32),
            "ce": (rng.normal(size=(V, d)) * 0.1).astype(np.float32),
            "walks": rng.integers(0, V, (2, 2, 8, L)).astype(np.int32),
            "pools": rng.integers(0, V, (2, 2, 1, KP)).astype(np.int32),
            "rows": rng.integers(0, V, (2, 2, 8, 128)).astype(np.int32),
            "paired_pools": rng.integers(0, V, (2, 2, 1, KP)).astype(
                np.int32),
            "walks3": rng.integers(0, V, (2, 2, 3, 8, L)).astype(np.int32),
            "pools3": rng.integers(0, V, (2, 2, 3, 1, KP)).astype(np.int32),
            "W": W, "lr": LR, "negw": NEGW}
    res = spawn(steps, 4, tmp_path_factory.mktemp("steps"), 2, 2, data)
    return data, res


def _jax_steps(data, kind):
    """JAX's tables [V, d] (gathered over 'model'), and each worker's loss
    and pair count [2, 2]."""
    mesh = _jmesh(2, 2)
    rp = V // 2
    tab, spec = P("model", None), P("data", "model")

    def lead(x):
        return x[None, None]

    if kind in ("k1", "k1b"):
        def body(ne, ce, w, s):
            ne, ce, loss, n, srv = jwe.fused_walk_step_rowsharded(
                ne, ce, w[0, 0], s[0, 0], LR, NEGW, 0, window=W,
                interpret=True, mxu_bf16=kind == "k1b")
            return ne, ce, lead(loss), lead(n), lead(srv)
        args = (data["ne"], data["ce"], data["walks"], data["pools"])
        specs = (tab, tab, spec, spec)
        outs = (tab, tab, spec, spec, spec)
    elif kind == "k5":
        def body(ne, r, s):
            plans, re, rn, served = jwe.plan_walk_macro_steps(
                r[0, 0][None], s[0, 0][None], rp, 2.0)
            plan = jax.tree.map(lambda a: a[0], plans)
            rows = plan.gather(ne)
            dn, dc, loss, n = jwe.fused_walk_step_prepped(
                ne, ne, rows, rows, plan, re[0], rn[0], LR, NEGW, 0,
                window=1, interpret=True, paired=True)
            ne = ne + jax.lax.psum(dn + dc, "data")
            return ne, lead(loss), lead(n), lead(served[0])
        args = (data["ne"], data["rows"], data["paired_pools"])
        specs = (tab, spec, spec)
        outs = (tab, spec, spec, spec)
    else:  # three steps with the prefetch on
        def body(ne, ce, w, s):
            plans, rw, rn, _ = jwe.plan_walk_macro_steps(
                w[0, 0], s[0, 0], rp, 2.0)

            def gather(carry, plan):
                return plan.gather(carry[0]), plan.gather(carry[1])

            def step(carry, rows, plan, xs):
                a, b = carry
                dn, dc, loss, _ = jwe.fused_walk_step_prepped(
                    a, b, rows[0], rows[1], plan, xs[0], xs[1], LR, NEGW,
                    0, window=W, interpret=True)
                return (a + jax.lax.psum(dn, "data"),
                        b + jax.lax.psum(dc, "data")), loss

            (ne, ce), losses = jwe.prefetch_scan(
                plans, (rw, rn), (ne, ce), gather, step, True)
            return ne, ce, lead(losses)
        args = (data["ne"], data["ce"], data["walks3"], data["pools3"])
        specs = (tab, tab, spec, spec)
        outs = (tab, tab, spec)
    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                                out_specs=outs, check_vma=False))(
        *(jnp.asarray(a) for a in args))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("kind", ["k1", "k1b"])
def test_rowsharded_walk_step_matches_jax(rs_steps, kind):
    """Loss and pairs are summed over the mesh in both packages."""
    data, res = rs_steps
    ne, ce, loss, npairs, served = _jax_steps(data, kind)
    for r, got in enumerate(res):
        gn, gc, gl, n, srv = got[kind]
        mi = r % 2
        sl = slice(mi * V // 2, (mi + 1) * V // 2)
        np.testing.assert_allclose(gn, ne[sl], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gc, ce[sl], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gl, float(loss[0, 0]), rtol=1e-4)
        assert n == float(npairs[0, 0])
        assert srv == float(served[divmod(r, 2)]) == 1.0


def test_rowsharded_paired_step_matches_jax(rs_steps):
    data, res = rs_steps
    ne, loss, npairs, served = _jax_steps(data, "k5")
    total = float(loss.sum())
    for r, got in enumerate(res):
        gn, gl, n, srv = got["k5"]
        mi = r % 2
        sl = slice(mi * V // 2, (mi + 1) * V // 2)
        np.testing.assert_allclose(gn, ne[sl], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gl, total, rtol=1e-4)
        assert n == float(npairs.sum()) == 4 * 8 * 128
        assert srv == float(served[divmod(r, 2)]) == 1.0


def test_prefetch_steps_match_jax(rs_steps):
    """Three O1 steps with the row prefetch on: each step's rows are the
    tables as they were before the previous step landed, in both."""
    data, res = rs_steps
    ne, ce, losses = _jax_steps(data, "prefetch")
    for r, got in enumerate(res):
        gn, gc, gl = got["prefetch"]
        mi = r % 2
        sl = slice(mi * V // 2, (mi + 1) * V // 2)
        np.testing.assert_allclose(gn, ne[sl], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gc, ce[sl], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gl, losses[divmod(r, 2)], rtol=1e-4)
