"""The GMM's EM as a device program (``losses/gmm.py``) and the star layout
in C++ (``sampling/stars.py``, ``native/stars.cpp``), on the CPU.

* The EM loop gives, bit for bit (``torch.equal``), what the per-iteration
  loop (the loop the port ran before: a host check at the top of every
  iteration) gives: on the eager path (a check after every iteration, or
  once at the end with ``tol`` 0) and on the device program's path (its
  plan's buffers, with the WHILE graph's recording and launch done
  eagerly), for ``tol`` above 0 and 0, two restarts that stop at different
  iterations and ``max_iter`` from 1 to past both stops; the same at world
  2 over gloo for the sharded fit, whose every rank stops at the same
  iteration.
* It still matches the JAX package's EM within the tolerances of
  ``tests/test_torch_losses.py::test_em_from_same_init_matches_jax``
  (argmax of the responsibilities equal, log-likelihood within 1e-3,
  ``inv_cov`` times the covariance within 1e-3 of I).
* A covariance with a non-positive pivot raises ``torch.linalg.
  LinAlgError`` while its restart is active, and not once it has stopped.
* The device program's plan: a fresh plan and a second fit through it give
  the eager bits, it records once, and it counts the kernels of the
  iterations the graph ran.
* The C++ ``build_star_layout`` equals the JAX package's bit for bit on
  karate, an SBM with a hub far above the fan-out cap, a power-law graph
  and the odd row widths and caps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dp import gmm_loops, spawn
from come_tpu.losses import gmm as jgmm
from come_tpu.sampling.stars import build_star_layout as j_star_layout
from come_tpu_torch.graphs import CSRGraph, get_dataset, powerlaw_graph, sbm_graph
from come_tpu_torch.losses import gmm as tgmm
from come_tpu_torch.native import build as nbuild
from come_tpu_torch.ops import launch_plan
from come_tpu_torch.ops.gmm_factor import gmm_factor
from come_tpu_torch.sampling.stars import build_star_layout

torch.set_num_threads(2)
KEYS = ("means", "chol", "inv_cov", "log_weights", "resp", "log_likelihood",
        "n_iter")


def _clusters(rng, N=240, K=4, d=6, sep=3.0):
    centers = rng.normal(size=(K, d)) * sep
    lab = rng.integers(0, K, N)
    return (centers[lab] + rng.normal(size=(N, d))).astype(np.float32), lab


def _two_inits(rng, lab, K):
    """Two noisy one-hot starts: restarts that stop at different
    iterations."""
    out = []
    for noise in (0.2, 0.7):
        z = np.where(rng.random(len(lab)) < noise,
                     rng.integers(0, K, len(lab)), lab)
        out.append(np.eye(K, dtype=np.float32)[z])
    return torch.tensor(np.stack(out))


def _per_iteration(X, resp0, reg_covar, max_iter, tol):
    """The per-iteration EM loop: a host check at the top of every
    iteration (the port's loop before the device program)."""
    means, chol, log_w, _ = tgmm._m_step(X, resp0, reg_covar)
    batch = means.shape[:-2]
    prev_ll = torch.full(batch, -float("inf"))
    ll = torch.full(batch, -float("inf"))
    active = torch.ones(batch, dtype=torch.bool)
    n_iter = torch.zeros(batch, dtype=torch.int32)
    for it in range(max_iter):
        if tol > 0 and it >= 2:
            active = active & (ll - prev_ll > tol)
            if not bool(active.any()):
                break
        resp, new_ll = tgmm._e_step(X, means, chol, log_w)
        n_means, n_chol, n_log_w, info = tgmm._m_step(X, resp, reg_covar)
        assert not bool((info[active] != 0).any())
        means = torch.where(active[..., None, None], n_means, means)
        chol = torch.where(active[..., None, None, None], n_chol, chol)
        log_w = torch.where(active[..., None], n_log_w, log_w)
        prev_ll = torch.where(active, ll, prev_ll)
        ll = torch.where(active, new_ll, ll)
        n_iter += active.to(torch.int32)
    resp, ll = tgmm._e_step(X, means, chol, log_w)
    return dict(means=means, chol=chol, inv_cov=torch.cholesky_inverse(chol),
                log_weights=log_w, resp=resp, log_likelihood=ll,
                n_iter=n_iter)


def _equal(a, b):
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    X, lab = _clusters(rng)
    return torch.tensor(X), _two_inits(rng, lab, 4), lab


class _EagerGraph:
    """GraphPlan's recording and launch done eagerly: the plan's static
    buffers, their reuse, the loop's condition and its launch count, on
    the CPU."""

    def capture_while(self, body, go, it, max_iter, counted=()):
        self.slot = (body, go, it, max_iter)
        self.recordings += 1
        self.instantiations += 1
        self.runs = []

    def launch(self):
        body, go, it, max_iter = self.slot
        n = 0
        while bool(go().any()) and int(it) < int(max_iter):
            body()
            n += 1
        self.replays += 1
        self.runs.append(n)

    def ran(self, n):
        self.counted = getattr(self, "counted", []) + [n]


@pytest.fixture
def device_loop(monkeypatch):
    """Send ``graph=True`` fits through :class:`_EagerGraph`."""
    for name in ("capture_while", "launch", "ran"):
        monkeypatch.setattr(launch_plan.GraphPlan, name,
                            getattr(_EagerGraph, name))
    monkeypatch.setattr(launch_plan, "_PLANS", {})


@pytest.mark.parametrize("max_iter", [1, 2, 11, 41])
@pytest.mark.parametrize("tol", [1e-3, 0.0])
@pytest.mark.parametrize("path", ["eager", "graph"])
def test_em_loop_equals_per_iteration_loop(data, device_loop, path, tol,
                                           max_iter):
    X, resp0, _ = data
    ref = _per_iteration(X, resp0, 1e-5, max_iter, tol)
    out = tgmm.gmm_em_from_resp(X, resp0, 1e-5, max_iter, tol,
                                graph=path == "graph")
    _equal(out, ref)
    n = ref["n_iter"].tolist()
    if tol == 0 or max_iter <= 2:
        assert n == [max_iter, max_iter]
    else:  # the two restarts stop at different iterations
        assert n[0] != n[1] and min(n) < max_iter, n
        if max_iter == 41:  # and both before max_iter
            assert max(n) < max_iter, n


@pytest.mark.parametrize("max_iter", [5, 30])
@pytest.mark.parametrize("path", ["eager", "graph"])
def test_em_matches_jax(device_loop, path, max_iter):
    rng = np.random.default_rng(1)
    X, lab = _clusters(rng, N=300, K=4, d=8, sep=4.0)
    K = 4
    noisy = np.where(rng.random(len(lab)) < 0.3, rng.integers(0, K, len(lab)),
                     lab)
    resp0 = np.eye(K, dtype=np.float32)[noisy]
    Xj = jnp.asarray(X)
    m, c, w = jgmm._m_step(Xj, jnp.asarray(resp0), 1e-5)
    m, c, w = jgmm._em_while_loop(
        m, c, w, lambda a, b, e: jgmm._e_step(Xj, a, b, e),
        lambda r: jgmm._m_step(Xj, r, 1e-5), max_iter, 1e-3)
    jr, jll = jgmm._e_step(Xj, m, c, w)
    out = tgmm.gmm_em_from_resp(torch.tensor(X), torch.tensor(resp0),
                                reg_covar=1e-5, max_iter=max_iter, tol=1e-3,
                                graph=path == "graph")
    np.testing.assert_array_equal(out["resp"].argmax(1).numpy(),
                                  np.asarray(jr).argmax(1))
    assert abs(float(out["log_likelihood"]) - float(jll)) < 1e-3
    eye = np.eye(X.shape[1], dtype=np.float32)
    np.testing.assert_allclose(
        (out["inv_cov"] @ (out["chol"] @ out["chol"].transpose(1, 2))).numpy(),
        np.broadcast_to(eye, (K,) + eye.shape), atol=1e-3)


@pytest.mark.parametrize("path", ["eager", "graph"])
def test_fit_matches_jax_fit(device_loop, path):
    rng = np.random.default_rng(2)
    X, lab = _clusters(rng, N=200, K=3, d=8, sep=8.0)
    out = tgmm.gmm_em_fit(torch.tensor(X), 3, torch.Generator().manual_seed(0),
                          n_init=2, max_iter=40, graph=path == "graph")
    ref = jgmm.gmm_em_fit(jnp.asarray(X), 3, __import__("jax").random.key(0),
                          n_init=2, max_iter=40)
    assert float(out["log_likelihood"]) > float(ref["log_likelihood"]) - 0.1
    pred = out["resp"].argmax(1).numpy()
    assert len({(a, b) for a, b in zip(lab, pred)}) == 3


def test_sharded_em_equals_per_iteration_loop(tmp_path):
    rng = np.random.default_rng(4)
    X, _ = _clusters(rng, N=181, K=3, d=5)
    max_iter = 40
    cases = [dict(n_init=2, max_iter=max_iter, reg_covar=1e-4, tol=tol)
             for tol in (1e-3, 0.0)]
    res = spawn(gmm_loops, 2, tmp_path, X, 3, 9, cases)
    for r in res:  # per rank: (loop, per-iteration loop) for each case
        for i, (out, ref) in enumerate(r):
            for k in ref:
                np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
                np.testing.assert_array_equal(out[k], res[0][i][0][k],
                                              err_msg=k)
    (stop, _), (full, _) = res[0]
    assert stop["ran"] < max_iter and full["ran"] == max_iter
    assert int(stop["n_iter"]) <= stop["ran"]


def _inject(monkeypatch, restart, calls):
    """Make ``_chol`` report a non-positive pivot (and NaN factors) for
    ``restart`` at the M-step calls numbered in ``calls`` (0: the first
    M-step)."""
    count = [0]

    def bad_chol(cov, nk, reg_covar):
        L, info = gmm_factor(cov, nk, reg_covar)
        if count[0] in calls:
            info = info.clone()
            info[restart] = 3
            L = L.clone()
            L[restart] = float("nan")
        count[0] += 1
        return L, info

    monkeypatch.setattr(tgmm, "_chol", bad_chol)


@pytest.mark.parametrize("path", ["eager", "graph"])
def test_non_pd_in_active_restart_raises(data, device_loop, monkeypatch,
                                         path):
    X, resp0, _ = data
    _inject(monkeypatch, 1, {2})
    with pytest.raises(torch.linalg.LinAlgError):
        tgmm.gmm_em_from_resp(X, resp0, 1e-5, 30, 1e-3,
                              graph=path == "graph")
    with pytest.raises(torch.linalg.LinAlgError):  # a real non-PD matrix
        tgmm.gmm_em_from_resp(X, resp0, -100.0, 30, 1e-3,
                              graph=path == "graph")


@pytest.mark.parametrize("path", ["eager", "graph"])
def test_non_pd_in_stopped_restart_does_not_raise(data, device_loop,
                                                  monkeypatch, path):
    X, resp0, _ = data
    clean = tgmm.gmm_em_from_resp(X, resp0, 1e-5, 30, 1e-3,
                                  graph=path == "graph")
    n = clean["n_iter"].tolist()
    early = int(np.argmin(n))
    assert n[early] < max(n)
    # every M-step after the early restart's last one: iterations of it
    # that are discarded
    _inject(monkeypatch, early, set(range(n[early] + 1, 40)))
    out = tgmm.gmm_em_from_resp(X, resp0, 1e-5, 30, 1e-3,
                                graph=path == "graph")
    _equal(out, clean)


@pytest.mark.parametrize("max_iter", [1, 2, 11])
@pytest.mark.parametrize("tol", [1e-3, 0.0])
def test_graph_plan_buffers_give_the_eager_bits(data, device_loop, tol,
                                                max_iter):
    X, resp0, _ = data
    X2 = X + 0.25 * torch.tensor(
        np.random.default_rng(5).normal(size=X.shape).astype(np.float32))
    for x in (X, X2, X):  # a fresh plan, then two fits through it
        out = tgmm.gmm_em_from_resp(x, resp0, 1e-5, max_iter, tol,
                                    graph=True)
        _equal(out, tgmm.gmm_em_from_resp(x, resp0, 1e-5, max_iter, tol,
                                          graph=False))
    (plan,) = launch_plan.plans("gmm_em")
    assert plan.recordings == plan.instantiations == 1
    # the kernels counted: every iteration the graph ran (the first fit's
    # first iteration ran eagerly, and counted itself)
    assert plan.counted == plan.runs
    assert plan.replays == 3
    assert plan.bufs["X"] is not X and torch.equal(plan.bufs["X"], X)


# ------------------------------------------------------- the star layout


def _hub_graph():
    g, _ = sbm_graph(12000, 4, p_in=0.002, p_out=0.0005, seed=3)
    src, dst = g.arcs()
    hub = np.arange(1, 11001, dtype=np.int32)  # degree ~11k at node 0
    src = np.concatenate([src, np.zeros_like(hub)])
    dst = np.concatenate([dst, hub])
    return CSRGraph.from_arcs(src, dst, num_nodes=12000)


@pytest.mark.parametrize("graph", ["karate", "hub", "powerlaw"])
def test_cpp_star_layout_equals_jax(graph):
    g = {"karate": lambda: get_dataset("karate").graph,
         "hub": _hub_graph,
         "powerlaw": lambda: powerlaw_graph(5000, avg_degree=12.0, seed=2)}[
        graph]()
    u, v = g.edges_undirected()
    if graph == "hub":
        assert np.bincount(np.r_[u, v]).max() >= 11000
    for kw in ({}, dict(max_fanout=1), dict(max_fanout=127),
               dict(max_fanout=500), dict(row_slots=16, max_fanout=5)):
        ours = build_star_layout(u, v, g.num_nodes, **kw)
        ref = j_star_layout(u, v, g.num_nodes, **kw)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b), (graph, kw)


def test_cpp_star_layout_edge_cases():
    for u, v, n in ((np.zeros(0, np.int32), np.zeros(0, np.int32), 5),
                    (np.array([3]), np.array([1]), 4),
                    (np.array([0, 0, 0, 2]), np.array([1, 2, 3, 3]), 9)):
        for a, b in zip(build_star_layout(u, v, n), j_star_layout(u, v, n)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        build_star_layout(np.array([0]), np.array([1]), 2, max_fanout=0)
    with pytest.raises(ValueError):
        build_star_layout(np.array([0, -1]), np.array([1, 2]), 3)


def test_failed_star_build_raises(tmp_path):
    out = tmp_path / "libcomestars.so"
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        nbuild.build(cxx="no-such-compiler", out=out, src=nbuild.STARS_SRC)
    assert list(tmp_path.iterdir()) == []
