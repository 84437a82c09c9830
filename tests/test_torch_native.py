"""The port's C++ host walker and feeder against the JAX package's.

``host_random_walks`` must give the JAX package's walks bit for bit (the
same walker arithmetic), the feeder the same batch sequence; a failed build
raises; the ctypes call releases the GIL; a producer failure reaches the
consumer instead of hanging it.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from come_tpu.graphs import get_dataset as j_get_dataset
from come_tpu.graphs.generators import sbm_graph as j_sbm
from come_tpu.native import HostWalkFeeder as JFeeder
from come_tpu.native import host_random_walks as j_walks
from come_tpu_torch.graphs import get_dataset, sbm_graph
from come_tpu_torch.graphs.csr import CSRGraph
from come_tpu_torch.native import HostWalkFeeder, host_random_walks
from come_tpu_torch.native import build


def _isolated_graph():
    """A path 0-1-2-3 plus node 4 with no arcs and a triangle 5-6-7."""
    und = [(0, 1), (1, 2), (2, 3), (5, 6), (6, 7), (5, 7)]
    adj = [[] for _ in range(8)]
    for u, v in und:
        adj[u].append(v)
        adj[v].append(u)
    indptr = np.cumsum([0] + [len(a) for a in adj]).astype(np.int32)
    indices = np.concatenate([np.asarray(a, np.int32) for a in adj])
    return CSRGraph(indptr, indices)


def _graphs():
    return {
        "karate": get_dataset("karate").graph,
        "sbm512": sbm_graph(512, 4, p_in=0.2, p_out=0.01, seed=3)[0],
        "isolated": _isolated_graph(),
    }


@pytest.mark.parametrize("restart", [0.0, 0.15])
@pytest.mark.parametrize("name", ["karate", "sbm512", "isolated"])
def test_host_random_walks_match_jax(name, restart):
    g = _graphs()[name]
    starts = np.tile(np.arange(g.num_nodes, dtype=np.int32), 3)
    ours = host_random_walks(g, starts, 20, seed=7, restart_prob=restart)
    theirs = j_walks(g, starts, 20, seed=7, restart_prob=restart)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == np.int32 and ours.shape == (starts.size, 20)
    if name == "isolated":
        assert (ours[starts == 4] == 4).all()  # isolated nodes stay put
    src, dst = ours[:, :-1].ravel(), ours[:, 1:].ravel()
    hop = np.array([d in g.indices[g.indptr[s]:g.indptr[s + 1]]
                    for s, d in zip(src[:2000], dst[:2000])])
    origin = np.repeat(ours[:, 0], 19)[:2000]
    stay = (src[:2000] == dst[:2000]) & (np.diff(g.indptr)[src[:2000]] == 0)
    assert (hop | stay | (dst[:2000] == origin)).all()


def test_batched_call_matches_jax_per_batch():
    """Batches made in one walker call, each with its own seed, are the JAX
    walker's calls one batch at a time."""
    from come_tpu_torch.native.walker import walk_batches

    g = _graphs()["sbm512"]
    rng = np.random.default_rng(2)
    starts = rng.integers(0, 512, (5, 37)).astype(np.int32)
    seeds = [3, 2**40 + 1, -7, 0, 12345]
    outs = [np.empty((37, 9), np.int32) for _ in seeds]
    walk_batches(g, starts, seeds, 9, outs, restart_prob=0.2, num_threads=3)
    for s, st, out in zip(seeds, starts, outs):
        np.testing.assert_array_equal(
            out, j_walks(g, st, 9, seed=s, restart_prob=0.2))


def test_the_sbm_matches_the_jax_generator():
    g = _graphs()["sbm512"]
    jg, _ = j_sbm(512, 4, p_in=0.2, p_out=0.01, seed=3)
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)


@pytest.mark.parametrize("nodes", [None, np.arange(3, 30, dtype=np.int32)])
def test_feeder_matches_jax_first_batches(nodes):
    """Same seed, batch and start pool: the same first 6 batches (karate,
    34 or 27 starts in batches of 16, so the tail wraps twice)."""
    g = get_dataset("karate").graph
    jg = j_get_dataset("karate").graph
    with HostWalkFeeder(g, batch=16, length=12, seed=5, restart_prob=0.1,
                        nodes=nodes) as ours:
        jf = JFeeder(jg, batch=16, length=12, seed=5, restart_prob=0.1,
                     nodes=nodes)
        try:
            for _ in range(6):
                b = next(ours)
                assert isinstance(b, torch.Tensor) and b.dtype == torch.int32
                np.testing.assert_array_equal(b.numpy(), next(jf))
        finally:
            jf.close()
        assert ours.batches == 6 and ours.wait_s >= 0.0
    assert not ours._thread.is_alive()


@pytest.mark.parametrize("cxx", ["no-such-compiler-xyz", "sh"])
def test_failed_build_raises(tmp_path, cxx):
    """A compiler that does not exist, or one that fails (``sh`` refuses
    g++'s flags), raises with the compiler's output; nothing is left."""
    out = tmp_path / "libcomewalk.so"
    with pytest.raises(RuntimeError) as err:
        build.build(cxx=cxx, out=out)
    assert cxx in str(err.value)
    if cxx == "sh":
        assert "exit code" in str(err.value) and "-O3" in str(err.value)
    assert list(tmp_path.iterdir()) == []


def test_producer_failure_reaches_the_consumer():
    g = get_dataset("karate").graph
    bad = np.array([0, 1, 99], np.int32)  # 99 is no node of karate
    f = HostWalkFeeder(g, batch=2, length=4, nodes=bad)
    try:
        with pytest.raises(RuntimeError, match="producer failed") as err:
            for _ in range(5):
                next(f)
        assert isinstance(err.value.__cause__, ValueError)
        with pytest.raises(StopIteration):
            next(f)
    finally:
        f.close()
    assert not f._thread.is_alive()


def test_walker_call_releases_the_gil():
    """The Python thread runs while the C walker runs on another: the
    feeder's walks overlap the loop that launches the kernels."""
    import ctypes

    from come_tpu_torch.native.walker import _ptr

    g = _graphs()["sbm512"]
    starts = np.tile(np.arange(512, dtype=np.int32), 400)
    out = np.empty((starts.size, 80), np.int32)
    seed = (ctypes.c_uint64 * 1)(1)
    outs = (ctypes.POINTER(ctypes.c_int32) * 1)(_ptr(out))
    lib = build.load_native()
    span = {}

    def walk():
        span["t0"] = time.perf_counter()
        lib.come_random_walks_batched(_ptr(g.indptr), _ptr(g.indices),
                                      _ptr(starts), 1, starts.size, 80, seed,
                                      0.0, outs, 1)
        span["t1"] = time.perf_counter()

    th = threading.Thread(target=walk)
    ticks = []
    th.start()
    while th.is_alive():
        ticks.append(time.perf_counter())
    th.join(timeout=60)
    assert not th.is_alive()
    # held, the GIL would stop this loop until the call returns: count
    # its turns in the first half of the call
    half = span["t0"] + 0.5 * (span["t1"] - span["t0"])
    inside = [t for t in ticks if span["t0"] < t < half]
    assert span["t1"] - span["t0"] > 0.02
    assert len(inside) > 1000, (len(inside), span["t1"] - span["t0"])
    np.testing.assert_array_equal(out[:, 0], starts)


def test_feeders_under_thread_stress():
    """Twelve feeders at once, with a short switch interval: each hands out
    exactly the sequence its seed gives when made alone."""
    g = get_dataset("karate").graph
    ref = {}
    for seed in range(12):
        with HostWalkFeeder(g, batch=16, length=8, seed=seed,
                            num_threads=2) as f:
            ref[seed] = [next(f).numpy().copy() for _ in range(8)]
    got = {}

    def consume(seed):
        with HostWalkFeeder(g, batch=16, length=8, seed=seed,
                            num_threads=2) as f:
            got[seed] = [next(f).numpy().copy() for _ in range(8)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(s,))
                   for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for seed in range(12):
        for a, b in zip(ref[seed], got[seed]):
            np.testing.assert_array_equal(a, b)
