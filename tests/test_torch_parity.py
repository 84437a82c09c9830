"""The port's numpy oracle and gradient parity harness on the CPU.

``come_tpu_torch/evaluation/oracle.py`` is a copy of the JAX package's: on
the same seeded numpy inputs every one of its nine functions must return
the JAX package's results bit for bit.  The port's parity harness
(``evaluation/parity.py``) must pass on karate for seeds 0-2 at the JAX
harness test's size (``tests/test_parity_harness.py:9``: dim 16, pairs 256)
within that test's thresholds; there, on CPU tensors, every row runs the
kernels' plain versions.  The harness on the card runs in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

from come_tpu.evaluation import oracle as jax_oracle
from come_tpu_torch.evaluation import oracle
from come_tpu_torch.evaluation.parity import check_gradient_parity, main
from come_tpu_torch.graphs import get_dataset
from come_tpu_torch.sampling.stars import PAD_META, build_star_layout

torch.set_num_threads(2)


def _inputs(name, rng):
    """Arguments of oracle function ``name`` from ``rng`` (small sizes)."""
    V, d, P, K, KP = 40, 8, 30, 3, 6
    emb_in = (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    emb_out = (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    c, x = (rng.integers(0, V, P).astype(np.int32) for _ in range(2))
    negs = rng.integers(0, V, (P, K)).astype(np.int32)
    mask = rng.random(P) < 0.8
    pool = rng.integers(0, V, KP).astype(np.int32)
    walks = rng.integers(0, V, (16, 10)).astype(np.int32)
    wrow = rng.integers(1, 4, (16, 10)).astype(np.int32)
    if name == "sigmoid":
        return (rng.normal(size=50) * 4,)
    if name == "sgns_batch_grads":
        return emb_in, emb_out, c, x, negs, mask, 2.0
    if name == "sgns_batch_grads_tied":
        return emb_in, c, x, negs, mask
    if name == "sgns_shared_pool_grads":
        return emb_in, emb_out, c, x, pool, mask, 0.5
    if name == "walk_banded_shared_pool_grads":
        return emb_in, emb_out, walks, pool, wrow, 0.5
    if name == "walk_banded_kernel_sequential":
        return (emb_in, emb_out, walks, rng.integers(0, V, (2, KP)), wrow,
                0.5, 0.05, 8)
    if name == "community_grads":
        pi = rng.random((V, 3)).astype(np.float32)
        pi /= pi.sum(1, keepdims=True)
        A = rng.normal(size=(3, d, d)).astype(np.float32) * 0.1
        inv = np.linalg.inv(np.einsum("kde,kfe->kdf", A, A) + np.eye(d))
        return emb_in, pi, rng.normal(size=(3, d)), inv, 0.1
    if name == "gmm_log_likelihood":
        X = rng.normal(size=(60, 3))
        covs = np.stack([np.eye(3) * (1 + k) for k in range(2)])
        return X, rng.normal(size=(2, 3)), covs, np.array([0.4, 0.6])
    if name == "star_kernel_sequential":
        u = rng.integers(0, V, 200)
        v = (u + 1 + rng.integers(0, V - 1, 200)) % V
        s, m = build_star_layout(u, v, V)
        s = np.pad(s, (0, 2048 - s.shape[0]))
        m = np.pad(m, (0, 2048 - m.shape[0]), constant_values=PAD_META)
        return emb_in, s, m, rng.integers(0, V, (1, KP)), 0.5, 0.05, 2
    raise KeyError(name)


FUNCTIONS = ["sigmoid", "sgns_batch_grads", "sgns_batch_grads_tied",
             "sgns_shared_pool_grads", "walk_banded_shared_pool_grads",
             "walk_banded_kernel_sequential", "community_grads",
             "gmm_log_likelihood", "star_kernel_sequential"]


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_oracle_matches_jax_package_bit_for_bit(name):
    args = _inputs(name, np.random.default_rng(7))
    got = _flat(getattr(oracle, name)(*args))
    want = _flat(getattr(jax_oracle, name)(*args))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b


def test_oracle_covers_every_function():
    public = {k for k, v in vars(jax_oracle).items()
              if callable(v) and getattr(v, "__module__", "") ==
              jax_oracle.__name__}
    assert public == set(FUNCTIONS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_passes_on_karate_cpu(seed):
    ds = get_dataset("karate")
    rep = check_gradient_parity(ds.graph, dim=16, pairs=256, seed=seed,
                                device="cpu")
    assert rep.passed, str(rep)
    assert rep.o1_max_err < 1e-4
    assert rep.o2_max_err < 1e-4
    assert rep.o3_max_err < 1e-4
    assert rep.o1_fast_max_err < 1e-3
    assert rep.o2_fast_max_err < 1e-3
    assert rep.o1_fast_multi_max_err < 1e-3
    assert rep.o2_fanout_max_err < 1e-3
    assert rep.o2_star_max_err < 1e-3
    # no multi-GPU path yet: the row-sharded rows stay nan
    assert math.isnan(rep.o1_fast_rowsharded_max_err)
    assert math.isnan(rep.o2_rowsharded_max_err)


def test_parity_cli_exits_0_on_cpu(capsys):
    assert main(["--dataset", "karate", "--iters", "3", "--device",
                 "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all("parity PASS" in ln for ln in lines)
