"""The port's GMM EM and O3 community step vs the JAX package.

Inputs are made with numpy from a seed and fed to both sides.  Tolerances:
rtol 1e-4 on the E/M-step pieces (f32 linear algebra by two libraries);
EM from identical initial responsibilities must give the same hard
assignment and mean log-likelihood within 1e-3; the O3 functions rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from come_tpu.losses import community as jcom
from come_tpu.losses import gmm as jgmm
from come_tpu_torch.losses import community as tcom
from come_tpu_torch.losses import gmm as tgmm

torch.set_num_threads(2)


def _clusters(rng, N=240, d=8, K=3, sep=6.0):
    centers = rng.normal(size=(K, d)) * sep
    lab = rng.integers(0, K, N)
    X = (centers[lab] + rng.normal(size=(N, d))).astype(np.float32)
    return X, lab


def _random_gmm(rng, K, d):
    means = rng.normal(size=(K, d)).astype(np.float32)
    A = rng.normal(size=(K, d, d)) * 0.3
    cov = A @ A.transpose(0, 2, 1) + np.eye(d)[None]
    chol = np.linalg.cholesky(cov).astype(np.float32)
    log_w = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    return means, chol, log_w


def test_log_prob_e_step_m_step_match_jax():
    rng = np.random.default_rng(0)
    X, _ = _clusters(rng)
    means, chol, log_w = _random_gmm(rng, 3, X.shape[1])
    t = torch.tensor
    np.testing.assert_allclose(
        tgmm._log_prob(t(X), t(means), t(chol)).numpy(),
        np.asarray(jgmm._log_prob(X, means, chol)), rtol=1e-4, atol=1e-4,
    )
    tr, tll = tgmm._e_step(t(X), t(means), t(chol), t(log_w))
    jr, jll = jgmm._e_step(X, means, chol, log_w)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tll), float(jll), rtol=1e-4)
    resp = np.asarray(jr)
    for a, b in zip(tgmm._m_step(t(X), t(resp), 1e-5),
                    jgmm._m_step(X, resp, 1e-5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("tol", [1e-3, 0.0])
def test_em_from_same_init_matches_jax(tol):
    rng = np.random.default_rng(1)
    X, lab = _clusters(rng, N=300, K=4)
    K = 4
    # a noisy version of the truth as the shared initial responsibilities
    noisy = np.where(rng.random(len(lab)) < 0.3, rng.integers(0, K, len(lab)),
                     lab)
    resp0 = np.eye(K, dtype=np.float32)[noisy]

    m, c, w = jgmm._m_step(jnp.asarray(X), jnp.asarray(resp0), 1e-5)
    Xj = jnp.asarray(X)
    m, c, w = jgmm._em_while_loop(
        m, c, w, lambda a, b, e: jgmm._e_step(Xj, a, b, e),
        lambda r: jgmm._m_step(Xj, r, 1e-5), 30, tol,
    )
    jr, jll = jgmm._e_step(Xj, m, c, w)

    out = tgmm.gmm_em_from_resp(torch.tensor(X), torch.tensor(resp0),
                                reg_covar=1e-5, max_iter=30, tol=tol)
    np.testing.assert_array_equal(out["resp"].argmax(1).numpy(),
                                  np.asarray(jr).argmax(1))
    assert abs(float(out["log_likelihood"]) - float(jll)) < 1e-3
    eye = np.eye(X.shape[1], dtype=np.float32)
    np.testing.assert_allclose(
        (out["inv_cov"] @ (out["chol"] @ out["chol"].transpose(1, 2))).numpy(),
        np.broadcast_to(eye, (K,) + eye.shape), atol=1e-3,
    )


def test_gmm_restarts_batch_and_pick_best():
    rng = np.random.default_rng(2)
    X, lab = _clusters(rng, N=200, K=3, sep=8.0)
    g = torch.Generator().manual_seed(0)
    out = tgmm.gmm_em_fit(torch.tensor(X), 3, g, n_init=3, max_iter=40)
    assert out["resp"].shape == (200, 3) and out["means"].shape == (3, 8)
    # well-separated clusters: the best restart recovers them exactly
    pred = out["resp"].argmax(1).numpy()
    assert len({(a, b) for a, b in zip(lab, pred)}) == 3


def test_community_functions_match_jax():
    rng = np.random.default_rng(3)
    N, d, K, beta = 50, 8, 3, 0.1
    emb = rng.normal(size=(N, d)).astype(np.float32)
    pi = rng.dirichlet(np.ones(K), N).astype(np.float32)
    means, chol, _ = _random_gmm(rng, K, d)
    inv = np.linalg.inv(chol @ chol.transpose(0, 2, 1)).astype(np.float32)
    t = torch.tensor
    np.testing.assert_allclose(
        tcom.community_grad(t(emb), t(pi), t(means), t(inv), beta).numpy(),
        np.asarray(jcom.community_grad(emb, pi, means, inv, beta)), rtol=1e-5,
        atol=1e-7,
    )
    np.testing.assert_allclose(
        float(tcom.community_loss(t(emb), t(pi), t(means), t(chol), t(inv),
                                  beta)),
        float(jcom.community_loss(emb, pi, means, chol, inv, beta)), rtol=1e-5,
    )
    for clip in (None, 0.05):
        np.testing.assert_allclose(
            tcom.community_sgd_step(t(emb), t(pi), t(means), t(inv), beta,
                                    0.5, grad_clip=clip).numpy(),
            np.asarray(jcom.community_sgd_step(emb, pi, means, inv, beta, 0.5,
                                               grad_clip=clip)),
            rtol=1e-5, atol=1e-7,
        )
