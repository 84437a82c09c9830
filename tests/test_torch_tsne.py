"""``come_tpu_torch/evaluation/tsne.py`` against sklearn's exact t-SNE
(``method="exact"``; the projection ``come_tpu/evaluation/plots.py:20-25``
calls sklearn's Barnes-Hut default, and the port is exact by design), on
240 seeded points (16-D, four Gaussian clusters), on the CPU:

* P equal to ``_joint_probabilities`` within 1e-6 (absolute);
* the KL divergence and its gradient at one Y equal to ``_kl_divergence``
  within rtol 1e-5 (also with P exaggerated 12 times);
* ``trustworthiness`` equal to sklearn's on the same maps;
* the whole fit (PCA init, 1000 iterations) against ``TSNE(method="exact",
  init="pca", random_state=0)``: final KL within 5% and the 5- and
  10-neighbour trustworthiness within 0.01 (coordinates are not compared);
* the PCA init equal to sklearn's;
* the cap on V raising, and ``plots.project_2d(method="tsne")``.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.distance import squareform
from sklearn.decomposition import PCA
from sklearn.manifold import TSNE
from sklearn.manifold import trustworthiness as sk_trust
from sklearn.manifold._t_sne import _joint_probabilities, _kl_divergence
from sklearn.metrics import pairwise_distances

from come_tpu_torch.evaluation import tsne as T
from come_tpu_torch.evaluation.plots import project_2d

torch.set_num_threads(2)

N, D, K = 240, 16, 4


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(K, D)) * 3
    return (c[rng.integers(0, K, N)] + rng.normal(size=(N, D))).astype(
        np.float32)


@pytest.fixture(scope="module")
def sk_p(points):
    return _joint_probabilities(
        pairwise_distances(points, squared=True), 30.0, 0)


@pytest.fixture(scope="module")
def fits(points):
    sk = TSNE(2, random_state=0, init="pca", method="exact")
    y_sk = sk.fit_transform(points)
    y, kls = T.tsne(points, device="cpu", return_kl=True)
    return sk, y_sk, y, kls


def test_joint_probabilities_match_sklearn(points, sk_p):
    P = T.joint_probabilities(torch.as_tensor(points), 30.0).numpy()
    np.testing.assert_allclose(P, squareform(sk_p), rtol=0, atol=1e-6)
    np.testing.assert_allclose(P, P.T)
    assert P.sum() == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("exaggeration", [1.0, 12.0])
def test_kl_and_gradient_match_sklearn(points, sk_p, exaggeration):
    y = np.random.default_rng(1).normal(size=(N, 2)).astype(np.float32)
    want_kl, want_g = _kl_divergence(y.ravel(), sk_p * exaggeration, 1, N,
                                     2)
    P = T.joint_probabilities(torch.as_tensor(points), 30.0)
    kl, g = T.kl_and_grad(torch.as_tensor(y, dtype=torch.float64), P,
                          exaggeration)
    np.testing.assert_allclose(kl, want_kl, rtol=1e-5)
    np.testing.assert_allclose(g.numpy().ravel(), want_g, rtol=1e-5,
                               atol=1e-5 * np.abs(want_g).max())


def test_trustworthiness_equals_sklearn(points, fits):
    _, y_sk, y, _ = fits
    for k in (5, 10):
        for m in (y_sk, y):
            assert T.trustworthiness(points, m, k, device="cpu") == \
                pytest.approx(sk_trust(points, m, n_neighbors=k), abs=1e-12)


def test_fit_within_band_of_sklearn(points, fits):
    """Final KL within 5% of sklearn's, trustworthiness within 0.01; the
    exaggerated stage's KL readings every 50 iterations, then the KL falls
    once exaggeration ends."""
    sk, y_sk, y, kls = fits
    assert y.shape == (N, 2) and np.isfinite(y).all()
    its = [i for i, _ in kls]
    assert its == list(range(50, 1001, 50))
    kl = dict(kls)
    assert kl[1000] == pytest.approx(sk.kl_divergence_, rel=0.05)
    assert kl[300] > kl[1000] and kl[250] > kl[300]
    for k in (5, 10):
        assert T.trustworthiness(points, y, k, device="cpu") == pytest.approx(
            sk_trust(points, y_sk, n_neighbors=k), abs=0.01)


def test_pca_init_matches_sklearn(points):
    """The init sklearn's ``TSNE(init="pca")`` makes: ``PCA(2)`` of the
    points as float32, scaled to a first-component std of 1e-4, signs
    and all."""
    want = PCA(2, random_state=0).fit_transform(points).astype(np.float32)
    want = want / np.std(want[:, 0]) * 1e-4
    got = T.pca_init(torch.as_tensor(points, dtype=torch.float64)).numpy()
    assert got.shape == (N, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 1e-4)


def test_cap_raises():
    with pytest.raises(ValueError, match="20000 points.*PCA"):
        T.tsne(np.zeros((T.MAX_NODES + 1, 2), np.float32), device="cpu")


def test_project_2d_tsne_and_pca_default(points):
    xy, basis = project_2d(points[:60], method="tsne", device="cpu")
    assert basis is None and xy.shape == (60, 2) and np.isfinite(xy).all()
    xy, basis = project_2d(points)
    assert basis.shape == (D, 2)
    with pytest.raises(ValueError):
        project_2d(points, method="umap")
