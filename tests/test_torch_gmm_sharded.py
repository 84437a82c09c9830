"""The port's distributed EM (``losses/gmm.py::gmm_em_fit_sharded``) at
world 2 (gloo ranks, ``tests/_torch_dp.py``): from the same initial
responsibilities against the port's single-device EM (within 1e-5), and
the cases of ``tests/test_gmm_sharded.py``: blobs recovered (NMI > 0.95,
log-likelihood within 0.1 of the JAX single-device fit's), chunks of
unequal fill (121 rows over 2 ranks: one zero-weight pad row) against the
same fit on one process from the same generator state, and masked pad
rows that must not pull a mean.  Every rank must return the same
responsibilities, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dp import gmm, spawn
from come_tpu.losses.gmm import gmm_em_fit as j_gmm_em_fit
from come_tpu_torch.evaluation import nmi_score
from come_tpu_torch.losses.gmm import (
    _kmeans_init,
    gmm_em_fit_sharded,
    gmm_em_from_resp,
)


def _blobs(rng, n_per=64, K=2, d=4, spread=4.0):
    means = rng.normal(size=(K, d)) * spread
    X = np.concatenate(
        [rng.normal(size=(n_per, d)) * 0.5 + means[k] for k in range(K)]
    ).astype(np.float32)
    labels = np.repeat(np.arange(K), n_per)
    perm = rng.permutation(len(X))
    return X[perm], labels[perm]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    rng = np.random.default_rng(0)
    kw = dict(max_iter=30, reg_covar=1e-4)
    blobs, labels = _blobs(rng)
    same, _ = _blobs(rng, n_per=100, K=3, d=8, spread=2.0)
    resp0 = _kmeans_init(torch.as_tensor(same), 3,
                         torch.Generator().manual_seed(5)).numpy()
    uneven, _ = _blobs(rng, n_per=61)
    uneven = uneven[:121]
    masked, _ = _blobs(rng, n_per=62)
    masked = np.concatenate([masked, 77.0 * np.ones((4, 4), np.float32)])
    mask = np.concatenate([np.ones(124, np.float32), np.zeros(4, np.float32)])
    cases = {
        "blobs": (blobs, None, 2, 0, dict(kw, n_init=2)),
        "same_init": (same, None, 3, 0, dict(kw, resp0=resp0)),
        "uneven": (uneven, None, 2, 2, dict(kw)),
        "masked": (masked, mask, 2, 1, dict(kw)),
    }
    res = spawn(gmm, 2, tmp_path_factory.mktemp("gmm"),
                [cases[k] for k in cases])
    out = {k: [r[i] for r in res] for i, k in enumerate(cases)}
    return cases, out, labels


def _same_on_every_rank(outs):
    for o in outs[1:]:
        for k in ("resp", "means", "chol", "log_likelihood"):
            np.testing.assert_array_equal(o[k], outs[0][k])


def test_sharded_em_recovers_blobs(fits):
    cases, out, labels = fits
    X = cases["blobs"][0]
    _same_on_every_rank(out["blobs"])
    o = out["blobs"][0]
    assert nmi_score(labels, o["resp"].argmax(1)) > 0.95
    assert np.isfinite(o["log_likelihood"])
    ref = j_gmm_em_fit(jnp.asarray(X), 2, jax.random.key(0), n_init=2,
                       max_iter=30, reg_covar=1e-4)
    assert float(o["log_likelihood"]) > float(ref["log_likelihood"]) - 0.1


def test_sharded_em_matches_single_device_from_same_init(fits):
    cases, out, _ = fits
    X, _, K, _, kw = cases["same_init"]
    _same_on_every_rank(out["same_init"])
    ref = gmm_em_from_resp(torch.as_tensor(X), torch.as_tensor(kw["resp0"]),
                           reg_covar=1e-4, max_iter=30)
    o = out["same_init"][0]
    for k in ("means", "chol", "resp", "log_weights"):
        np.testing.assert_allclose(o[k], ref[k].numpy(), rtol=0, atol=1e-5)
    assert abs(float(o["log_likelihood"]) - float(ref["log_likelihood"])) \
        <= 1e-5


def test_sharded_em_uneven_chunks(fits):
    """121 rows over 2 ranks (chunks of 61, one zero-weight pad row)
    against the fit on one process from the same generator state."""
    cases, out, _ = fits
    X, _, K, seed, kw = cases["uneven"]
    _same_on_every_rank(out["uneven"])
    one = gmm_em_fit_sharded(torch.as_tensor(X), None, K,
                             torch.Generator().manual_seed(seed), **kw)
    o = out["uneven"][0]
    np.testing.assert_allclose(o["means"], one["means"].numpy(), atol=1e-4)
    assert abs(float(o["log_likelihood"]) - float(one["log_likelihood"])) \
        < 1e-4


def test_sharded_em_masks_pad_rows(fits):
    _, out, _ = fits
    _same_on_every_rank(out["masked"])
    # the outlier pad rows at 77 must not pull any mean
    assert float(np.abs(out["masked"][0]["means"]).max()) < 20.0
