"""G1 (``come_tpu_torch/ops/gmm_factor.py``) on the CPU against the JAX
package's linear algebra.

On CPU tensors ``gmm_factor`` and ``gmm_inverse`` take their plain versions
(``torch.linalg.cholesky_ex`` of ``cov / nk + reg I``, and
``torch.cholesky_inverse``); on the card ``tests/test_torch_cuda.py`` holds
the kernel to those same plain versions on the same matrices
(``chip_smoke.g1_moments``, ``g1_pivot_batch``: numpy, from a seed).  Here
the plain path is pinned to ``jax.lax.linalg.cholesky`` and
``jax.scipy.linalg.cho_solve((L, True), I)``, as ``come_tpu/losses/gmm.py``
uses them (``:52``, ``:163``), at the widths where the kernel's panels of 16
columns are whole or ragged (``chip_smoke.G1_WIDTHS``).

Tolerance, per matrix, on the relative Frobenius error: both sides factor
the same f32 matrix in f32 and differ only in the order of their roundings,
so the factor may differ by about d u sqrt(kappa) and the inverse by
d u kappa (u = 2^-24, kappa the matrix's 2-norm condition number in
float64; the normwise forward-error bounds of a Cholesky factor and of an
inverse formed from it).  At these moments (kappa up to ~470) that allows
~1.3e-4 for L and ~2.4e-3 for the inverse at d = 128; the errors read at
most 1.3e-7 and 3.4e-7.

A matrix whose leading minor of order k + 1 is not positive definite (a
non-positive pivot at the first, middle or last column of a panel, or in
a ragged last panel) must get the info flag k + 1, and the matrices the port
flags must be exactly those whose JAX factor holds a NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import G1_WIDTHS, g1_moments, g1_pivot_batch
from come_tpu_torch.ops.gmm_factor import gmm_factor, gmm_inverse

REG = 1e-5
U = 2.0 ** -24


def _jax_factor_inverse(cov, nk, reg):
    """come_tpu/losses/gmm.py's factor (:50-52) and inverse (:162-163)."""
    d = cov.shape[-1]
    a = jnp.asarray(cov) / jnp.asarray(nk)[..., None, None]
    a = a + reg * jnp.eye(d, dtype=a.dtype)
    chol = jax.lax.linalg.cholesky(a)
    eye = jnp.eye(d, dtype=a.dtype)
    solve = jax.vmap(lambda L: jax.scipy.linalg.cho_solve((L, True), eye))
    inv = solve(chol.reshape(-1, d, d)).reshape(chol.shape)
    return np.asarray(a), np.asarray(chol), np.asarray(inv)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.linalg.norm(a - b, axis=(-2, -1))
            / np.linalg.norm(b, axis=(-2, -1)))


@pytest.mark.parametrize("d", G1_WIDTHS)
def test_g1_factor_and_inverse_match_jax(d):
    cov, nk = g1_moments(2, 3, d, seed=d)
    L, info = gmm_factor(torch.from_numpy(cov), torch.from_numpy(nk), REG)
    inv = gmm_inverse(L)
    a, Lj, invj = _jax_factor_inverse(cov, nk, REG)
    assert info.dtype == torch.int32 and info.shape == (2, 3)
    assert not info.any()
    kappa = np.linalg.cond(a.astype(np.float64))
    err_l, err_inv = _rel(L.numpy(), Lj), _rel(inv.numpy(), invj)
    assert (err_l <= d * U * np.sqrt(kappa)).all(), (err_l, kappa)
    assert (err_inv <= d * U * kappa).all(), (err_inv, kappa)
    assert np.array_equal(np.triu(L.numpy(), 1), np.zeros_like(L.numpy()))
    assert np.array_equal(inv.numpy(), np.swapaxes(inv.numpy(), -1, -2))


@pytest.mark.parametrize("d", G1_WIDTHS)
def test_g1_pivot_flags_match_jax_nans(d):
    cov, nk, want = g1_pivot_batch(d, seed=100 + d)
    _, info = gmm_factor(torch.from_numpy(cov), torch.from_numpy(nk), REG)
    _, Lj, _ = _jax_factor_inverse(cov, nk, REG)
    assert info.numpy().tolist() == want.tolist()
    flagged = info.numpy() != 0
    assert np.array_equal(flagged, np.isnan(Lj).any(axis=(-2, -1)))
