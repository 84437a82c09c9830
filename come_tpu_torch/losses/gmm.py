"""Batched full-covariance GMM EM in PyTorch.

Port of ``come_tpu/losses/gmm.py`` (the single-device fit): the E and M
steps are dense linear algebra (Cholesky log-pdf, responsibility-weighted
moments), the ``n_init`` restarts run at once as a leading batch dimension
(the JAX package's ``vmap``), and the best restart is chosen by its final
mean log-likelihood.  EM stops per restart by sklearn's tol rule, as
``_em_while_loop`` does.  Every function takes optional leading batch
dimensions on the mixture parameters; ``X`` is shared.

The [..., K, N, d] temporaries of the E and M steps are built over
``ROW_CHUNK`` rows of X at a time (XLA fuses them in the JAX package; at
N = 500 000 and K = 64 one whole temporary would be 16.4 GB), so only the
order of the f32 sums over N differs from the unchunked form.
"""

from __future__ import annotations

import torch

_LOG_2PI = 1.8378770664093453
# rows of X per [..., K, rows, d] temporary (~1.07 GB at K = 64, d = 128)
ROW_CHUNK = 32768


def _log_prob(X, means, chol):
    """Gaussian log-pdfs: X [N,d], means [...,K,d], chol [...,K,d,d]
    -> [...,N,K]."""
    d = X.shape[-1]
    quad = []
    for Xc in X.split(ROW_CHUNK):
        diff = (Xc - means[..., :, None, :]).transpose(-1, -2)  # [...,K,d,n]
        y = torch.linalg.solve_triangular(chol, diff, upper=False)
        quad.append((y * y).sum(-2))  # [...,K,n]
    quad = torch.cat(quad, -1)  # [...,K,N]
    logdet = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return (-0.5 * (d * _LOG_2PI + quad) - logdet[..., None]).transpose(-1, -2)


def _e_step(X, means, chol, log_w):
    """Returns (resp [...,N,K], mean log-likelihood [...])."""
    lp = _log_prob(X, means, chol) + log_w[..., None, :]
    norm = torch.logsumexp(lp, dim=-1, keepdim=True)
    return torch.exp(lp - norm), norm.mean((-2, -1))


def _m_step(X, resp, reg_covar):
    """Responsibility-weighted moments -> (means, chol, log_weights)."""
    N, d = X.shape
    nk = resp.sum(-2) + 10.0 * torch.finfo(X.dtype).eps  # [...,K]
    means = (resp.transpose(-1, -2) @ X) / nk[..., None]
    cov = 0.0
    for Xc, rc in zip(X.split(ROW_CHUNK), resp.split(ROW_CHUNK, dim=-2)):
        diff = Xc - means[..., :, None, :]  # [...,K,n,d]
        weighted = diff * rc.transpose(-1, -2)[..., None]
        cov = cov + weighted.transpose(-1, -2) @ diff
    cov = cov / nk[..., None, None]
    cov = cov + reg_covar * torch.eye(d, dtype=X.dtype, device=X.device)
    chol = torch.linalg.cholesky(cov)
    return means, chol, torch.log(nk / N)


def _kmeans_init(X, K, generator: torch.Generator, iters: int = 8):
    """k-means-style init: K distinct random points as centers, ``iters``
    Lloyd iterations, one-hot responsibilities.  ``generator`` is a CPU
    generator (the choice of centers is a host draw)."""
    N = X.shape[0]
    idx = torch.randperm(N, generator=generator)[:K].to(X.device)
    centers = X[idx]

    def sqdist(c):
        return (
            (X * X).sum(1, keepdim=True) - 2.0 * X @ c.T + (c * c).sum(1)[None]
        )

    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(
            sqdist(centers).argmin(1), K
        ).to(X.dtype)
        counts = onehot.sum(0)
        new = (onehot.T @ X) / counts.clamp_min(1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
    return torch.nn.functional.one_hot(sqdist(centers).argmin(1), K).to(X.dtype)


def _em_while_loop(means, chol, log_w, e_step, m_step, max_iter, tol):
    """EM until the mean log-likelihood improves by less than ``tol``
    (sklearn's rule), at most ``max_iter`` iterations, judged per restart.
    ``it < 2`` keeps the first two iterations unconditional (the
    likelihoods start at -inf); ``tol <= 0`` runs every iteration."""
    batch = means.shape[:-2]
    dev = means.device
    prev_ll = torch.full(batch, -float("inf"), device=dev)
    ll = torch.full(batch, -float("inf"), device=dev)
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    for it in range(max_iter):
        if tol > 0 and it >= 2:
            active = active & (ll - prev_ll > tol)
            if not bool(active.any()):
                break
        resp, new_ll = e_step(means, chol, log_w)
        n_means, n_chol, n_log_w = m_step(resp)
        means = torch.where(active[..., None, None], n_means, means)
        chol = torch.where(active[..., None, None, None], n_chol, chol)
        log_w = torch.where(active[..., None], n_log_w, log_w)
        prev_ll = torch.where(active, ll, prev_ll)
        ll = torch.where(active, new_ll, ll)
    return means, chol, log_w


def gmm_em_from_resp(X, resp0, reg_covar=1e-5, max_iter=60, tol=1e-3):
    """EM from given initial responsibilities ``resp0`` [...,N,K]: one
    M-step, the tol-rule loop, a final E-step.  Returns dict(means, chol,
    inv_cov, log_weights, resp, log_likelihood), batched like ``resp0``."""
    X = X.to(torch.float32)
    means, chol, log_w = _m_step(X, resp0, reg_covar)
    means, chol, log_w = _em_while_loop(
        means, chol, log_w,
        lambda m, c, w: _e_step(X, m, c, w),
        lambda r: _m_step(X, r, reg_covar),
        max_iter, tol,
    )
    resp, ll = _e_step(X, means, chol, log_w)
    return dict(
        means=means, chol=chol, inv_cov=torch.cholesky_inverse(chol),
        log_weights=log_w, resp=resp, log_likelihood=ll,
    )


def gmm_em_fit(X, num_components, generator, n_init=1, max_iter=60,
               reg_covar=1e-5, tol=1e-3):
    """Fit a full-covariance GMM with ``n_init`` k-means restarts run as one
    batch; returns the best restart's dict (see :func:`gmm_em_from_resp`)."""
    X = X.to(torch.float32)
    resp0 = torch.stack([
        _kmeans_init(X, num_components, generator) for _ in range(n_init)
    ])
    out = gmm_em_from_resp(X, resp0, reg_covar, max_iter, tol)
    best = int(out["log_likelihood"].argmax())
    return {k: v[best] for k, v in out.items()}


def fit_communities(params, generator, n_init=1, max_iter=60,
                    reg_covar=1e-5, tol=1e-3, resp0=None):
    """EM on ``params.node_emb``; writes means, Cholesky factors, inverse
    covariances and responsibilities into ``params`` in place and returns
    the mean log-likelihood (0-dim tensor).  ``resp0`` [N,K] starts EM from
    given responsibilities instead of the k-means restarts."""
    X = params.node_emb
    if resp0 is None:
        out = gmm_em_fit(X, params.num_communities, generator, n_init,
                         max_iter, reg_covar, tol)
    else:
        out = gmm_em_from_resp(X, resp0.to(X), reg_covar, max_iter, tol)
    params.centroid.copy_(out["means"])
    params.chol_cov.copy_(out["chol"])
    params.inv_cov.copy_(out["inv_cov"])
    params.pi.copy_(out["resp"])
    return out["log_likelihood"]
