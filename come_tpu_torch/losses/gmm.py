"""Batched full-covariance GMM EM in PyTorch.

Port of ``come_tpu/losses/gmm.py`` (the single-device fit): the E and M
steps are dense linear algebra (Cholesky log-pdf, responsibility-weighted
moments), the ``n_init`` restarts run at once as a leading batch dimension
(the JAX package's ``vmap``), and the best restart is chosen by its final
mean log-likelihood.  EM stops per restart by sklearn's tol rule, as
``_em_while_loop`` does.  Every function takes optional leading batch
dimensions on the mixture parameters; ``X`` is shared.

:func:`gmm_em_fit_sharded` is the data-axis half of the JAX package's
distributed EM (``come_tpu/losses/gmm.py:174-346``) for data-parallel
training: each rank works a chunk of the rows and every moment is summed
over the ranks.

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


def _scatter(X, resp, means):
    """Sum over the rows of resp-weighted outer products of ``X - means``
    [...,K,d,d] (not yet divided by nk), ``ROW_CHUNK`` rows at a time."""
    cov = 0.0
    for Xc, rc in zip(X.split(ROW_CHUNK), resp.split(ROW_CHUNK, dim=-2)):
        diff = Xc - means[..., :, None, :]  # [...,K,n,d]
        weighted = diff * rc.transpose(-1, -2)[..., None]
        cov = cov + weighted.transpose(-1, -2) @ diff
    return cov


def _chol(cov, nk, reg_covar):
    d = cov.shape[-1]
    cov = cov / nk[..., None, None]
    cov = cov + reg_covar * torch.eye(d, dtype=cov.dtype, device=cov.device)
    return torch.linalg.cholesky(cov)


def _m_step(X, resp, reg_covar):
    """Responsibility-weighted moments -> (means, chol, log_weights)."""
    N = X.shape[0]
    nk = resp.sum(-2) + 10.0 * torch.finfo(X.dtype).eps  # [...,K]
    means = (resp.transpose(-1, -2) @ X) / nk[..., None]
    chol = _chol(_scatter(X, resp, means), nk, reg_covar)
    return means, chol, torch.log(nk / N)


def _sqdist(X, c):
    return (X * X).sum(1, keepdim=True) - 2.0 * X @ c.T + (c * c).sum(1)[None]


def _kmeans_init(X, K, generator: torch.Generator, iters: int = 8):
    """k-means-style init: K distinct random points as centers, ``iters``
    Lloyd iterations, one-hot responsibilities.  ``generator`` is a CPU
    generator (the choice of centers is a host draw)."""
    N = X.shape[0]
    idx = torch.randperm(N, generator=generator)[:K].to(X.device)
    centers = X[idx]
    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(
            _sqdist(X, centers).argmin(1), K
        ).to(X.dtype)
        counts = onehot.sum(0)
        new = (onehot.T @ X) / counts.clamp_min(1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
    return torch.nn.functional.one_hot(_sqdist(X, centers).argmin(1),
                                       K).to(X.dtype)


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


def gmm_em_fit_sharded(X, mask, num_components, generator, group=None,
                       n_init=1, max_iter=60, reg_covar=1e-5, tol=1e-3,
                       resp0=None, model=1):
    """Distributed EM over the ranks of ``group``, a (D, ``model``) mesh
    whose rank r is (r // model, r % model) (``gmm_em_fit_sharded(axis=
    "model", data_axis="data")``, ``come_tpu/losses/gmm.py:174-346``).

    ``X`` [V, d] is this rank's model shard of the table (the whole table
    at model 1, the same on every rank), and ``mask`` [V] (None: all ones)
    weights its rows, 0 for pad rows.  Each of the D data ranks of a shard
    works the chunk of ``ceil(V / D)`` rows from ``data_index * chunk``
    (zero-weight pad rows past V); ``nk``, the means, the covariances and
    the log-likelihood are summed over the whole mesh, so every rank takes
    the same EM path and stops at the same iteration.  The k-means init
    draws K global row ids, one per stride of ``V * model // K`` rows of
    the model-shard-major id space, from the host ``generator``, which
    must be in the same state on every rank; each rank contributes the
    centers it holds.  The ``n_init`` restarts run at once as a leading
    batch dimension, as in :func:`gmm_em_fit` (the JAX package runs them
    in turn), and the best by log-likelihood wins.  ``resp0`` [V, K]
    (this shard's rows) starts EM from these responsibilities instead.
    The responsibilities returned cover every row of ``X`` (row-wise
    normalisation is local), so they are the same on every data rank of a
    shard.

    Returns the dict of :func:`gmm_em_from_resp` for the best restart."""
    from come_tpu_torch.parallel.collectives import all_reduce_, world_rank

    K = num_components
    X = X.to(torch.float32)
    V, d = X.shape
    dev = X.device
    w = (torch.ones(V, device=dev) if mask is None
         else mask.to(device=dev, dtype=torch.float32))
    world, rank = world_rank(group)
    D, (r, mi) = world // model, divmod(rank, model)
    chunk = -(-V // D)
    pad = chunk * D - V

    def mine(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 1) + (0, pad))[
            r * chunk:(r + 1) * chunk]

    Xc, wc = mine(X), mine(w)
    n_total = all_reduce_(wc.sum(), group)
    eps = 10.0 * torch.finfo(torch.float32).eps

    def moments(resp):
        """All-reduced (sums of resp [n, K], of resp^T X [n, K, d])."""
        sums = all_reduce_(torch.cat([resp.sum(-2)[..., None],
                                      resp.transpose(-1, -2) @ Xc], -1),
                           group)
        return sums[..., 0], sums[..., 1:]

    def m_step(resp):
        resp = resp * wc[:, None]
        nk, sx = moments(resp)
        nk = nk + eps
        means = sx / nk[..., None]
        cov = all_reduce_(_scatter(Xc, resp, means), group)
        return means, _chol(cov, nk, reg_covar), torch.log(nk / n_total)

    def e_step(means, chol, log_w):
        lp = _log_prob(Xc, means, chol) + log_w[..., None, :]
        norm = torch.logsumexp(lp, dim=-1, keepdim=True)
        ll = all_reduce_((norm[..., 0] * wc).sum(-1), group) / n_total
        return torch.exp(lp - norm), ll

    def init_resp():
        # one center per stride of rows, so the K global ids are distinct
        stride = max(V * model // K, 1)
        offs = torch.stack([torch.randint(0, stride, (K,),
                                          generator=generator)
                            for _ in range(n_init)])
        idx = torch.clamp(torch.arange(K) * stride + offs,
                          max=V * model - 1).to(dev)
        local = idx - mi * V
        ok = (local >= 0) & (local < V)
        local = local - r * chunk
        ok = ok & (local >= 0) & (local < chunk)
        centers = torch.where(ok[..., None],
                              Xc[local.clamp(0, chunk - 1)], 0.0)
        centers = all_reduce_(centers, group)  # [n, K, d]

        def assign(c):
            d2 = ((Xc * Xc).sum(1, keepdim=True) - 2.0 * Xc @ c.transpose(
                -1, -2) + (c * c).sum(-1)[..., None, :])
            return torch.nn.functional.one_hot(d2.argmin(-1), K).to(X.dtype)

        for _ in range(8):
            counts, sx = moments(assign(centers) * wc[:, None])
            new = sx / counts.clamp_min(1.0)[..., None]
            centers = torch.where(counts[..., None] > 0, new, centers)
        return assign(centers)

    rc = init_resp() if resp0 is None else mine(resp0.to(X))[None]
    means, chol, log_w = _em_while_loop(*m_step(rc), e_step, m_step,
                                        max_iter, tol)
    _, ll = e_step(means, chol, log_w)
    best = int(ll.argmax())
    means, chol, log_w = means[best], chol[best], log_w[best]
    resp, _ = _e_step(X, means, chol, log_w)
    return dict(
        means=means, chol=chol, inv_cov=torch.cholesky_inverse(chol),
        log_weights=log_w, resp=resp, log_likelihood=ll[best],
    )


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
