"""Exact t-SNE in torch ops, for the plots' ``method="tsne"``.

Port of the projection ``come_tpu/evaluation/plots.py:17-29``
(``_project_2d``) makes with ``sklearn.manifold.TSNE(2, random_state=seed,
init="pca")``, at the defaults that call takes: perplexity 30, 1000
iterations, early exaggeration 12 and ``learning_rate="auto"`` =
max(N / 12 / 4, 50).  That call runs sklearn's default
``method="barnes_hut"`` (P over each point's 3 * perplexity nearest
neighbours, the repulsion approximated at angle 0.5); this module runs the
exact algorithm (sklearn's ``method="exact"``) by design, a deviation from
the JAX projection: dense P, every pair's repulsion.  sklearn is not a
Pallas kernel, so torch ops on the caller's device are the port; the steps
follow ``sklearn/manifold/_t_sne.py``:

* P (:func:`joint_probabilities`, ``_joint_probabilities``): squared
  euclidean distances (float64, stored as float32 as sklearn does), a
  binary search per row for the precision whose conditional distribution
  has entropy log(perplexity) (``_utils._binary_search_perplexity``: 100
  steps at most, tolerance 1e-5), symmetrised, normalised and floored at
  the float64 epsilon;
* Q: the Student-t kernel w_ij = 1 / (1 + |y_i - y_j|^2) over its sum Z;
* the KL divergence and its gradient 4 sum_j (p_ij - q_ij) w_ij (y_i - y_j)
  (``_kl_divergence``), one pass over row blocks of :data:`BLOCK_ELEMS`
  pairs, so no V x V Q is held: the repulsive part is
  sum_j w_ij^2 (y_i - y_j) / Z and KL = sum p log p - sum p log w + log Z
  (sklearn also floors q at the float64 epsilon, which only moves points
  ~1e7 apart);
* sklearn's optimiser (``_gradient_descent``): 250 iterations at momentum
  0.5 with P exaggerated 12 times, then momentum 0.8 to 1000; gains +0.2
  where the step and the gradient disagree in sign, x0.8 where they agree,
  at least 0.01, both reset between the two stages; the KL every 50
  iterations, a stage stops after 250 (then 300) iterations without a
  better KL or at gradient norm 1e-7;
* init (:func:`pca_init`): PCA of the centred input (each component's
  largest entry positive, as sklearn's ``svd_flip``) scaled to a
  first-component std of 1e-4.  Nothing is drawn at random, so the JAX
  call's ``random_state`` has nothing to seed here.

P is dense: :data:`MAX_NODES` rows (20 000, 1.6 GB of float32) at most;
above it :func:`tsne` raises ``ValueError`` (plot such graphs by PCA).  It
never subsamples.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_NODES = 20_000
BLOCK_ELEMS = 1 << 22  # pairs of one row block
# sklearn's defaults, which the JAX package's call takes
PERPLEXITY, ITERATIONS, EXAGGERATION = 30.0, 1000, 12.0
PERPLEXITY_TOL = 1e-5
SEARCH_STEPS = 100
EPS64 = float(np.finfo(np.float64).eps)
EXPLORATION_ITERS = 250
CHECK_EVERY = 50


def _rows(v: int):
    b = max(1, BLOCK_ELEMS // max(v, 1))
    return [(a, min(v, a + b)) for a in range(0, v, b)]


def squared_distances(X: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``lo:hi`` of the squared euclidean distances of ``X`` (float64
    ``|x|^2 - 2 x.y + |y|^2``, floored at 0, 0 on the diagonal)."""
    n2 = (X * X).sum(1)
    d = n2[lo:hi, None] - 2.0 * (X[lo:hi] @ X.T) + n2[None, :]
    d.clamp_(min=0.0)
    idx = torch.arange(lo, hi, device=X.device)
    d[idx - lo, idx] = 0.0
    return d


def conditional_p(d2: torch.Tensor, rows: torch.Tensor,
                  perplexity: float) -> torch.Tensor:
    """Row-normalised P(j | i) of the float64 squared distances ``d2``
    [b, V] (row k is point ``rows[k]``, whose own entry is 0), each row's
    precision found by sklearn's binary search."""
    b = d2.shape[0]
    dev = d2.device
    beta = torch.ones(b, dtype=torch.float64, device=dev)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    target = math.log(perplexity)
    self_mask = torch.zeros_like(d2, dtype=torch.bool)
    self_mask[torch.arange(b, device=dev), rows] = True
    P = torch.zeros_like(d2)
    for _ in range(SEARCH_STEPS):
        p = torch.exp(-d2 * beta[:, None]).masked_fill_(self_mask, 0.0)
        s = p.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        p /= s[:, None]
        H = torch.log(s) + beta * (d2 * p).sum(1)
        diff = H - target
        P = torch.where(done[:, None], P, p)
        done = done | (diff.abs() <= PERPLEXITY_TOL)
        if bool(done.all()):
            break
        up = (diff > 0) & ~done
        down = (diff <= 0) & ~done
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(down, torch.where(torch.isinf(lo), beta / 2.0,
                                          (beta + lo) / 2.0), beta))
    return P


def joint_probabilities(X: torch.Tensor, perplexity: float = PERPLEXITY
                        ) -> torch.Tensor:
    """The symmetric joint P [V, V] float32 of ``X`` (``_joint_probabilities``
    as a square matrix: its condensed form is the upper triangle; the
    diagonal is 0 and every other entry at least the float64 epsilon)."""
    X = X.to(torch.float64)
    v = X.shape[0]
    P = torch.empty((v, v), dtype=torch.float32, device=X.device)
    for a, b in _rows(v):
        d2 = squared_distances(X, a, b).to(torch.float32).to(torch.float64)
        rows = torch.arange(a, b, device=X.device)
        P[a:b] = conditional_p(d2, rows, perplexity).to(torch.float32)
    P = P + P.T
    P /= max(float(P.sum(dtype=torch.float64)), EPS64)
    P.clamp_(min=EPS64)
    P.fill_diagonal_(0.0)
    return P


def kl_and_grad(Y: torch.Tensor, P: torch.Tensor, exaggeration: float = 1.0,
                p_sum: float | None = None) -> tuple[float, torch.Tensor]:
    """KL(P || Q) and its gradient [V, 2] at the float64 points ``Y``
    (``_kl_divergence`` with 2 components: one degree of freedom), P
    times ``exaggeration``; one pass over row blocks.  ``p_sum`` is P's
    float64 sum, summed here when not given."""
    if p_sum is None:
        p_sum = float(P.sum(dtype=torch.float64))
    v = Y.shape[0]
    n2 = (Y * Y).sum(1)
    Z = torch.zeros((), dtype=torch.float64, device=Y.device)
    plogp = torch.zeros_like(Z)
    plogw = torch.zeros_like(Z)
    attract = torch.empty_like(Y)
    repulse = torch.empty_like(Y)
    for a, b in _rows(v):
        w = n2[a:b, None] - 2.0 * (Y[a:b] @ Y.T) + n2[None, :]
        w = 1.0 / (1.0 + w.clamp_(min=0.0))
        idx = torch.arange(a, b, device=Y.device)
        w[idx - a, idx] = 0.0
        p = P[a:b].to(torch.float64) * exaggeration
        Z += w.sum()
        off = p > 0
        plogp += torch.where(off, p * torch.log(p.clamp(min=EPS64)), 0.0).sum()
        plogw += torch.where(off, p * torch.log(w.clamp(min=1e-300)), 0.0).sum()
        pw = p * w
        attract[a:b] = pw.sum(1, keepdim=True) * Y[a:b] - pw @ Y
        w2 = w * w
        repulse[a:b] = w2.sum(1, keepdim=True) * Y[a:b] - w2 @ Y
    kl = float(plogp - plogw + torch.log(Z) * p_sum * exaggeration)
    return kl, 4.0 * (attract - repulse / Z)


def _descend(Y, P, p_sum, exaggeration, momentum, lr, it, max_iter,
             patience, kls):
    """One stage of sklearn's ``_gradient_descent``; returns the last
    iteration run."""
    update = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    best, best_it = math.inf, it
    i = it
    for i in range(it, max_iter):
        check = (i + 1) % CHECK_EVERY == 0
        kl, grad = kl_and_grad(Y, P, exaggeration, p_sum)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=0.01)
        grad = grad * gains
        update = momentum * update - lr * grad
        Y += update
        if check or i == max_iter - 1:
            kls.append((i + 1, kl))
        if check:
            if kl < best:
                best, best_it = kl, i
            elif i - best_it > patience:
                break
            if float(torch.linalg.vector_norm(grad)) <= 1e-7:
                break
    return i


def pca_init(X: torch.Tensor) -> torch.Tensor:
    """sklearn's ``init="pca"`` of the float64 points ``X`` [V, d]: the
    first two principal components of the centred points, each
    component's largest entry positive (``svd_flip``), as float32 scaled
    to a first-component std of 1e-4; returned as float64 [V, 2]."""
    Xc = X - X.mean(0)
    _, _, vt = torch.linalg.svd(Xc, full_matrices=False)
    vt = vt[:2]
    big = vt.abs().argmax(1)
    vt = vt * torch.sign(vt[torch.arange(2, device=X.device), big])[:, None]
    Y = (Xc @ vt.T).to(torch.float32)
    return (Y / Y[:, 0].std(correction=0) * 1e-4).to(torch.float64)


def tsne(X, device=None, return_kl: bool = False):
    """Exact 2-D t-SNE of ``X`` [V, d] (array or tensor) on ``device``
    (default the card; pass ``"cpu"`` for the CPU) from :func:`pca_init`.
    Returns the points [V, 2] as a float32 numpy array, and with
    ``return_kl`` also the [(iteration, KL)] readings (every 50 iterations
    and each stage's last; the first stage's KL is that of the exaggerated
    P).  Raises ``ValueError`` above :data:`MAX_NODES` rows."""
    dev = torch.device(device or "cuda")
    X = torch.as_tensor(X)
    v = X.shape[0]
    if v > MAX_NODES:
        raise ValueError(
            f"exact t-SNE holds a dense {v} x {v} P; its cap is {MAX_NODES} "
            "points (1.6 GB of float32): project larger graphs by PCA "
            "(method='pca')")
    X = X.to(dev, torch.float64)
    P = joint_probabilities(X)
    p_sum = float(P.sum(dtype=torch.float64))
    Y = pca_init(X)
    lr = max(v / EXAGGERATION / 4.0, 50.0)  # learning_rate="auto"
    kls: list[tuple[int, float]] = []
    it = _descend(Y, P, p_sum, EXAGGERATION, 0.5, lr, 0, EXPLORATION_ITERS,
                  EXPLORATION_ITERS, kls)
    _descend(Y, P, p_sum, 1.0, 0.8, lr, it + 1, ITERATIONS, 300, kls)
    out = Y.to(torch.float32).cpu().numpy()
    return (out, kls) if return_kl else out


def trustworthiness(X, Y, n_neighbors: int = 5, device=None) -> float:
    """sklearn's ``manifold.trustworthiness`` (euclidean): how far the
    ``n_neighbors`` nearest points of each point in ``Y`` lie beyond its
    ``n_neighbors`` nearest in ``X``, by their rank in ``X``; 1 when every
    neighbourhood is kept.  Row blocks, no V x V matrix held."""
    dev = torch.device(device or "cuda")
    X = torch.as_tensor(X).to(dev, torch.float64)
    Y = torch.as_tensor(Y).to(dev, torch.float64)
    n, k = X.shape[0], n_neighbors
    if k >= n / 2:
        raise ValueError(f"n_neighbors ({k}) should be less than n_samples "
                         f"/ 2 ({n / 2})")
    t = 0
    for a, b in _rows(n):
        idx = torch.arange(a, b, device=dev)
        dx = squared_distances(X, a, b)
        dx[idx - a, idx] = math.inf
        dy = squared_distances(Y, a, b)
        dy[idx - a, idx] = math.inf
        nn = dy.topk(k, dim=1, largest=False).indices  # [b, k]
        dj = dx.gather(1, nn)  # their distances in X
        rank = (dx[:, None, :] < dj[:, :, None]).sum(2) + 1  # 1-based
        t += int((rank - k).clamp(min=0).sum())
    return 1.0 - t * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))
