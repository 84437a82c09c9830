"""Evaluation metrics: community NMI and node-classification F1.

Port of ``come_tpu/evaluation/metrics.py`` without sklearn, which the
card's machine does not have.  NMI is mutual information over the
contingency table, normalised by the arithmetic mean of the two entropies
(sklearn's default, which the JAX package calls), in numpy.  F1 follows
the JAX package's protocol (deepwalk's ``scoring``): the same numpy split,
then sklearn's ``LogisticRegression`` objective fitted here by full-batch
L-BFGS in torch, in float64, on any device: the mean log-loss plus
``||W||^2 / (2 C n)`` with C = 1 and the intercept not penalised;
multinomial for one label per node (a single sigmoid for two classes, as
sklearn fits them), one-vs-rest sigmoids for multi-labels with each node's
top k labels predicted, k its number of true labels.  Macro- and micro-F1
are computed as ``sklearn.metrics.f1_score`` computes them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0] / counts.sum()
    return float(-np.sum(p * np.log(p)))


def nmi_score(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """Normalized mutual information with arithmetic normalisation."""
    a = np.asarray(labels_true).ravel()
    b = np.asarray(labels_pred).ravel()
    if a.shape != b.shape:
        raise ValueError(f"label shapes differ: {a.shape} vs {b.shape}")
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    na, nb = ia.max(initial=-1) + 1, ib.max(initial=-1) + 1
    if na == nb and na <= 1:
        return 1.0  # both labelings unsplit (or empty): a perfect match
    cont = np.zeros((na, nb), np.float64)
    np.add.at(cont, (ia, ib), 1.0)
    n = cont.sum()
    pi, pj = cont.sum(1), cont.sum(0)
    if pi.size == 1 or pj.size == 1:
        return 0.0
    nz = cont > 0
    nij = cont[nz]
    outer = np.outer(pi, pj)[nz]
    mi = np.sum((nij / n) * (np.log(nij) - np.log(n) + np.log(n * n / outer)))
    mi = max(float(mi), 0.0)
    if mi == 0.0:
        return 0.0
    return mi / (0.5 * (_entropy(pi) + _entropy(pj)))


def f1_scores(y_true: np.ndarray, y_pred: np.ndarray) -> dict[str, float]:
    """Macro- and micro-F1 as ``sklearn.metrics.f1_score``: per label
    ``2 tp / (n_true + n_pred)`` (0 where both are 0); for [n] labels over
    the labels in either array, for [n, C] 0/1 indicators over all C."""
    yt, yp = np.asarray(y_true), np.asarray(y_pred)
    if yt.shape != yp.shape:
        raise ValueError(f"shapes differ: {yt.shape} vs {yp.shape}")
    if yt.ndim == 1:
        labels = np.union1d(yt, yp)
        it, ip = np.searchsorted(labels, yt), np.searchsorted(labels, yp)
        n = labels.size
        tp = np.bincount(it[it == ip], minlength=n).astype(np.float64)
        n_true = np.bincount(it, minlength=n).astype(np.float64)
        n_pred = np.bincount(ip, minlength=n).astype(np.float64)
    else:
        yt, yp = yt != 0, yp != 0
        tp = (yt & yp).sum(0).astype(np.float64)
        n_true = yt.sum(0).astype(np.float64)
        n_pred = yp.sum(0).astype(np.float64)
    denom = n_true + n_pred
    per = np.divide(2.0 * tp, denom, out=np.zeros_like(tp), where=denom > 0)
    tot = denom.sum()
    return {
        "macro_f1": float(per.mean()) if per.size else 0.0,
        "micro_f1": float(2.0 * tp.sum() / tot) if tot > 0 else 0.0,
    }


# sklearn LogisticRegression's defaults, which the JAX package uses
C_REG = 1.0
MAX_ITER = 1000


def fit_logistic(X: torch.Tensor, Y: torch.Tensor, softmax: bool):
    """sklearn's L2 logistic regression, by full-batch L-BFGS in the dtype
    and on the device of ``X`` [n, d].  ``Y`` [n, m] holds one-hot rows
    (``softmax``: one multinomial model) or 0/1 columns (m independent
    sigmoids, fitted together: their objectives add).  Minimises the mean
    loss + ``||W||^2 / (2 C n)`` (C = ``C_REG``), intercepts not
    penalised.  Returns (W [d, m], b [m])."""
    n, d = X.shape
    W = torch.zeros((d, Y.shape[1]), dtype=X.dtype, device=X.device,
                    requires_grad=True)
    b = torch.zeros(Y.shape[1], dtype=X.dtype, device=X.device,
                    requires_grad=True)
    opt = torch.optim.LBFGS(
        [W, b], lr=1.0, max_iter=MAX_ITER, tolerance_grad=1e-10,
        tolerance_change=1e-14, history_size=20,
        line_search_fn="strong_wolfe",
    )

    def closure():
        opt.zero_grad()
        z = X @ W + b
        if softmax:
            data = -(Y * F.log_softmax(z, 1)).sum()
        else:
            data = F.binary_cross_entropy_with_logits(z, Y, reduction="sum")
        loss = (data + 0.5 / C_REG * (W * W).sum()) / n
        loss.backward()
        return loss

    opt.step(closure)
    return W.detach(), b.detach()


def classify(
    embeddings,
    labels: np.ndarray,
    train_ratio: float = 0.5,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """The F1 protocol's split and predictions (module docstring): returns
    (test node ids, predicted labels of those nodes, [n] or [n, C]).

    ``embeddings``: [V, d] tensor, fitted on its device, or array, fitted
    on the CPU; ``labels``: [V] single-label ints or [V, C] 0/1
    multi-label."""
    X = torch.as_tensor(embeddings).to(torch.float64)
    y = np.asarray(labels)
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    perm = rng.permutation(n)
    n_train = max(int(train_ratio * n), 1)
    tr, te = perm[:n_train], perm[n_train:]
    Xtr = X[torch.as_tensor(tr, device=X.device)]
    Xte = X[torch.as_tensor(te, device=X.device)]

    if y.ndim == 1:
        classes, yi = np.unique(y[tr], return_inverse=True)
        if classes.size < 2:
            raise ValueError("the training split holds a single class")
        if classes.size == 2:
            W, b = fit_logistic(Xtr, _f64(yi[:, None], X.device), False)
            pick = ((Xte @ W + b)[:, 0] > 0).long()
        else:
            onehot = np.eye(classes.size)[yi]
            W, b = fit_logistic(Xtr, _f64(onehot, X.device), True)
            pick = (Xte @ W + b).argmax(1)
        return te, classes[pick.cpu().numpy()]

    ytr = y[tr] != 0
    probs = np.zeros((len(te), y.shape[1]))
    # a label that every training node has, or none has, is predicted
    # with that constant, as sklearn's one-vs-rest does
    const = ytr.all(0) | ~ytr.any(0)
    probs[:, const] = ytr[0, const]
    fit = np.flatnonzero(~const)
    if fit.size:
        W, b = fit_logistic(Xtr, _f64(ytr[:, fit], X.device), False)
        probs[:, fit] = torch.sigmoid(Xte @ W + b).cpu().numpy()
    k = y[te].sum(axis=1).astype(int)  # true label count per node
    pred = np.zeros_like(y[te])
    for i in range(len(te)):
        if k[i] > 0:
            pred[i, np.argsort(probs[i])[-k[i]:]] = 1
    return te, pred


def node_classification_f1(
    embeddings,
    labels: np.ndarray,
    train_ratio: float = 0.5,
    seed: int = 0,
) -> dict[str, float]:
    """Logistic-regression macro/micro-F1 on the test split of
    :func:`classify`."""
    te, pred = classify(embeddings, labels, train_ratio, seed)
    return f1_scores(np.asarray(labels)[te], pred)


def _f64(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def f1_train_ratio_sweep(
    embeddings,
    labels: np.ndarray,
    ratios=(0.1, 0.3, 0.5, 0.7, 0.9),
    seed: int = 0,
) -> dict[float, dict[str, float]]:
    """The deepwalk/ComE-paper protocol: F1 at several labelled fractions."""
    return {
        r: node_classification_f1(embeddings, labels, train_ratio=r,
                                  seed=seed)
        for r in ratios
    }
