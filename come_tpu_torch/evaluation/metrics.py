"""Evaluation metrics: community NMI.

Port of ``come_tpu/evaluation/metrics.py::nmi_score``, written in numpy so
the port needs no sklearn: mutual information over the contingency table,
normalised by the arithmetic mean of the two entropies (sklearn's default,
which the JAX package calls).  Node-classification F1 waits for a
classifier that runs without sklearn (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np


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
